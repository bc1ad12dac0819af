// pallas_session: the whole batched converge session on Hopper (sm_90a), one
// persistent cooperative launch per chunk.
//
// Replaces kafkabalancer_tpu/solvers/pallas_session.py:_kernel, the Pallas
// TPU kernel behind pallas_session. One launch runs what the torch session
// (solvers/scan.py) runs as a host loop: per iteration it scores every
// target broker and every hot/cold pair column (score::score_rows, the
// block body of the scoring kernel shard_score.cu),
// pools the winners into K = B + B/2 candidates, accepts a gain-ordered
// prefix with exact sequential deltas and the churn gate, commits the
// accepted moves to the loads, the broker counts, the replicas, the
// membership bytes and the move log, and loops until an iteration accepts
// nothing or the budget is spent.
// The host reads the move log once, at the end. Bit-exact against the plain
// torch version (solvers/pallas_session.py:pallas_session_plain) at float32.
//
// What bounds it on an H100: an iteration moves the bytes of one scoring
// pass (the [P, B] member mask and the row columns, ~38 MB at 131072 x 256)
// plus the commit's few bytes, so bytes bound it: iterations x ~11 us at
// 3.35 TB/s there. In practice an iteration is a chain of latencies: the
// scoring pass's instruction rate (see shard_score.cu), then, on one block
// while the others wait, the fold, the pool, the acceptance and the commit.
//
// Ranks and claims by counting, the 4-blocks-per-SM register bound and the
// table's choice between counting and sorting were each measured against
// their alternative in one call (scripts/kernel_ab.py, PERF.md).
//
// The split this design was drawn from (block 0's clock64 stamps on the
// first design, H100 at 700 W, PERF.md): at the 10k x 100 first chunk an
// iteration took ~191k cycles (96 us), 26 % of it the table and the scoring
// pass with its barrier, 63 % the acceptance on one block; at 131072 x 256
// ~667k cycles (337 us), 41 % and 54 %. That design ran the acceptance as
// one thread per candidate looping over all K candidates in four separate
// passes, and reduced on one thread.
//
// Design:
// - Cooperative launch (its co-residency guarantee is what makes spinning
//   safe), grid = co-resident blocks (occupancy x SMs; registers are
//   bounded so that four blocks fit an SM), each scoring a contiguous chunk
//   of rows (score::split_rows), at most as many blocks as chunks. Each
//   iteration a block's target minima stay in registers across its tiles
//   and its keys go to the device keys once. Session state lives in device memory
//   the wrapper allocates (working copies of loads, broker counts,
//   replicas and member bytes; the log; n, iterations and a done flag);
//   every block reads it with L1-bypassing loads.
// - One-way barriers: after scoring every block arrives on a device counter
//   (release); block 0 alone waits for all of this iteration's arrivals
//   (acquire), folds, accepts and commits, then publishes the iteration as
//   an epoch (release) that the other blocks wait on (acquire). Nobody
//   waits for anybody twice.
// - Each iteration every block rebuilds the broker table in its own shared
//   memory: validity from the broker counts, the broker count nb by
//   __syncthreads_count, avg and the penalty sum su in ops/cost.py:
//   ordered_sum's order with one lane per block of 32 (a chain of 32 +
//   B/32 adds, not B), (load, id) ranks by counting (B <= 128) or by a
//   bitonic sort of packed (load, id) keys, the hot/cold pair frame and
//   its chain. Every block computes the same bits from the same
//   state, so no barrier is spent on it.
// - Scoring offers to kKeyCopies key arrays through 64-bit atomicMin, as in
//   shard_score.cu. Block 0 folds the copies column by column (consecutive
//   threads, consecutive columns of one copy; all copies' loads in flight
//   before the resets behind them), recovers the follower slots and
//   finishes the pair winners with one thread per column.
// - The acceptance works in rank order instead of a pairwise "earlier"
//   test: the improving candidates (only those) are packed as (value bits
//   << 32 | k), whose unsigned order is scan.prefix_accept's (value,
//   index) order, and ranked by counting the smaller keys. A candidate
//   survives the partition claims when no candidate ranked before it has
//   its partition. A bitonic sort on (broker, candidate) gives every
//   broker the list of surviving candidates that touch it, in ascending
//   candidate order; each survivor's net prefix sums walk only the lists
//   of its two brokers and add the terms of the survivors ranked before it
//   into ordered_sum's blocks of 32 (levels of it, see net_sum). The cut
//   is the block minimum rank of a failing survivor, the cap a block scan
//   over the survivors in rank order, and the commit walks the same lists:
//   loads + sum(targets) - sum(sources), each sum in ascending candidate
//   order, as the TPU kernel does (not the torch session's
//   sources-then-targets scatter). No [K, K] matrix is stored.
// - The kernel is specialised on the allowed mask, the leader pass and the
//   scoring pass's targets per thread (2 up to B = 128, 4 above).
// Not carried over from the TPU kernel (Mosaic and VMEM workarounds): the
// transposed [R, P] layout, integers held in float32, one-hot MXU gathers
// and placements, pairwise [K, K] masks, the TILE_P alignment of P and the
// VMEM capacity gate. State is in device memory, so the only limits are
// block 0's shared memory (B <= kMaxB) and the tile's.
//
// Exactness: as shard_score.cu (--fmad=false, the IEEE quotient, -0.0 packs
// as +0.0, a NaN candidate never wins, an empty column is (+inf, row 0)), and
// every reduction in the order of the plain version. Skipping a zero term
// of an ordered sum changes no bit (every accumulator starts at +0.0, and
// x + +-0.0 == x for x != 0, +0.0 + -0.0 == +0.0); a non-finite applied
// delta makes the plain version's zero terms NaN, which net_sum
// reproduces by counting them.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using score::kEmpty;
using score::kKeyCopies;
using score::kThreads;
using score::kWarps;

constexpr int kMaxB = 1024;  // broker bucket the acceptance block takes
// target brokers per thread in the scoring pass's target pass: 2 up to
// this broker bucket, 4 above
constexpr int kTgt2MaxB = 128;
// the broker table ranks up to this many brokers by counting, more by a
// bitonic sort (counting measured faster at B = 128, the sort at B = 256)
constexpr int kCountRankMaxB = 128;
// blocks per SM the register allocation must allow: four co-resident
// blocks scored faster than three with fewer spills (PERF.md)
constexpr int kMinBlocks = 4;
// Phase stamps per iteration: table built | block 0's own scoring done |
// the scoring barrier passed | fold + pool done | acceptance done | commit
// done | the next iteration released.
constexpr int kPhases = 7;
// 64-bit words after the key arrays: the arrival counter and, a 128-byte
// line apart, the epoch
constexpr int kSyncWords = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRank = 0x7fffffff;

using Counter = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

struct Sess {
  score::Rows rows;          // replicas and member: the working copies
  int32_t* replicas;         // [P, R], == rows.replicas
  uint8_t* member;           // [P, B], == rows.member
  float* loads;              // [B]
  int32_t* bcount;           // [B] replicas held per broker
  const uint8_t* always;     // [B] configured brokers (always in the table)
  const uint8_t* universe;   // [B] real (unpadded) brokers
  unsigned long long* keys;  // kKeyCopies key arrays, all-ones at launch
  unsigned long long* arrive;  // scoring passes finished, zero at launch
  unsigned long long* epoch;   // iterations committed, zero at launch
  int32_t* log;              // [4, max_moves]: p | slot | src | tgt
  int32_t* counts;           // [3]: n | iterations | done
  long long* stamps;         // [iterations, kPhases] clock64 or null
  float minrep, min_unb, churn;
  int K, chunk, tile, budget, batch, max_moves;
};

// Block 0's thread 0 records clock64() at the end of phase `ph` of
// iteration `it`, when the caller asked for stamps.
__device__ __forceinline__ void stamp(const Sess& s, int it, int ph) {
  if (s.stamps && blockIdx.x == 0 && threadIdx.x == 0) {
    s.stamps[(size_t)it * kPhases + ph] = clock64();
  }
}

struct Scalars {
  float avg, su, best_gain;
  int n, done, cnt;
  int nimp;        // improving candidates
  int nent;        // broker-list entries
  int first_fail;  // lowest rank of a survivor whose delta fails
  int nonfinite;   // candidates with a non-finite applied delta
  float wmin[kWarps];
  int wflag[kWarps];
  int wsum[kWarps];
};

__host__ __device__ __forceinline__ int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The dynamic shared memory: the broker table, then a work area that holds
// the scoring pass's keys and staged masks (score::work_bytes) while
// scoring and the candidate pool while block 0 accepts.
struct Layout {
  float* loads;      // [B]
  float* F;          // [B]
  int32_t* head;     // [B]
  int32_t* perm;     // [B] broker at each (load, id) rank
  int32_t* next;     // [B2]
  int32_t* t;        // [B2] cold broker per pair column
  int32_t* s;        // [B2] hot broker per pair column
  uint8_t* bvalid;   // [B]
  uint8_t* live;     // [B2]
  uint8_t* work;
  // the pool, in the work area
  unsigned long long* keys;  // [pow2ceil(K)] sort keys; also
  uint32_t* ent;             // [2 pow2ceil(K)] the broker-list entries
  float* c_vals;     // [K] absolute (su-based) scores
  int32_t* c_p;      // [K]
  int32_t* c_slot;   // [K]
  int32_t* c_s;      // [K]
  int32_t* c_t;      // [K]
  float* c_w;        // [K] applied load delta
  int32_t* c_pos;    // [K] move-log position
  int32_t* c_rank;   // [K] rank among the improving, kNoRank if not
  int32_t* c_ord;    // [K] candidate at each rank
  int32_t* lstart;   // [B] each broker's list: ent[lstart, lend)
  int32_t* lend;     // [B]
  uint8_t* c_surv;   // [K] survives the partition claims
  uint8_t* c_ok;     // [K] passes its delta, then accepted
};

__host__ __device__ __forceinline__ int table_bytes(int B, int B2) {
  return score::round16(17 * B + 13 * B2);
}

__host__ __device__ __forceinline__ int pool_bytes(int K, int B) {
  return 8 * pow2ceil(K) + score::round16(38 * K + 8 * B);
}

__device__ Layout layout(uint8_t* base, int B, int B2, int K) {
  Layout l;
  l.loads = reinterpret_cast<float*>(base);
  l.F = l.loads + B;
  l.head = reinterpret_cast<int32_t*>(l.F + B);
  l.perm = l.head + B;
  l.next = l.perm + B;
  l.t = l.next + B2;
  l.s = l.t + B2;
  l.bvalid = reinterpret_cast<uint8_t*>(l.s + B2);
  l.live = l.bvalid + B;
  l.work = base + table_bytes(B, B2);
  l.keys = reinterpret_cast<unsigned long long*>(l.work);
  l.ent = reinterpret_cast<uint32_t*>(l.work);
  l.c_vals = reinterpret_cast<float*>(l.keys + pow2ceil(K));
  l.c_p = reinterpret_cast<int32_t*>(l.c_vals + K);
  l.c_slot = l.c_p + K;
  l.c_s = l.c_slot + K;
  l.c_t = l.c_s + K;
  l.c_w = reinterpret_cast<float*>(l.c_t + K);
  l.c_pos = reinterpret_cast<int32_t*>(l.c_w + K);
  l.c_rank = l.c_pos + K;
  l.c_ord = l.c_rank + K;
  l.lstart = l.c_ord + K;
  l.lend = l.lstart + B;
  l.c_surv = reinterpret_cast<uint8_t*>(l.lend + B);
  l.c_ok = l.c_surv + K;
  return l;
}

// ops/cost.py:ordered_sum over x(0), ..., x(n-1), n <= 32 * 32, by warp 0:
// up to 32 terms left to right from zero; a longer axis is cut into blocks
// of 32 after a symmetric zero pad (the low side gets the smaller half),
// lane i sums block i left to right, and lane 0 adds the block sums left to
// right. The pad's zeros are skipped: adding +0.0 to a sum that started at
// +0.0 changes no bit. The result is lane 0's.
template <class Fn>
__device__ float warp_ordered_sum(Fn x, int n) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  if (n <= 32) {
    if (lane == 0) {
      for (int i = 0; i < n; ++i) acc = acc + x(i);
    }
    return acc;
  }
  const int nblk = (n + 31) / 32;
  const int lo = (nblk * 32 - n) / 2;
  if (lane < nblk) {
    for (int m = 0; m < 32; ++m) {
      const int i = lane * 32 + m - lo;
      if (i >= 0 && i < n) acc = acc + x(i);
    }
  }
  float tot = 0.0f;
  for (int b = 0; b < nblk; ++b) tot = tot + __shfl_sync(kFull, acc, b);
  return tot;
}

// Ascending bitonic sort of a[0, n), n a power of two, by the whole block;
// a barrier must precede it (the writes of a), and one follows every step.
template <class T>
__device__ void bitonic_sort(T* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const T x = a[lo], y = a[hi];
        if ((x > y) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The broker table of this iteration (cost.py: the table, avg, F, su,
// rank_brokers and pair_frame), computed by every block from the state.
__device__ void build_table(const Sess& s, const Layout& l, Scalars& sc) {
  const int B = s.rows.B, B2 = s.rows.B2;
  int nb = 0;
  for (int b0 = 0; b0 < B; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    bool valid = false;
    if (b < B) {
      const int c = __ldcg(s.bcount + b);
      l.loads[b] = __ldcg(s.loads + b);
      valid = (s.always[b] || c > 0) && s.universe[b];
      l.bvalid[b] = valid;
      l.head[b] = -1;
    }
    nb += __syncthreads_count(valid);  // also the barrier behind the writes
  }
  if (threadIdx.x < 32) {
    const float sum = warp_ordered_sum(
        [&](int b) { return l.bvalid[b] ? l.loads[b] : 0.0f; }, B);
    if (threadIdx.x == 0) sc.avg = sum / static_cast<float>(nb);
  }
  __syncthreads();
  const float avg = sc.avg;
  if (B > kCountRankMaxB) {
    // ascending (load, id) order of the packed keys; invalid brokers sort
    // last as +inf. The work area is free while the table is built.
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(l.work);
    const int Bp = pow2ceil(B);
    for (int b = threadIdx.x; b < Bp; b += kThreads) {
      if (b < B) {
        keys[b] = score::pack(l.bvalid[b] ? l.loads[b] : INFINITY, b);
        l.F[b] = l.bvalid[b] ? score::penalty(l.loads[b], avg) : 0.0f;
      } else {
        keys[b] = kEmpty;
      }
    }
    __syncthreads();
    bitonic_sort(keys, Bp);
    for (int i = threadIdx.x; i < B; i += kThreads) {
      l.perm[i] = static_cast<int>(keys[i] & 0xffffffffu);
    }
  } else {
    for (int b = threadIdx.x; b < B; b += kThreads) {
      const float key = l.bvalid[b] ? l.loads[b] : INFINITY;
      l.F[b] = l.bvalid[b] ? score::penalty(l.loads[b], avg) : 0.0f;
      // ascending (load, id) rank; invalid brokers sort last as +inf
      int rank = 0;
      for (int j = 0; j < B; ++j) {
        const float kj = l.bvalid[j] ? l.loads[j] : INFINITY;
        rank += (kj < key) || (kj == key && j < b);
      }
      l.perm[rank] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const float su = warp_ordered_sum([&](int b) { return l.F[b]; }, B);
    if (threadIdx.x == 0) sc.su = su;
  }
  const int npair = nb / 2;
  for (int c = threadIdx.x; c < B2; c += kThreads) {
    const bool live = c < npair;
    l.live[c] = live;
    l.s[c] = live ? l.perm[nb - 1 - c] : 0;
    l.t[c] = live ? l.perm[c] : 0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < B2; c += kThreads) {
    if (l.live[c]) l.next[c] = atomicExch(&l.head[l.s[c]], c);
  }
  __syncthreads();
}

// The minimum of key column j over the copies, which are reset to empty
// behind the reads. Consecutive threads take consecutive columns of one
// copy; every copy's load is in flight before the first reset.
__device__ __forceinline__ unsigned long long fold(const Sess& s, int ncol,
                                                   int j) {
  unsigned long long* a = s.keys + j;
  unsigned long long v[kKeyCopies];
#pragma unroll
  for (int c = 0; c < kKeyCopies; ++c) v[c] = __ldcg(a + (size_t)c * ncol);
#pragma unroll
  for (int c = 0; c < kKeyCopies; ++c) __stcg(a + (size_t)c * ncol, kEmpty);
  unsigned long long k = v[0];
#pragma unroll
  for (int c = 1; c < kKeyCopies; ++c) k = min(k, v[c]);
  return k;
}

// the applied load delta of moving slot `slot` of row p: the leader
// premium travels with slot 0 (utils.go:96-101)
__device__ __forceinline__ float applied_delta(const Sess& s, int p,
                                               int slot) {
  const float* c = s.rows.cols + (size_t)p * 5;
  return slot == 0 ? c[0] * (c[1] + c[3]) : c[0];
}

// Exclusive prefix sums of flag(0..n-1) by the whole block: each thread
// takes a run of consecutive i and calls emit(i, sum of flag(j) over
// j < i). `wsum` is kWarps ints of shared memory; a barrier must follow
// before it is used again.
template <class Flag, class Emit>
__device__ void block_scan(int n, Flag flag, Emit emit, int* wsum) {
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(n, threadIdx.x * per), i1 = min(n, i0 + per);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += flag(i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int run = incl - mine;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int i = i0; i < i1; ++i) {
    emit(i, run);
    run += flag(i);
  }
}

// ordered_sum's levels over the K candidates: depth 0 adds up to 32 terms
// left to right; depth 1 pads K symmetrically to blocks of 32 (lo1 zeros
// before candidate 0) and adds the block sums left to right; depth 2 does
// the same once more over the block sums (lo2), for K > 32 * 32.
struct Levels {
  int depth, lo1, lo2;
};

__device__ __forceinline__ Levels levels(int K) {
  Levels lv{0, 0, 0};
  if (K <= 32) return lv;
  const int nblk = (K + 31) / 32;
  lv.depth = 1;
  lv.lo1 = (nblk * 32 - K) / 2;
  if (nblk > 32) {
    const int nblk2 = (nblk + 31) / 32;
    lv.depth = 2;
    lv.lo2 = (nblk2 * 32 - nblk) / 2;
  }
  return lv;
}

// A broker-list entry: (broker << 12 | candidate << 1 | is_target); B <=
// 1024 and K <= 1536 fit, and the unsigned order is (broker, candidate).
__device__ __forceinline__ uint32_t entry(int x, int j, int is_tgt) {
  return (static_cast<uint32_t>(x) << 12) | (static_cast<uint32_t>(j) << 1) |
         static_cast<uint32_t>(is_tgt);
}

// The net prefix sum of candidate k (rank rk) at broker x, scan.py:151-160:
// ordered_sum over j = 0..K-1 of (E[j, k] * surv[j] * w[j]) * ((t[j] == x)
// - (s[j] == x)). Walks x's list (the survivors touching x, ascending j)
// and adds the terms of the survivors ranked before k, +-w[j], into the
// accumulator of their block of 32 at each level; a block is closed into
// the next level when the walk leaves it. Every other term is zero, and
// skipping it changes no bit, unless its w[j] is not finite: then the
// plain version's term is NaN, so the sum is NaN whenever fewer of the
// `nonfinite` candidates were added than exist.
__device__ float net_sum(const Layout& l, const Levels& lv, int x, int rk,
                         int nonfinite) {
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  int cur1 = -1, cur2 = -1, added_nf = 0;
  auto close1 = [&](float bs, int q1) {
    if (lv.depth == 1) {
      acc1 = acc1 + bs;
      return;
    }
    const int q2 = (q1 + lv.lo2) >> 5;
    if (q2 != cur2) {
      if (cur2 >= 0) acc2 = acc2 + acc1;
      acc1 = 0.0f;
      cur2 = q2;
    }
    acc1 = acc1 + bs;
  };
  const int e1 = l.lend[x];
  for (int i = l.lstart[x]; i < e1; ++i) {
    const uint32_t e = l.ent[i];
    const int j = (e >> 1) & 0x7ff;
    if (l.c_rank[j] >= rk || l.c_s[j] == l.c_t[j]) continue;
    const float w = l.c_w[j];
    added_nf += !isfinite(w);
    const float v = (e & 1) ? w : w * -1.0f;
    if (lv.depth == 0) {
      acc0 = acc0 + v;
      continue;
    }
    const int q1 = (j + lv.lo1) >> 5;
    if (q1 != cur1) {
      if (cur1 >= 0) close1(acc0, cur1);
      acc0 = 0.0f;
      cur1 = q1;
    }
    acc0 = acc0 + v;
  }
  float sum = acc0;
  if (lv.depth >= 1) {
    if (cur1 >= 0) close1(acc0, cur1);
    sum = acc1;
    if (lv.depth == 2) {
      if (cur2 >= 0) acc2 = acc2 + acc1;
      sum = acc2;
    }
  }
  return added_nf < nonfinite ? NAN : sum;
}

// Block 0, after the scoring barrier: the pool (scan.batch_pool), the
// acceptance (scan.prefix_accept) and the commit.
template <bool kLead>
__device__ void accept_commit(const Sess& s, const Layout& l, Scalars& sc,
                              int n, int it) {
  const int B = s.rows.B, B2 = s.rows.B2, R = s.rows.R, P = s.rows.P;
  const int K = s.K;
  const int ncol = score::key_columns(B, B2);
  const float avg = sc.avg, su = sc.su, mu = s.min_unb;
  const float inf = INFINITY;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // ---- the pool: per-target winners, then the pair winners --------------
  for (int b = threadIdx.x; b < B; b += kThreads) {
    float vf, vl = inf;
    int32_t pf, pl = 0;
    score::unpack(fold(s, ncol, b), vf, pf);
    if (kLead) score::unpack(fold(s, ncol, B + b), vl, pl);
    // follower slot recovery for the winner row: the lowest slot of the
    // minimum source term (torch argmin: the first NaN, else the first
    // minimum)
    int slot = 0;
    if (P > 0) {
      const float w = s.rows.cols[(size_t)pf * 5];
      const float ncur = s.rows.cols[(size_t)pf * 5 + 1];
      float best = inf;
      for (int r = 0; r < R; ++r) {
        float v = inf;
        if (r >= 1 && static_cast<float>(r) < ncur) {
          const int sb = max(0, __ldcg(s.replicas + (size_t)pf * R + r));
          v = score::penalty(l.loads[sb] - w, avg) - l.F[sb];
        }
        if (r == 0) {
          best = v;
        } else if (!isnan(best) && (isnan(v) || v < best)) {
          best = v;
          slot = r;
        }
      }
    }
    float v = vf;
    int p = pf;
    if (kLead && vl < vf) {  // strict: the follower wins ties
      v = vl;
      p = pl;
      slot = 0;
    }
    l.c_vals[b] = su + v;
    l.c_p[b] = p;
    l.c_slot[b] = slot;
    l.c_s[b] = P > 0 ? __ldcg(s.replicas + (size_t)p * R + slot) : 0;
    l.c_t[b] = b;
    l.c_w[b] = P > 0 ? applied_delta(s, p, slot) : 0.0f;
    l.lstart[b] = 0;
    l.lend[b] = 0;
  }
  for (int c = threadIdx.x; c < B2; c += kThreads) {
    float vf, vl = inf;
    int32_t pf, pl = 0;
    score::unpack(fold(s, ncol, 2 * B + c), vf, pf);
    if (kLead) score::unpack(fold(s, ncol, 2 * B + B2 + c), vl, pl);
    // cost.pair_finish: the follower slot holding the hot broker (the
    // first, else 0)
    int slot = 0;
    if (P > 0) {
      const float ncur = s.rows.cols[(size_t)pf * 5 + 1];
      for (int r = 1; r < R && static_cast<float>(r) < ncur; ++r) {
        if (__ldcg(s.replicas + (size_t)pf * R + r) == l.s[c]) {
          slot = r;
          break;
        }
      }
    }
    float v = vf;
    int p = pf;
    if (kLead && vl < vf) {
      v = vl;
      p = pl;
      slot = 0;
    }
    const int k = B + c;
    l.c_vals[k] = su + (l.live[c] ? v : inf);
    l.c_p[k] = p;
    l.c_slot[k] = slot;
    l.c_s[k] = l.s[c];
    l.c_t[k] = l.t[c];
    l.c_w[k] = P > 0 ? applied_delta(s, p, slot) : 0.0f;
  }
  if (threadIdx.x == 0) {
    sc.cnt = 0;
    sc.nimp = 0;
    sc.nent = 0;
    sc.first_fail = kNoRank;
  }
  __syncthreads();
  stamp(s, it, 3);

  // ---- scan.prefix_accept ------------------------------------------------
  // best_gain: torch amin, NaN if any; and the non-finite applied deltas
  {
    float m = inf;
    int nan = 0, nf = 0;
    for (int k = threadIdx.x; k < K; k += kThreads) {
      const float v = l.c_vals[k];
      if (isnan(v)) nan = 1;
      else if (v < m) m = v;
      nf += !isfinite(l.c_w[k]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, m, off);
      m = o < m ? o : m;
      nan |= __shfl_xor_sync(kFull, nan, off);
      nf += __shfl_xor_sync(kFull, nf, off);
    }
    if (lane == 0) {
      sc.wmin[warp] = m;
      sc.wflag[warp] = nan;
      sc.wsum[warp] = nf;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float mm = inf;
      int any_nan = 0, nonfinite = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (sc.wmin[w] < mm) mm = sc.wmin[w];
        any_nan |= sc.wflag[w];
        nonfinite += sc.wsum[w];
      }
      sc.best_gain = any_nan ? NAN : su - mm;
      sc.nonfinite = nonfinite;
    }
    __syncthreads();
  }
  const float best_gain = sc.best_gain;
  const float su_mu = su - mu;
  // the improving candidates, packed in (value, index) order
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = l.c_vals[k];
    const bool imp = isfinite(v) && v < su_mu && v < su &&
                     (su - v) * s.churn >= best_gain;
    if (imp) l.keys[atomicAdd(&sc.nimp, 1)] = score::pack(v, k);
    l.c_rank[k] = kNoRank;
    l.c_surv[k] = 0;
    l.c_ok[k] = 0;
  }
  __syncthreads();
  const int M = sc.nimp;
  // ranks by counting the smaller keys (measured faster than a sort: M is
  // small, and a sort pays a barrier per step)
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const unsigned long long key = l.keys[i];
    int r = 0;
    for (int j = 0; j < M; ++j) r += l.keys[j] < key;
    const int k = static_cast<int>(key & 0xffffffffu);
    l.c_rank[k] = r;
    l.c_ord[r] = k;
  }
  __syncthreads();
  // partition claims: the lowest-ranked improving candidate of each
  // partition survives (the partitions in rank order, then a scan of the
  // ranks before; measured faster than a sort on (partition, rank))
  for (int i = threadIdx.x; i < M; i += kThreads) {
    l.ent[i] = static_cast<uint32_t>(l.c_p[l.c_ord[i]]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const uint32_t pi = l.ent[i];
    bool surv = true;
    for (int j = 0; j < i && surv; ++j) surv = l.ent[j] != pi;
    l.c_surv[l.c_ord[i]] = surv;
  }
  __syncthreads();
  // every broker's list of the survivors that touch it
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const int k = l.c_ord[i];
    if (!l.c_surv[k]) continue;
    const int sk = l.c_s[k], tk = l.c_t[k];
    const bool s_in = sk >= 0 && sk < B, t_in = tk >= 0 && tk < B;
    const int at = atomicAdd(&sc.nent, (int)s_in + (int)t_in);
    if (s_in) l.ent[at] = entry(sk, k, 0);
    if (t_in) l.ent[at + s_in] = entry(tk, k, 1);
  }
  __syncthreads();
  const int E = sc.nent;
  const int Ep = pow2ceil(E);
  for (int i = E + threadIdx.x; i < Ep; i += kThreads) l.ent[i] = 0xffffffffu;
  __syncthreads();
  bitonic_sort(l.ent, Ep);
  for (int i = threadIdx.x; i < E; i += kThreads) {
    const int x = l.ent[i] >> 12;
    if (i == 0 || (l.ent[i - 1] >> 12) != static_cast<uint32_t>(x)) {
      l.lstart[x] = i;
    }
    if (i == E - 1 || (l.ent[i + 1] >> 12) != static_cast<uint32_t>(x)) {
      l.lend[x] = i + 1;
    }
  }
  __syncthreads();
  // each survivor's exact sequential delta from the per-broker net prefix
  // sums over the survivors ranked before it
  const Levels lv = levels(K);
  const int nonfinite = sc.nonfinite;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const int k = l.c_ord[i];
    if (!l.c_surv[k]) continue;
    const int sk = l.c_s[k], tk = l.c_t[k];
    const float wk = l.c_w[k];
    const bool s_in = sk >= 0 && sk < B, t_in = tk >= 0 && tk < B;
    const float Ls = (s_in ? l.loads[sk] : 0.0f) +
                     (s_in ? net_sum(l, lv, sk, i, nonfinite)
                           : (nonfinite ? NAN : 0.0f));
    const float Lt = (t_in ? l.loads[tk] : 0.0f) +
                     (t_in ? net_sum(l, lv, tk, i, nonfinite)
                           : (nonfinite ? NAN : 0.0f));
    const float d = score::penalty(Ls - wk, avg) - score::penalty(Ls, avg) +
                    score::penalty(Lt + wk, avg) - score::penalty(Lt, avg);
    const bool ok = d < -mu && d < 0.0f;
    l.c_ok[k] = ok;
    if (!ok) atomicMin(&sc.first_fail, i);
  }
  __syncthreads();
  // the cut at the first survivor whose delta fails, then the cap at the
  // batch width, the budget and the log, best-first: every survivor
  // ranked before the cut passed, so a kept candidate's log position is n
  // plus the survivors ranked before it
  const int first_fail = sc.first_fail;
  int mine = 0;
  block_scan(
      M, [&](int i) { return static_cast<int>(l.c_surv[l.c_ord[i]]); },
      [&](int i, int before) {
        const int k = l.c_ord[i];
        if (!l.c_ok[k]) return;
        const int pos = n + before;
        const bool ok = i < first_fail && pos < n + s.batch &&
                        pos < s.budget && pos < s.max_moves;
        l.c_ok[k] = ok;
        l.c_pos[k] = pos;
        mine += ok;
      },
      sc.wsum);
  if (mine) atomicAdd(&sc.cnt, mine);
  __syncthreads();
  stamp(s, it, 4);

  // ---- commit --------------------------------------------------------------
  const int ml = s.max_moves;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const int k = l.c_ord[i];
    if (!l.c_ok[k]) continue;
    // accepted candidates hold distinct partitions: one writer per row
    const int p = l.c_p[k], slot = l.c_slot[k], sb = l.c_s[k], tb = l.c_t[k];
    const int pos = l.c_pos[k];
    s.replicas[(size_t)p * R + slot] = tb;
    s.member[(size_t)p * B + sb] = 0;
    s.member[(size_t)p * B + tb] = 1;
    s.log[pos] = p;
    s.log[ml + pos] = slot;
    s.log[2 * ml + pos] = sb;
    s.log[3 * ml + pos] = tb;
  }
  for (int b = threadIdx.x; b < B; b += kThreads) {
    // loads + sum(target deltas) - sum(source deltas), each sum in
    // ascending candidate order, over the broker's list
    float to = 0.0f, from = 0.0f;
    int dc = 0;
    const int e1 = l.lend[b];
    for (int i = l.lstart[b]; i < e1; ++i) {
      const uint32_t e = l.ent[i];
      const int j = (e >> 1) & 0x7ff;
      if (!l.c_ok[j]) continue;
      if (e & 1) {
        to = to + l.c_w[j];
        ++dc;
      } else {
        from = from + l.c_w[j];
        --dc;
      }
    }
    s.loads[b] = (l.loads[b] + to) - from;
    if (dc) s.bcount[b] = __ldcg(s.bcount + b) + dc;
  }
  if (threadIdx.x == 0) {
    s.counts[0] = n + sc.cnt;
    s.counts[1] += 1;
    s.counts[2] = sc.cnt == 0;
  }
  if (s.stamps) __syncthreads();
  stamp(s, it, 5);
}

template <bool kAlw, bool kLead, int kTgt>
__global__ void __launch_bounds__(kThreads, kMinBlocks) session_kernel(Sess s) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ score::TileShared ts;
  __shared__ Scalars sc;

  // a local copy: a reference to the kernel parameter would move it to
  // local memory
  const score::Rows rows = s.rows;
  const int B = rows.B, B2 = rows.B2;
  const Layout l = layout(s_dyn, B, B2, s.K);
  unsigned long long* const keys =
      s.keys + (blockIdx.x % kKeyCopies) * score::key_columns(B, B2);
  const int r0 = blockIdx.x * s.chunk;
  const int r1 = min(rows.P, r0 + s.chunk);
  Counter arrive(*s.arrive), epoch(*s.epoch);

  for (int it = 0;; ++it) {
    if (threadIdx.x == 0) {
      sc.n = __ldcg(s.counts);
      sc.done = __ldcg(s.counts + 2);
    }
    __syncthreads();
    const int n = sc.n;
    // every block reads the same state, so all leave together
    if (sc.done || n >= s.budget || n >= s.max_moves) break;
    build_table(s, l, sc);
    stamp(s, it, 0);
    const score::Table tb{l.loads, l.F, l.bvalid, l.head, l.next, l.t,
                          sc.avg, s.minrep, 0.0f};
    score::score_rows<kAlw, false, kLead, true, kTgt>(rows, tb, ts, l.work,
                                                      s.tile, r0, r1, keys);
    __syncthreads();  // the offers, before the release and the work area's reuse
    stamp(s, it, 1);
    // this block's offers are done (the barrier above orders them before
    // thread 0's release)
    if (threadIdx.x == 0) arrive.fetch_add(1, cuda::memory_order_release);
    if (blockIdx.x == 0) {
      if (threadIdx.x == 0) {
        const unsigned long long all =
            static_cast<unsigned long long>(gridDim.x) * (it + 1);
        while (arrive.load(cuda::memory_order_acquire) < all) {
        }
      }
      __syncthreads();
      stamp(s, it, 2);
      accept_commit<kLead>(s, l, sc, n, it);
      __syncthreads();
      if (threadIdx.x == 0) {
        epoch.store(static_cast<unsigned long long>(it + 1),
                    cuda::memory_order_release);
      }
    } else {
      if (threadIdx.x == 0) {
        while (epoch.load(cuda::memory_order_acquire) <
               static_cast<unsigned long long>(it + 1)) {
        }
      }
      __syncthreads();
    }
    stamp(s, it, 6);
  }
}

int dyn_smem_bytes(int tile, int B, int B2, int R, int K, bool has_allowed) {
  return table_bytes(B, B2) +
         std::max(score::work_bytes(tile, B, R, has_allowed),
                  pool_bytes(K, B));
}

template <bool kAlw, bool kLead, int kTgt>
cudaError_t launch(Sess s, int n_sm, cudaStream_t st) {
  auto kernel = session_kernel<kAlw, kLead, kTgt>;
  const int B = s.rows.B, B2 = s.rows.B2;
  const int max_rows = score::max_tile(B, s.rows.R, kAlw);
  const int smem = dyn_smem_bytes(max_rows, B, B2, s.rows.R, s.K, kAlw);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const score::Split sp = score::split_rows(s.rows.P, per_sm * n_sm, max_rows);
  s.chunk = sp.chunk;
  s.tile = sp.tile;
  const int grid = sp.blocks;
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kThreads), args,
                                    static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(Sess, int, cudaStream_t);
// indexed by (B > kTgt2MaxB) << 2 | allowed << 1 | leader
const Launch kLaunch[8] = {
    launch<false, false, 2>, launch<false, true, 2>,
    launch<true, false, 2>,  launch<true, true, 2>,
    launch<false, false, 4>, launch<false, true, 4>,
    launch<true, false, 4>,  launch<true, true, 4>,
};

long long key_words(int B) {
  const int B2 = B / 2 > 1 ? B / 2 : 1;
  return static_cast<long long>(kKeyCopies) * score::key_columns(B, B2);
}

}  // namespace

extern "C" {

// the largest broker bucket the kernel takes
int pallas_session_max_brokers() { return kMaxB; }

// 64-bit words of scratch a launch needs: the key arrays, then the
// barrier words
long long pallas_session_scratch_words(int B) {
  return key_words(B) + kSyncWords;
}

// Run a whole session on `stream`. replicas, member, loads and bcount are
// the session's working state, updated in place; `log` ([4, max_moves]) is
// set to -1 and filled, `counts` ([3]) receives n | iterations | done.
// `stamps` is null, or [min(budget, max_moves) + 1, 7] int64 that receives
// block 0's clock64() at the phase boundaries of each iteration (kPhases).
// Returns the first CUDA error (0 = cudaSuccess); nothing is
// synchronised.
int pallas_session_launch(
    int32_t* replicas, const float* cols, uint8_t* member,
    const uint8_t* allowed, float* loads, int32_t* bcount,
    const uint8_t* always, const uint8_t* universe, int P, int R, int B,
    int budget, int batch, int max_moves, int allow_leader, float minrep,
    float min_unb, float churn, unsigned long long* scratch, int32_t* log,
    int32_t* counts, long long* stamps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > kMaxB || R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int B2 = B / 2 > 1 ? B / 2 : 1;
  int dev = 0, n_sm = 0, coop = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const long long nkeys = key_words(B);
  if ((err = cudaMemsetAsync(scratch, 0xFF, sizeof(*scratch) * nkeys, st)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(scratch + nkeys, 0,
                             sizeof(*scratch) * kSyncWords, st)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(log, 0xFF,
                             sizeof(*log) * 4 * static_cast<size_t>(max_moves),
                             st)) != cudaSuccess ||
      (err = cudaMemsetAsync(counts, 0, sizeof(*counts) * 3, st)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  const int K = B + B2;
  Sess s{};
  s.rows = score::Rows{replicas, cols, member, allowed, nullptr, P, R, B, B2};
  s.replicas = replicas;
  s.member = member;
  s.loads = loads;
  s.bcount = bcount;
  s.always = always;
  s.universe = universe;
  s.keys = scratch;
  s.arrive = scratch + nkeys;
  s.epoch = scratch + nkeys + kSyncWords / 2;
  s.log = log;
  s.counts = counts;
  s.stamps = stamps;
  s.minrep = minrep;
  s.min_unb = min_unb;
  s.churn = churn;
  s.K = K;
  s.budget = budget;
  s.batch = batch;
  s.max_moves = max_moves;
  const int variant = (B > kTgt2MaxB ? 4 : 0) | (allowed ? 2 : 0) |
                      (allow_leader ? 1 : 0);
  return static_cast<int>(kLaunch[variant](s, n_sm, st));
}

const char* pallas_session_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
