// pallas_session: the whole batched converge session on Hopper (sm_90a), one
// persistent cooperative launch per chunk.
//
// Replaces kafkabalancer_tpu/solvers/pallas_session.py:_kernel, the Pallas
// TPU kernel behind pallas_session. One launch runs what the torch session
// (solvers/scan.py) runs as a host loop: per iteration it scores every
// target broker and every hot/cold pair column (score::stage_tile and
// score::score_staged, the tile body of the scoring kernel shard_score.cu),
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
// 3.35 TB/s there. In practice each iteration pays the scoring pass's
// instruction rate (see shard_score.cu), two grid barriers, and the
// acceptance, which runs on one block: O(K^2) compares per pass over the
// pool, ~150k at B = 256, in shared memory.
//
// Design:
// - Cooperative launch, grid = co-resident blocks (occupancy x SMs, at most
//   one per tile), each looping over tiles grid-stride. Session state lives
//   in device memory the wrapper allocates (working copies of loads,
//   broker counts, replicas and member bytes; the log; n, iterations and a
//   done flag); every block reads it with L1-bypassing loads after a grid
//   barrier.
// - Each iteration every block rebuilds the broker table in its own shared
//   memory: validity from the broker counts, avg and the penalty sum su in
//   ops/cost.py:ordered_sum's order, (load, id) ranks by counting (B is
//   small), the hot/cold pair frame and its chain. Every block computes the
//   same bits from the same state, so no barrier is spent on it.
// - Scoring offers to kKeyCopies key arrays through 64-bit atomicMin, as in
//   shard_score.cu. After the barrier block 0 folds the copies, resets them
//   to empty behind its reads (the next iteration's offers come after the
//   next barrier, so one set of keys suffices), recovers the follower slots
//   and finishes the pair winners, then runs the acceptance with one thread
//   per candidate k looping over j (no [K, K] matrix is stored: at
//   B = 1024 it would not fit), and commits. The per-broker net prefix sums
//   follow ordered_sum over j; the commit writes loads + sum(targets) -
//   sum(sources), each sum in ascending candidate order, as the TPU kernel
//   does (not the torch session's sources-then-targets scatter).
// - The kernel is specialised on the allowed mask and the leader pass.
// Not carried over from the TPU kernel (Mosaic and VMEM workarounds): the
// transposed [R, P] layout, integers held in float32, one-hot MXU gathers
// and placements, pairwise [K, K] masks, the TILE_P alignment of P and the
// VMEM capacity gate. State is in device memory, so the only limits are
// the acceptance block's shared memory (B <= kMaxB) and the tile's.
//
// Exactness: as shard_score.cu (--fmad=false, IEEE division, -0.0 packs as
// +0.0, a NaN candidate never wins, an empty column is (+inf, row 0)), and
// every reduction in the order of the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using score::kEmpty;
using score::kKeyCopies;
using score::kThreads;

constexpr int kMaxB = 1024;  // broker bucket the acceptance block takes
constexpr int kBlocksPerSm = 8;  // the scoring kernel's tile sizing

struct Sess {
  score::Rows rows;          // replicas and member: the working copies
  int32_t* replicas;         // [P, R], == rows.replicas
  uint8_t* member;           // [P, B], == rows.member
  float* loads;              // [B]
  int32_t* bcount;           // [B] replicas held per broker
  const uint8_t* always;     // [B] configured brokers (always in the table)
  const uint8_t* universe;   // [B] real (unpadded) brokers
  unsigned long long* keys;  // kKeyCopies key arrays, all-ones at launch
  int32_t* log;              // [4, max_moves]: p | slot | src | tgt
  int32_t* counts;           // [3]: n | iterations | done
  float minrep, min_unb, churn;
  int K, tile, ntiles, budget, batch, max_moves;
};

struct Scalars {
  float avg, su, best_gain;
  int nb, n, done, cnt;
};

// The dynamic shared memory: the broker table, then a work area that holds
// a tile's staged masks while scoring and the candidate pool while block 0
// accepts.
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
  float* c_vals;     // [K] absolute (su-based) scores
  int32_t* c_p;      // [K]
  int32_t* c_slot;   // [K]
  int32_t* c_s;      // [K]
  int32_t* c_t;      // [K]
  float* c_w;        // [K] applied load delta
  int32_t* c_pos;    // [K] move-log position
  uint8_t* c_imp;    // [K] improving, then survives the cut
  uint8_t* c_surv;   // [K] survives the partition claims
  uint8_t* c_ok;     // [K] accepted
};

__host__ __device__ __forceinline__ int table_bytes(int B, int B2) {
  return score::round16(17 * B + 13 * B2);
}

__host__ __device__ __forceinline__ int pool_bytes(int K) {
  return score::round16(31 * K);
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
  l.c_vals = reinterpret_cast<float*>(l.work);
  l.c_p = reinterpret_cast<int32_t*>(l.c_vals + K);
  l.c_slot = l.c_p + K;
  l.c_s = l.c_slot + K;
  l.c_t = l.c_s + K;
  l.c_w = reinterpret_cast<float*>(l.c_t + K);
  l.c_pos = reinterpret_cast<int32_t*>(l.c_w + K);
  l.c_imp = reinterpret_cast<uint8_t*>(l.c_pos + K);
  l.c_surv = l.c_imp + K;
  l.c_ok = l.c_surv + K;
  return l;
}

// ops/cost.py:ordered_sum over x(0), ..., x(n-1): up to 32 terms left to
// right from zero; a longer axis is cut into blocks of 32 after a symmetric
// zero pad (the low side gets the smaller half), each block summed left to
// right, and the block sums reduced the same way. The pad's zeros are
// skipped: adding +0.0 to a sum that started at +0.0 changes no bit.
template <int kDepth, class Fn>
__device__ float ordered_sum(Fn x, int n) {
  if constexpr (kDepth == 0) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc = acc + x(i);
    return acc;
  } else {
    if (n <= 32) return ordered_sum<0>(x, n);
    const int nblk = (n + 31) / 32;
    const int lo = (nblk * 32 - n) / 2;
    auto block = [&](int b) {
      float acc = 0.0f;
      for (int m = 0; m < 32; ++m) {
        const int i = b * 32 + m - lo;
        if (i >= 0 && i < n) acc = acc + x(i);
      }
      return acc;
    };
    return ordered_sum<kDepth - 1>(block, nblk);
  }
}
// depth 2 covers n <= 32^3, past any pool this kernel takes
constexpr int kSumDepth = 2;

// The broker table of this iteration (cost.py: the table, avg, F, su,
// rank_brokers and pair_frame), computed by every block from the state.
__device__ void build_table(const Sess& s, const Layout& l, Scalars& sc) {
  const int B = s.rows.B, B2 = s.rows.B2;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const int c = __ldcg(s.bcount + b);
    l.loads[b] = __ldcg(s.loads + b);
    l.bvalid[b] = (s.always[b] || c > 0) && s.universe[b];
    l.head[b] = -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nb = 0;
    for (int b = 0; b < B; ++b) nb += l.bvalid[b];
    sc.nb = nb;
    sc.avg = ordered_sum<kSumDepth>(
                 [&](int b) { return l.bvalid[b] ? l.loads[b] : 0.0f; }, B) /
             static_cast<float>(nb);
  }
  __syncthreads();
  const float avg = sc.avg;
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
  __syncthreads();
  if (threadIdx.x == 0) {
    sc.su = ordered_sum<kSumDepth>([&](int b) { return l.F[b]; }, B);
  }
  const int npair = sc.nb / 2;
  for (int c = threadIdx.x; c < B2; c += kThreads) {
    const bool live = c < npair;
    l.live[c] = live;
    l.s[c] = live ? l.perm[sc.nb - 1 - c] : 0;
    l.t[c] = live ? l.perm[c] : 0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < B2; c += kThreads) {
    if (l.live[c]) l.next[c] = atomicExch(&l.head[l.s[c]], c);
  }
  __syncthreads();
}

// the minimum of key column j over the copies, which are reset to empty
__device__ __forceinline__ unsigned long long fold(const Sess& s, int ncol,
                                                   int j) {
  unsigned long long k = kEmpty;
  for (int copy = 0; copy < kKeyCopies; ++copy) {
    unsigned long long* a = s.keys + copy * ncol + j;
    k = min(k, __ldcg(a));
    __stcg(a, kEmpty);
  }
  return k;
}

// the applied load delta of moving slot `slot` of row p: the leader
// premium travels with slot 0 (utils.go:96-101)
__device__ __forceinline__ float applied_delta(const Sess& s, int p,
                                               int slot) {
  const float* c = s.rows.cols + (size_t)p * 5;
  return slot == 0 ? c[0] * (c[1] + c[3]) : c[0];
}

// Block 0, after the scoring barrier: the pool (scan.batch_pool), the
// acceptance (scan.prefix_accept) and the commit.
template <bool kLead>
__device__ void accept_commit(const Sess& s, const Layout& l, Scalars& sc,
                              int n) {
  const int B = s.rows.B, B2 = s.rows.B2, R = s.rows.R, P = s.rows.P;
  const int K = s.K;
  const int ncol = score::key_columns(B, B2);
  const float avg = sc.avg, su = sc.su, mu = s.min_unb;
  const float inf = INFINITY;

  // ---- the pool: per-target winners, then the pair winners --------------
  for (int b = threadIdx.x; b < B; b += kThreads) {
    float vf, vl;
    int32_t pf, pl;
    score::unpack(fold(s, ncol, b), vf, pf);
    score::unpack(fold(s, ncol, B + b), vl, pl);  // (+inf, 0) without leaders
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
  }
  for (int c = threadIdx.x; c < B2; c += kThreads) {
    float vf, vl;
    int32_t pf, pl;
    score::unpack(fold(s, ncol, 2 * B + c), vf, pf);
    score::unpack(fold(s, ncol, 2 * B + B2 + c), vl, pl);
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
  if (threadIdx.x == 0) sc.cnt = 0;
  __syncthreads();

  // ---- scan.prefix_accept ------------------------------------------------
  if (threadIdx.x == 0) {
    // torch amin: NaN if any
    float m = inf;
    bool nan = false;
    for (int k = 0; k < K; ++k) {
      const float v = l.c_vals[k];
      if (isnan(v)) nan = true;
      else if (v < m) m = v;
    }
    sc.best_gain = nan ? NAN : su - m;
  }
  __syncthreads();
  const float best_gain = sc.best_gain;
  const float su_mu = su - mu;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = l.c_vals[k];
    l.c_imp[k] = isfinite(v) && v < su_mu && v < su &&
                 (su - v) * s.churn >= best_gain;
  }
  __syncthreads();
  // E(j, k): candidate j strictly earlier in (value, index) order
  auto earlier = [&](int j, int k) {
    const float vj = l.c_vals[j], vk = l.c_vals[k];
    return vj < vk || (vj == vk && j < k);
  };
  // partition first-claim among improving candidates
  for (int k = threadIdx.x; k < K; k += kThreads) {
    bool surv = l.c_imp[k];
    for (int j = 0; surv && j < K; ++j) {
      if (l.c_imp[j] && l.c_p[j] == l.c_p[k] && earlier(j, k)) surv = false;
    }
    l.c_surv[k] = surv;
  }
  __syncthreads();
  // each survivor's exact sequential delta from the per-broker net prefix
  // sums over earlier survivors
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int sk = l.c_s[k], tk = l.c_t[k];
    const float wk = l.c_w[k];
    auto term = [&](int j, int x) {
      const float e = (l.c_surv[j] && earlier(j, k)) ? 1.0f : 0.0f;
      const float to = static_cast<float>(l.c_t[j] == x) -
                       static_cast<float>(l.c_s[j] == x);
      return (e * l.c_w[j]) * to;
    };
    const float Ls =
        (sk >= 0 && sk < B ? l.loads[sk] : 0.0f) +
        ordered_sum<kSumDepth>([&](int j) { return term(j, sk); }, K);
    const float Lt =
        (tk >= 0 && tk < B ? l.loads[tk] : 0.0f) +
        ordered_sum<kSumDepth>([&](int j) { return term(j, tk); }, K);
    const float d = score::penalty(Ls - wk, avg) - score::penalty(Ls, avg) +
                    score::penalty(Lt + wk, avg) - score::penalty(Lt, avg);
    l.c_ok[k] = l.c_surv[k] && d < -mu && d < 0.0f;
  }
  __syncthreads();
  // cut at the first survivor whose sequential delta fails
  for (int k = threadIdx.x; k < K; k += kThreads) {
    bool ok = l.c_ok[k];
    for (int j = 0; ok && j < K; ++j) {
      if (l.c_surv[j] && !l.c_ok[j] && earlier(j, k)) ok = false;
    }
    l.c_imp[k] = ok;
  }
  __syncthreads();
  // cap at the batch width, the budget and the log, best-first
  int mine = 0;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    bool ok = l.c_imp[k];
    int pos = n;
    for (int j = 0; ok && j < K; ++j) pos += l.c_imp[j] && earlier(j, k);
    ok = ok && pos < n + s.batch && pos < s.budget && pos < s.max_moves;
    l.c_ok[k] = ok;
    l.c_pos[k] = pos;
    mine += ok;
  }
  if (mine) atomicAdd(&sc.cnt, mine);
  __syncthreads();

  // ---- commit --------------------------------------------------------------
  const int ml = s.max_moves;
  for (int k = threadIdx.x; k < K; k += kThreads) {
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
    // ascending candidate order
    float to = 0.0f, from = 0.0f;
    int dc = 0;
    for (int k = 0; k < K; ++k) {
      if (!l.c_ok[k]) continue;
      if (l.c_t[k] == b) {
        to = to + l.c_w[k];
        ++dc;
      }
      if (l.c_s[k] == b) {
        from = from + l.c_w[k];
        --dc;
      }
    }
    s.loads[b] = (l.loads[b] + to) - from;
    s.bcount[b] = __ldcg(s.bcount + b) + dc;
  }
  if (threadIdx.x == 0) {
    s.counts[0] = n + sc.cnt;
    s.counts[1] += 1;
    s.counts[2] = sc.cnt == 0;
  }
}

template <bool kAlw, bool kLead>
__global__ void __launch_bounds__(kThreads) session_kernel(Sess s) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ score::TileShared ts;
  __shared__ Scalars sc;
  cg::grid_group grid = cg::this_grid();

  // a local copy: a reference to the kernel parameter would move it to
  // local memory
  const score::Rows rows = s.rows;
  const int B = rows.B, B2 = rows.B2;
  const Layout l = layout(s_dyn, B, B2, s.K);
  uint8_t* const s_mem = l.work;
  uint8_t* const s_alw = l.work + score::round16(s.tile * B);
  unsigned long long* const keys =
      s.keys + (blockIdx.x % kKeyCopies) * score::key_columns(B, B2);

  for (;;) {
    if (threadIdx.x == 0) {
      sc.n = __ldcg(s.counts);
      sc.done = __ldcg(s.counts + 2);
    }
    __syncthreads();
    const int n = sc.n;
    // every block reads the same state, so all leave together
    if (sc.done || n >= s.budget || n >= s.max_moves) break;
    build_table(s, l, sc);
    const score::Table tb{l.loads, l.F, l.bvalid, l.head, l.next, l.t,
                          sc.avg, s.minrep, 0.0f};
    for (int ti = blockIdx.x; ti < s.ntiles; ti += gridDim.x) {
      const int p0 = ti * s.tile;
      const int nrows = min(s.tile, rows.P - p0);
      score::stage_tile<kAlw, true>(rows, ts, s_mem, s_alw, p0, nrows);
      __syncthreads();
      score::score_staged<kAlw, false, kLead>(rows, tb, ts, s_mem, s_alw, p0,
                                              nrows, keys);
      __syncthreads();  // before the next tile's staging
    }
    grid.sync();
    if (blockIdx.x == 0) accept_commit<kLead>(s, l, sc, n);
    grid.sync();
  }
}

int dyn_smem_bytes(int tile, int B, int B2, int K, bool has_allowed) {
  return table_bytes(B, B2) +
         std::max(score::mask_bytes(tile, B, has_allowed), pool_bytes(K));
}

template <bool kAlw, bool kLead>
cudaError_t launch(Sess s, int smem, int n_sm, cudaStream_t st) {
  auto kernel = session_kernel<kAlw, kLead>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::min(per_sm * n_sm, std::max(1, s.ntiles));
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kThreads), args,
                                    static_cast<size_t>(smem), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(Sess, int, int, cudaStream_t);
// indexed by allowed << 1 | leader
const Launch kLaunch[4] = {
    launch<false, false>, launch<false, true>,
    launch<true, false>, launch<true, true>,
};

}  // namespace

extern "C" {

// the largest broker bucket the kernel takes
int pallas_session_max_brokers() { return kMaxB; }

// 64-bit words of key scratch a launch needs
long long pallas_session_scratch_words(int B) {
  const int B2 = B / 2 > 1 ? B / 2 : 1;
  return static_cast<long long>(kKeyCopies) * score::key_columns(B, B2);
}

// Run a whole session on `stream`. replicas, member, loads and bcount are
// the session's working state, updated in place; `log` ([4, max_moves]) is
// set to -1 and filled, `counts` ([3]) receives n | iterations | done.
// Returns the first CUDA error (0 = cudaSuccess); nothing is
// synchronised.
int pallas_session_launch(
    int32_t* replicas, const float* cols, uint8_t* member,
    const uint8_t* allowed, float* loads, int32_t* bcount,
    const uint8_t* always, const uint8_t* universe, int P, int R, int B,
    int budget, int batch, int max_moves, int allow_leader, float minrep,
    float min_unb, float churn, unsigned long long* scratch, int32_t* log,
    int32_t* counts, void* stream) {
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
  if ((err = cudaMemsetAsync(scratch, 0xFF,
                             sizeof(*scratch) *
                                 pallas_session_scratch_words(B),
                             st)) != cudaSuccess ||
      (err = cudaMemsetAsync(log, 0xFF,
                             sizeof(*log) * 4 * static_cast<size_t>(max_moves),
                             st)) != cudaSuccess ||
      (err = cudaMemsetAsync(counts, 0, sizeof(*counts) * 3, st)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tile =
      score::tile_rows(P, B, allowed != nullptr, n_sm, kBlocksPerSm);
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
  s.log = log;
  s.counts = counts;
  s.minrep = minrep;
  s.min_unb = min_unb;
  s.churn = churn;
  s.K = K;
  s.tile = tile;
  s.ntiles = (P + tile - 1) / tile;
  s.budget = budget;
  s.batch = batch;
  s.max_moves = max_moves;
  const int smem = dyn_smem_bytes(tile, B, B2, K, allowed != nullptr);
  const int variant = (allowed ? 2 : 0) | (allow_leader ? 1 : 0);
  return static_cast<int>(kLaunch[variant](s, smem, n_sm, st));
}

const char* pallas_session_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
