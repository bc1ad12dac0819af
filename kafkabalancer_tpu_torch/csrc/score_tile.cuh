// score_tile.cuh: the converge session's scoring pass over one block's rows,
// shared by the scoring kernel (shard_score.cu) and the whole-session kernel
// (pallas_session.cu).
//
// A block scores a contiguous run of partition rows, tile by tile. For every
// target broker it finds its follower and leader minimum of A*[p] + C[p, t]
// (lowest row wins ties), and for every live hot/cold pair column the
// follower and leader minimum of A[p, s] + C[p, t]. Every minimum is a
// 64-bit key (order-preserving value bits << 32 | row) whose unsigned order
// is the lexicographic (value, row) order, which is what a strict-< scan over
// ascending rows computes; keys meet through atomicMin, exact in any order of
// arrival. The block keeps its target minima (registers, then shared
// memory) and offers each to the caller's device keys once, at the end;
// pair candidates go to the device keys as they are found. See
// shard_score.cu for the design and exactness notes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace score {

constexpr int kMaxTile = 64;  // partition rows per tile, at most
// member cells a tile lists for the row pass; past it they are worked where
// they are found
constexpr int kMaxCells = 4 * kMaxTile;
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaskBudget = 96 * 1024;  // staged mask bytes per block
constexpr unsigned long long kEmpty = ~0ull;  // no candidate yet
// copies of the device key array; block i offers to copy i % kKeyCopies, so
// the atomics of concurrent blocks land on different L2 lines
constexpr int kKeyCopies = 16;

__device__ __forceinline__ float penalty(float load, float avg) {
  // cost.overload_penalty: rel^2 if overloaded else rel^2 / 2
  float rel = load / avg - 1.0f;
  return rel * rel * (rel > 0.0f ? 1.0f : 0.5f);
}

// Division by one avg, many times. y = RN(1/avg); for x and avg inside the
// ranges below, q = RN(x*y), r = x - avg*q (exact through the FMA) and
// RN(q + r*y) is the correctly rounded x / avg (Markstein). Outside them
// (zeros, subnormals, huge or non-finite x, an avg far from 1), the IEEE
// division. chip_smoke.py holds quot against
// __fdiv_rn for every finite float32 x at every avg its run meets.
struct Div {
  float avg, y, lo, hi;  // |x| in [lo, hi] takes the reciprocal
  bool ok;               // avg is in the reciprocal's range
};

__device__ __forceinline__ Div make_div(float avg) {
  Div d;
  d.avg = avg;
  d.y = __frcp_rn(avg);
  d.ok = avg >= 0x1p-40f && avg <= 0x1p40f;
  d.lo = d.ok ? 0x1p-60f : INFINITY;  // an empty range when not ok
  d.hi = d.ok ? 0x1p60f : 0.0f;
  return d;
}

// x / avg through the reciprocal; for d.ok and |x| in [2^-60, 2^60] only
__device__ __forceinline__ float quot_recip(float x, const Div& d) {
  const float q = __fmul_rn(x, d.y);
  const float r = __fmaf_rn(-d.avg, q, x);
  return __fmaf_rn(r, d.y, q);
}

__device__ __forceinline__ float quot(float x, const Div& d) {
  const float ax = fabsf(x);
  if (ax >= d.lo && ax <= d.hi) return quot_recip(x, d);
  return __fdiv_rn(x, d.avg);
}

// cost.overload_penalty from the quotient load / avg
__device__ __forceinline__ float penalty_q(float q) {
  const float rel = q - 1.0f;
  return rel * rel * (rel > 0.0f ? 1.0f : 0.5f);
}

__device__ __forceinline__ float penalty(float load, const Div& d) {
  return penalty_q(quot(load, d));
}

__device__ __forceinline__ float colo_sub(float c, float lam) {
  return c >= 2.0f ? lam : 0.0f;
}

__device__ __forceinline__ float colo_add(float c, float lam) {
  return c >= 1.0f ? lam : 0.0f;
}

// (value, row) as one key whose unsigned order is the lexicographic order
__device__ __forceinline__ unsigned long long pack(float v, int row) {
  unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned int>(row);
}

__device__ __forceinline__ void unpack(unsigned long long k, float& v,
                                       int32_t& row) {
  if (k == kEmpty) {
    v = INFINITY;
    row = 0;
    return;
  }
  unsigned int u = static_cast<unsigned int>(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  v = __uint_as_float(u);
  row = static_cast<int32_t>(k & 0xffffffffu);
}

// offer (v, row) to a key in shared or device memory
__device__ __forceinline__ void offer(unsigned long long* key, float v,
                                      int row) {
  if (v < INFINITY) atomicMin(key, pack(v, row));
}

// a load from device memory; kCG bypasses L1, for memory that another block
// rewrites between grid barriers (the whole-session kernel's state)
template <bool kCG, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kCG) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// copy n bytes from device memory into shared memory (dst 16-byte
// aligned): 16 at a time with cp.async.cg (straight into shared memory,
// through L2 only, so never a stale L1 line of memory another block
// rewrote) where the source is aligned, the rest with plain loads. The
// async part lands after cp.async.wait_group and a barrier.
template <bool kCG>
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = n / 16;
    for (int i = threadIdx.x; i < n16; i += kThreads) {
      const unsigned int d =
          static_cast<unsigned int>(__cvta_generic_to_shared(dst + 16 * i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + 16 * i)
                   : "memory");
    }
    done = n16 * 16;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) {
    dst[i] = load<kCG>(src + i);
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until this thread's committed copies have landed
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// How a grid of up to `resident` blocks splits P rows: each block takes a
// contiguous chunk of `chunk` rows (a multiple of 16, so the chunks come out
// even and every tile's mask bytes start 16-byte aligned), walked in tiles
// of `tile` rows; `blocks` chunks cover P (1 when P is 0).
struct Split {
  int chunk, tile, blocks;
};

inline Split split_rows(int P, int resident, int max_rows) {
  Split s;
  resident = resident > 0 ? resident : 1;
  s.chunk = round16((P + resident - 1) / resident);
  if (s.chunk < 16) s.chunk = 16;
  s.tile = max_rows < s.chunk ? max_rows : s.chunk;
  s.blocks = P > 0 ? (P + s.chunk - 1) / s.chunk : 1;
  return s;
}

// bytes of the tile buffer: the member (and allowed) rows, the row columns
// and the replica rows, each 16-byte aligned
__host__ __device__ __forceinline__ int buffer_bytes(int tile, int B, int R,
                                                     bool has_allowed) {
  return round16(tile * B) * (has_allowed ? 2 : 1) + round16(tile * 20) +
         round16(tile * R * 4);
}

// Key columns, ncol = 2B + 2*B2: [0, B) follower target | [B, 2B) leader
// target | [2B, 2B+B2) follower pair | [2B+B2, 2B+2*B2) leader pair.
__host__ __device__ __forceinline__ int key_columns(int B, int B2) {
  return 2 * B + 2 * B2;
}

// score_rows' shared work area: the block's target keys (2B words), then
// the tile buffer
__host__ __device__ __forceinline__ int work_bytes(int tile, int B, int R,
                                                   bool has_allowed) {
  return 16 * B + buffer_bytes(tile, B, R, has_allowed);
}

// rows per tile: kMaxTile, halved until the tile buffer fits the budget
inline int max_tile(int B, int R, bool has_allowed) {
  int tile = kMaxTile;
  while (tile > 1 && buffer_bytes(tile, B, R, has_allowed) > kMaskBudget) {
    tile /= 2;
  }
  return tile;
}

// the per-row inputs; row-major, device memory
struct Rows {
  const int32_t* replicas;  // [P, R]
  const float* cols;        // [P, 5]: w | ncur | ntgt | ncons | pvalid
  const uint8_t* member;    // [P, B]
  const uint8_t* allowed;   // [P, B] or null (every broker allowed)
  const float* crows;       // [P, B] or null (no colocation terms)
  int P, R, B, B2;
};

// the per-broker table of one scoring pass, in shared memory
struct Table {
  const float* loads;      // [B]
  const float* F;          // [B] per-broker penalty (0 on invalid brokers)
  const uint8_t* bvalid;   // [B]
  const int32_t* head;     // [B] a live pair column per hot broker, or -1
  const int32_t* next;     // [B2] the next live column with the same
  const int32_t* t;        // [B2] cold broker of each pair column
  float avg, minrep, lam;
};

// the staged tile, in the tile buffer
struct Tile {
  const uint8_t* mem;    // [tile, B] member rows
  const uint8_t* alw;    // [tile, B] allowed rows (kAlw)
  const float* cols;     // [tile, 5]
  const int32_t* reps;   // [tile, R] replica rows; the leader first

  // the tile buffer at `buf` (buffer_bytes)
  __device__ __forceinline__ Tile(uint8_t* buf, int tile, int B, int R,
                                  bool has_allowed) {
    const int masks = round16(tile * B) * (has_allowed ? 2 : 1);
    mem = buf;
    alw = buf + round16(tile * B);
    cols = reinterpret_cast<const float*>(buf + masks);
    reps = reinterpret_cast<const int32_t*>(buf + masks + round16(tile * 20));
  }
};

// the tile's per-row terms, in shared memory
struct TileShared {
  int ncell;                // member cells listed
  int cell[kMaxCells];      // r * B + b of each listed member cell
  unsigned int akey[kMaxTile];  // follower source minimum A* as key32
  float al[kMaxTile];     // leader source term A_l
  float w[kMaxTile];      // follower delta w
  float wl[kMaxTile];     // leader delta w*(ncur+ncons)
  // each warp's ascending list of the tile's live rows (a finite A* or A_l)
  uint8_t live[kWarps][kMaxTile];
};

// Start copying rows [p0, p0 + nrows) into the tile buffer `t`: the member
// (and allowed) bytes, the row columns and the replica rows; then commit
// the copies as one group.
template <bool kAlw, bool kCG>
__device__ __forceinline__ void stage_tile(const Rows& a, const Tile& t,
                                           int p0, int nrows) {
  const int B = a.B, R = a.R;
  stage<kCG>(const_cast<uint8_t*>(t.mem), a.member + (size_t)p0 * B,
             nrows * B);
  if (kAlw) {
    stage<kCG>(const_cast<uint8_t*>(t.alw), a.allowed + (size_t)p0 * B,
               nrows * B);
  }
  stage<kCG>(reinterpret_cast<uint8_t*>(const_cast<float*>(t.cols)),
             reinterpret_cast<const uint8_t*>(a.cols + (size_t)p0 * 5),
             nrows * 20);
  stage<kCG>(reinterpret_cast<uint8_t*>(const_cast<int32_t*>(t.reps)),
             reinterpret_cast<const uint8_t*>(a.replicas + (size_t)p0 * R),
             nrows * R * 4);
  async_commit();
}

// A source term as a 32-bit key whose unsigned order is the float order
// (-0.0 as +0.0), NaN as 0: one atomicMin over a row's terms gives their
// minimum, or 0 when one of them is NaN (the plain version's NaN-
// propagating min); 0xffffffff is "no term" (+inf).
__device__ __forceinline__ unsigned int key32(float v) {
  if (isnan(v)) return 0u;
  const unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unkey32(unsigned int k) {
  if (k == 0u) return NAN;
  if (k == 0xffffffffu) return INFINITY;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The row pass, by every thread of the block at once, in two steps with a
// barrier between them. First each thread scans 16-byte chunks of the
// tile's member bytes and lists every member cell it finds (ts.cell: a warp
// prefix and one shared atomicAdd per warp give the places; a cell past
// kMaxCells is worked at once). Then every thread works listed cells: a
// source cell (a member broker of an eligible row, not its leader) joins
// its row's A* (ts.akey, 32-bit atomicMin) and offers its pair candidates
// to the device keys' pair columns (`keys`); and threads r < nrows finish
// row r: its leader
// term A_l and leader pair candidates, and its deltas. ts.akey must hold
// 0xffffffff for every row and ts.ncell 0 before.
template <bool kAlw, bool kColo, bool kLead>
__device__ __forceinline__ void row_pass(const Rows& a, const Table& tb,
                                         const Div& dv, TileShared& ts,
                                         const Tile& tl, int p0, int nrows,
                                         unsigned long long* keys) {
  const int B = a.B, B2 = a.B2, R = a.R;
  const uint8_t* const s_mem = tl.mem;
  const uint8_t* const s_alw = tl.alw;
  const float minrep = tb.minrep, lam = tb.lam;
  const float inf = INFINITY;
  unsigned long long* const keys_pf = keys + 2 * B;
  unsigned long long* const keys_pl = keys + 2 * B + B2;
  // the pair target term of row r at broker t, or +inf where t takes no move
  auto pair_target = [&](int r, int t, float delta) {
    const int cell = r * B + t;
    if (!tb.bvalid[t] || s_mem[cell] || (kAlw && !s_alw[cell])) return inf;
    float C = penalty(tb.loads[t] + delta, dv) - tb.F[t];
    if (kColo) C = C + colo_add(a.crows[(size_t)p0 * B + cell], lam);
    return C;
  };
  // member cell f = r * B + b of the tile
  auto work = [&](int f) {
    const int r = f / B, b = f - r * B;
    const float* c = tl.cols + r * 5;
    if (!(c[4] > 0.0f && c[2] >= minrep) || b == tl.reps[r * R]) return;
    const float w = c[0];
    float A = penalty(tb.loads[b] - w, dv) - tb.F[b];
    if (kColo) A = A - colo_sub(a.crows[(size_t)p0 * B + f], lam);
    atomicMin(&ts.akey[r], key32(A));
    for (int pc = tb.head[b]; pc >= 0; pc = tb.next[pc]) {
      offer(&keys_pf[pc], A + pair_target(r, tb.t[pc], w), p0 + r);
    }
  };
  const int n = nrows * B;
  const int nchunk = (n + 15) / 16;
  const int lane = threadIdx.x % 32;
  for (int i0 = 0; i0 < nchunk; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    uint32_t m[4] = {0u, 0u, 0u, 0u};
    int cnt = 0;
    if (i < nchunk) {
      const uint4 q = reinterpret_cast<const uint4*>(s_mem)[i];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        // one bit per nonzero byte; bytes past the tile's rows are stale
        const int left = n - (16 * i + 4 * wd);
        const uint32_t keep =
            left >= 4 ? 0x01010101u : (left <= 0 ? 0u : (1u << (8 * left)) - 1u);
        m[wd] = __vcmpne4(words[wd], 0u) & 0x01010101u & keep;
        cnt += __popc(m[wd]);
      }
    }
    int incl = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int base = 0;
    if (lane == 31 && total) base = atomicAdd(&ts.ncell, total);
    int pos = __shfl_sync(0xffffffffu, base, 31) + incl - cnt;
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {
      for (uint32_t mm = m[wd]; mm; mm &= mm - 1) {
        const int f = 16 * i + 4 * wd + (__ffs(mm) - 1) / 8;
        if (pos < kMaxCells) {
          ts.cell[pos] = f;
        } else {
          work(f);
        }
        ++pos;
      }
    }
  }
  __syncthreads();
  const int listed = min(ts.ncell, kMaxCells);
  for (int j = threadIdx.x; j < listed; j += kThreads) work(ts.cell[j]);
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const float* c = tl.cols + r * 5;
    const float w = c[0], ncur = c[1], ntgt = c[2], ncons = c[3];
    const float wl = w * (ncur + ncons);
    float al = inf;
    const int lead = tl.reps[r * R];
    if (kLead && ncur >= 1.0f && c[4] > 0.0f && ntgt >= minrep && lead >= 0 &&
        lead < B) {
      al = penalty(tb.loads[lead] - wl, dv) - tb.F[lead];
      if (kColo) al = al - colo_sub(a.crows[(size_t)(p0 + r) * B + lead], lam);
      for (int pc = tb.head[lead]; pc >= 0; pc = tb.next[pc]) {
        offer(&keys_pl[pc], al + pair_target(r, tb.t[pc], wl), p0 + r);
      }
    }
    ts.al[r] = al;
    ts.w[r] = w;
    ts.wl[r] = wl;
  }
}

// This warp's ascending list of the tile's live rows (ts.live[warp]): the
// rows with a finite A* (or, with leaders, A_l). Every warp builds the same
// list from the row terms, so no block barrier is spent on it. Returns its
// length.
template <bool kLead>
__device__ __forceinline__ int list_live(TileShared& ts, int nrows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint8_t* lst = ts.live[warp];
  int n = 0;
  for (int c = 0; c < nrows; c += 32) {
    const int r = c + lane;
    const bool live =
        r < nrows &&
        (isfinite(unkey32(ts.akey[r])) || (kLead && isfinite(ts.al[r])));
    const unsigned int m = __ballot_sync(0xffffffffu, live);
    if (live) lst[n + __popc(m & ((1u << lane) - 1u))] = static_cast<uint8_t>(r);
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// kT bytes at p as an integer, byte k in bits [8k, 8k + 8); bytes at k >= n
// read as 0. `aligned`: p is kT-byte aligned and n >= kT.
template <int kT>
__device__ __forceinline__ uint32_t bytes_at(const uint8_t* p, int n,
                                             bool aligned) {
  static_assert(kT == 1 || kT == 2 || kT == 4, "kT bytes in one word");
  if (aligned) {
    if constexpr (kT == 4) return *reinterpret_cast<const uint32_t*>(p);
    if constexpr (kT == 2) return *reinterpret_cast<const uint16_t*>(p);
    return *p;
  }
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    if (k < n) v |= static_cast<uint32_t>(p[k]) << (8 * k);
  }
  return v;
}

// One thread's kT target brokers b0 .. b0 + kT - 1 of the target pass: their
// loads and penalties, and a byte mask of the valid ones.
template <int kT>
struct Targets {
  float L[kT], F[kT];
  uint32_t valid;  // byte k is 1 where b0 + k < B and broker b0 + k is valid
  int b0, n;       // n: how many of the kT are < B
  // the reciprocal's range holds and every valid target's load is in
  // [0, 2^50]: then a delta in [2^-50, 2^50] makes every x = load + delta
  // a number in [2^-50, 2^51], inside quot's reciprocal range
  bool fast;
  __device__ __forceinline__ void load(const Table& tb, const Div& dv, int tg,
                                       int B) {
    b0 = tg * kT;
    n = min(kT, B - b0);
    valid = 0;
    fast = dv.ok;
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      const bool in = k < n;
      L[k] = in ? tb.loads[b0 + k] : 0.0f;
      F[k] = in ? tb.F[b0 + k] : 0.0f;
      if (in && tb.bvalid[b0 + k]) {
        valid |= 1u << (8 * k);
        fast = fast && L[k] >= 0.0f && L[k] <= 0x1p50f;
      }
    }
  }
};

// The running (value, row) minima of one thread's kT targets, over the rows
// it has scanned, in ascending order (a strict < keeps the lowest row).
template <int kT, bool kLead>
struct Acc {
  float vf[kT], vl[kT];
  int rf[kT], rl[kT];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      vf[k] = vl[k] = INFINITY;
      rf[k] = rl[k] = 0;
    }
  }
  // into the block's target keys
  __device__ __forceinline__ void flush(const Targets<kT>& tg,
                                        unsigned long long* bkeys, int B) {
#pragma unroll
    for (int k = 0; k < kT; ++k) {
      if (k < tg.n) {
        offer(&bkeys[tg.b0 + k], vf[k], rf[k]);
        if (kLead) offer(&bkeys[B + tg.b0 + k], vl[k], rl[k]);
      }
    }
  }
};

// The target pass of one thread over its share of the tile's live rows: list
// entries rg, rg + RG, ... (ascending). Per row, one read of the kT member
// (and allowed) bytes and of the row's terms serves kT cells.
template <bool kAlw, bool kColo, bool kLead, int kT>
__device__ __forceinline__ void scan_targets(
    Acc<kT, kLead>& acc, const Targets<kT>& tg, const TileShared& ts,
    const uint8_t* lst, int n, int rg, int RG, const Tile& tl, const Rows& a,
    const Div& dv, float lam, int p0) {
  const int B = a.B;
  const uint8_t* const s_mem = tl.mem;
  const uint8_t* const s_alw = tl.alw;
  const bool aligned = (B % kT) == 0;
#pragma unroll 1
  for (int i = rg; i < n; i += RG) {
    const int r = lst[i];
    const float as = unkey32(ts.akey[r]), w = ts.w[r];
    uint32_t ok = ~bytes_at<kT>(s_mem + r * B + tg.b0, tg.n, aligned) & tg.valid;
    if (kAlw) ok &= bytes_at<kT>(s_alw + r * B + tg.b0, tg.n, aligned);
    const uint32_t okf = isfinite(as) ? ok : 0u;
    float al = INFINITY, wl = 0.0f;
    uint32_t okl = 0u;
    if (kLead) {
      al = ts.al[r];
      wl = ts.wl[r];
      okl = isfinite(al) ? ok : 0u;
    }
    const float* crow = kColo ? a.crows + (size_t)(p0 + r) * B + tg.b0 : nullptr;
    const int p = p0 + r;
    // one strict-< step of the kT cells of a delta; kFast: every x is in
    // the reciprocal's range (tg.fast and the delta's range), so no cell
    // tests it
    auto cells = [&](auto fast, float a_src, float delta, uint32_t okb,
                     float (&vmin)[kT], int (&rmin)[kT]) {
#pragma unroll
      for (int k = 0; k < kT; ++k) {
        const float x = tg.L[k] + delta;
        const float q =
            decltype(fast)::value ? quot_recip(x, dv) : quot(x, dv);
        float C = penalty_q(q) - tg.F[k];
        if (kColo) C = C + (k < tg.n ? colo_add(crow[k], lam) : 0.0f);
        const float v = a_src + C;
        const bool take = ((okb >> (8 * k)) & 1u) && v < vmin[k];
        vmin[k] = take ? v : vmin[k];
        rmin[k] = take ? p : rmin[k];
      }
    };
    auto in_range = [&](float delta) {
      return tg.fast && delta >= 0x1p-50f && delta <= 0x1p50f;
    };
    if (okf) {
      if (in_range(w)) cells(std::true_type{}, as, w, okf, acc.vf, acc.rf);
      else cells(std::false_type{}, as, w, okf, acc.vf, acc.rf);
    }
    if (kLead && okl) {
      if (in_range(wl)) cells(std::true_type{}, al, wl, okl, acc.vl, acc.rl);
      else cells(std::false_type{}, al, wl, okl, acc.vl, acc.rl);
    }
  }
}

// Score rows [r0, r1) in tiles of `tile` rows and offer this block's keys to
// `keys` (one device key array of key_columns(B, B2) words): each target
// key once, at the end; pair candidates as they are found.
// Called by every thread of the block, with the same `r0`, `r1` in every
// thread; the table must be written and visible after one barrier.
// `work` is work_bytes(tile, ...) bytes of 16-byte aligned shared memory:
// the block's target keys, then the tile buffer. A barrier must follow
// before the caller reuses it or publishes the offers.
//
// The target pass gives each thread kT adjacent targets (a target group)
// and a row group: G = ceil(B / kT) groups; with G <= kThreads the block
// holds RG = kThreads / G row groups, thread t takes group t % G and row
// group t / G, and its minima stay in registers across all its tiles,
// merged into the block's keys once at the end. With more groups than
// threads (B > kT * kThreads, the scoring kernel only), each thread walks
// groups t, t + kThreads, ... and merges after every tile.
template <bool kAlw, bool kColo, bool kLead, bool kCG, int kT>
__device__ __forceinline__ void score_rows(const Rows& a, const Table& tb,
                                           TileShared& ts, uint8_t* work,
                                           int tile, int r0, int r1,
                                           unsigned long long* keys) {
  if (r0 >= r1) return;
  const int B = a.B, R = a.R;
  unsigned long long* const bkeys = reinterpret_cast<unsigned long long*>(work);
  const Tile tl(work + 16 * B, tile, B, R, kAlw);
  const Div dv = make_div(tb.avg);
  for (int j = threadIdx.x; j < 2 * B; j += kThreads) bkeys[j] = kEmpty;

  const int G = (B + kT - 1) / kT;
  const bool persist = G <= kThreads;
  const int RG = persist ? kThreads / G : 1;
  const int tg0 = persist ? threadIdx.x % G : threadIdx.x;
  const int rg = persist ? threadIdx.x / G : 0;
  const bool active = rg < RG && tg0 < G;
  Acc<kT, kLead> acc;
  acc.reset();
  Targets<kT> mine;
  if (persist && active) mine.load(tb, dv, tg0, B);

  for (int p0 = r0; p0 < r1; p0 += tile) {
    const int nrows = min(tile, r1 - p0);
    stage_tile<kAlw, kCG>(a, tl, p0, nrows);
    async_wait();
    for (int r = threadIdx.x; r < nrows; r += kThreads) ts.akey[r] = 0xffffffffu;
    if (threadIdx.x == 0) ts.ncell = 0;
    __syncthreads();  // the tile, the keys' reset and the caller's table
    row_pass<kAlw, kColo, kLead>(a, tb, dv, ts, tl, p0, nrows, keys);
    __syncthreads();
    const int n = list_live<kLead>(ts, nrows);
    const uint8_t* lst = ts.live[threadIdx.x / 32];
    if (active) {
      if (persist) {
        scan_targets<kAlw, kColo, kLead, kT>(acc, mine, ts, lst, n, rg, RG,
                                             tl, a, dv, tb.lam, p0);
      } else {
        for (int g = tg0; g < G; g += kThreads) {
          Targets<kT> tgs;
          tgs.load(tb, dv, g, B);
          Acc<kT, kLead> part;
          part.reset();
          scan_targets<kAlw, kColo, kLead, kT>(part, tgs, ts, lst, n, 0, 1,
                                               tl, a, dv, tb.lam, p0);
          part.flush(tgs, bkeys, B);
        }
      }
    }
    __syncthreads();  // this tile's buffer and terms are free
  }
  if (persist && active) acc.flush(mine, bkeys, B);
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * B; j += kThreads) {
    const unsigned long long k = bkeys[j];
    if (k != kEmpty) atomicMin(&keys[j], k);
  }
}

}  // namespace score
