// score_tile.cuh: one tile of the converge session's scoring pass, shared by
// the scoring kernel (shard_score.cu) and the whole-session kernel
// (pallas_session.cu).
//
// A tile is a run of partition rows. For every target broker the tile
// offers its follower and leader minimum of A*[p] + C[p, t] (lowest row wins
// ties), and for every live hot/cold pair column the follower and leader
// minimum of A[p, s] + C[p, t], to 64-bit keys through atomicMin on
// (order-preserving value bits << 32 | row): the lexicographic (value, row)
// minimum, which is what a strict-< scan over ascending rows computes, in
// any order of arrival. See shard_score.cu for the design and exactness
// notes; this file holds the code both kernels run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace score {

constexpr int kMaxTile = 128;  // partition rows per tile, at most
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaskBudget = 96 * 1024;  // staged mask bytes per block
constexpr unsigned long long kEmpty = ~0ull;  // no candidate yet
// copies of the key array; block i offers to copy i % kKeyCopies, so the
// atomics of concurrent blocks land on different L2 lines
constexpr int kKeyCopies = 16;

__device__ __forceinline__ float penalty(float load, float avg) {
  // cost.overload_penalty: rel^2 if overloaded else rel^2 / 2
  float rel = load / avg - 1.0f;
  return rel * rel * (rel > 0.0f ? 1.0f : 0.5f);
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

// copy n bytes from device memory into shared memory, 16 at a time where
// the source is aligned (dst is 16-byte aligned)
template <bool kCG>
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = n / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n16; i += kThreads) d4[i] = load<kCG>(s4 + i);
    done = n16 * 16;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) {
    dst[i] = load<kCG>(src + i);
  }
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// rows per tile: the largest power of two up to kMaxTile that still gives
// every SM blocks_per_sm tiles (down to 16 rows), within the mask budget
inline int tile_rows(int P, int B, bool has_allowed, int n_sm,
                     int blocks_per_sm) {
  int tile = kMaxTile;
  while (tile > 16 && (P + tile - 1) / tile < blocks_per_sm * n_sm) tile /= 2;
  const int per_row = B * (has_allowed ? 2 : 1);
  while (tile > 1 && tile * per_row > kMaskBudget) tile /= 2;
  return tile;
}

// bytes of the staged member (and allowed) rows of one tile
__host__ __device__ __forceinline__ int mask_bytes(int tile, int B,
                                                   bool has_allowed) {
  return round16(tile * B) * (has_allowed ? 2 : 1);
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

// the tile's staged rows and per-row terms, in shared memory
struct TileShared {
  float cols[kMaxTile * 5];
  float astar[kMaxTile];  // follower source minimum A*
  float al[kMaxTile];     // leader source term A_l
  float w[kMaxTile];      // follower delta w
  float wl[kMaxTile];     // leader delta w*(ncur+ncons)
  int32_t lead[kMaxTile];
};

// Key columns, ncol = 2B + 2*B2: [0, B) follower target | [B, 2B) leader
// target | [2B, 2B+B2) follower pair | [2B+B2, 2B+2*B2) leader pair.
__host__ __device__ __forceinline__ int key_columns(int B, int B2) {
  return 2 * B + 2 * B2;
}

// The tile's rows, rows [p0, p0 + nrows), into shared memory: the member
// (and allowed) bytes into `s_mem` (`s_alw`), mask_bytes(tile, ...) bytes
// of 16-byte aligned shared memory, and the row columns and leaders into
// `ts`. Starts the loads only: a barrier must follow before score_staged.
template <bool kAlw, bool kCG>
__device__ __forceinline__ void stage_tile(const Rows& a, TileShared& ts,
                                           uint8_t* s_mem, uint8_t* s_alw,
                                           int p0, int nrows) {
  const int B = a.B;
  stage<kCG>(s_mem, a.member + (size_t)p0 * B, nrows * B);
  if (kAlw) stage<kCG>(s_alw, a.allowed + (size_t)p0 * B, nrows * B);
  for (int i = threadIdx.x; i < nrows * 5; i += kThreads) {
    ts.cols[i] = a.cols[(size_t)p0 * 5 + i];
  }
  for (int i = threadIdx.x; i < nrows; i += kThreads) {
    ts.lead[i] = load<kCG>(a.replicas + (size_t)(p0 + i) * a.R);
  }
}

// Score the staged rows [p0, p0 + nrows) and offer their candidates to
// `keys` (one key array of key_columns(B, B2) words). Called by every
// thread of the block after the barrier that follows stage_tile and the
// table; a barrier must follow before the staging buffers are reused.
template <bool kAlw, bool kColo, bool kLead>
__device__ __forceinline__ void score_staged(
    const Rows& a, const Table& tb, TileShared& ts, const uint8_t* s_mem,
    const uint8_t* s_alw, int p0, int nrows, unsigned long long* keys) {
  const int B = a.B, B2 = a.B2;
  const float avg = tb.avg, minrep = tb.minrep, lam = tb.lam;
  const float inf = INFINITY;
  unsigned long long* const keys_pf = keys + 2 * B;
  unsigned long long* const keys_pl = keys + 2 * B + B2;

  // ---- per row (one warp each): the source minima A* and A_l, and every
  // pair candidate, offered straight to its key -------------------------
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nrows; r += kWarps) {
    const int p = p0 + r;
    const float* c = ts.cols + r * 5;
    const float w = c[0], ncur = c[1], ntgt = c[2], ncons = c[3];
    const bool elig = (c[4] > 0.0f) && (ntgt >= minrep);
    const int lead = ts.lead[r];
    const uint8_t* mrow = s_mem + r * B;
    const uint8_t* arow = s_alw + r * B;
    const float* crow = kColo ? a.crows + (size_t)p * B : nullptr;
    // the pair target term at broker t, or +inf where t takes no move
    auto pair_target = [&](int t, float delta) {
      if (!tb.bvalid[t] || mrow[t] || (kAlw && !arow[t])) return inf;
      float C = penalty(tb.loads[t] + delta, avg) - tb.F[t];
      if (kColo) C = C + colo_add(crow[t], lam);
      return C;
    };
    float m = inf;
    int has_nan = 0;
    // the row's source cells (member brokers but the leader), a few per
    // row: each lane marks its own in a bit mask, then every pass takes one
    // per lane, so the warp runs the source work about once per row
    for (int base = 0; elig && base < B; base += 32 * 32) {
      unsigned int mine = 0;
      for (int k = 0; k < 32 && base + 32 * k < B; ++k) {
        const int b = base + 32 * k + lane;
        if (b < B && mrow[b] && b != lead) mine |= 1u << k;
      }
      while (__any_sync(0xffffffffu, mine != 0)) {
        if (mine == 0) continue;
        const int b = base + 32 * (__ffs(mine) - 1) + lane;
        mine &= mine - 1;
        float A = penalty(tb.loads[b] - w, avg) - tb.F[b];
        if (kColo) A = A - colo_sub(crow[b], lam);
        if (isnan(A)) has_nan = 1;
        else if (A < m) m = A;
        for (int pc = tb.head[b]; pc >= 0; pc = tb.next[pc]) {
          offer(&keys_pf[pc], A + pair_target(tb.t[pc], w), p);
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, m, off);
      m = o < m ? o : m;
      has_nan |= __shfl_xor_sync(0xffffffffu, has_nan, off);
    }
    if (lane == 0) {
      const float wl = w * (ncur + ncons);
      float al = inf;
      if (kLead && ncur >= 1.0f && elig && lead >= 0 && lead < B) {
        al = penalty(tb.loads[lead] - wl, avg) - tb.F[lead];
        if (kColo) al = al - colo_sub(crow[lead], lam);
        for (int pc = tb.head[lead]; pc >= 0; pc = tb.next[pc]) {
          offer(&keys_pl[pc], al + pair_target(tb.t[pc], wl), p);
        }
      }
      ts.astar[r] = has_nan ? NAN : m;
      ts.al[r] = al;
      ts.w[r] = w;
      ts.wl[r] = wl;
    }
  }
  __syncthreads();

  // ---- per target broker (one thread each): every cell is computed and a
  // predicate decides whether it counts, so the loop body has no branch;
  // ascending rows with a strict < keep the lowest row of a tie ----------
  for (int b = threadIdx.x; b < B; b += kThreads) {
    if (!tb.bvalid[b]) continue;
    const float Lb = tb.loads[b], Fb = tb.F[b];
    float vf = inf, vl = inf;
    int rf = 0, rl = 0;
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      const int cell = r * B + b;
      const bool ok = !s_mem[cell] && (!kAlw || s_alw[cell]);
      const float add =
          kColo ? colo_add(a.crows[(size_t)p0 * B + cell], lam) : 0.0f;
      const float as = ts.astar[r];
      float C = penalty(Lb + ts.w[r], avg) - Fb;
      if (kColo) C = C + add;
      const float v = as + C;
      const bool take = ok && isfinite(as) && v < vf;
      vf = take ? v : vf;
      rf = take ? p0 + r : rf;
      if (kLead) {
        const float al = ts.al[r];
        float Cl = penalty(Lb + ts.wl[r], avg) - Fb;
        if (kColo) Cl = Cl + add;
        const float vl_r = al + Cl;
        const bool take_l = ok && isfinite(al) && vl_r < vl;
        vl = take_l ? vl_r : vl;
        rl = take_l ? p0 + r : rl;
      }
    }
    offer(&keys[b], vf, rf);
    if (kLead) offer(&keys[B + b], vl, rl);
  }
}

}  // namespace score
