// shard_score: the converge session's scoring pass on Hopper (sm_90a).
//
// Replaces kafkabalancer_tpu/parallel/shard_kernel.py:_kernel, the Pallas
// TPU kernel behind shard_score. For every target broker it finds the
// follower and the leader minimum over partition rows of the rank-1
// objective A*[p] + C[p, t] (lowest row wins ties), and for every hot/cold
// pair column the follower and leader minimum of A[p, s] + C[p, t], with
// the optional anti-colocation +/-lambda terms. Bit-exact against the plain
// torch version (shard_score_plain) at float32.
//
// What bounds it on an H100: by bytes, memory. A launch reads the [P, B]
// member mask (1 byte each), the [P, B] allowed mask unless every broker
// is allowed, the [P, B] float32 colocation counts when that objective is
// on, the [P, 5] float32 row columns and the [P, R] replicas: about P*B +
// P*(4R + 20) bytes on the main path, ~38 MB at 131072 x 256 with R = 4,
// ~11 us at 3.35 TB/s. In practice the issue rate binds first: every
// (row, target) cell costs an IEEE division (overload_penalty divides by
// avg, and exactness rules out a reciprocal) and ~30 instructions.
//
// Design:
// - One block per tile of rows. The tile's member (and allowed) rows are
//   one contiguous run of bytes; the block stages them, the tile's row
//   columns and leaders, and the broker vectors into shared memory with
//   coalesced loads, many in flight. Everything after reads shared memory.
// - One warp per row computes the row's source minima (A*, A_l) and, on
//   the way, every pair candidate of the row: a pair column's hot broker
//   must hold one of the row's replicas, so a row has at most R pair
//   candidates, found through a hot-broker -> pair-column chain that each
//   block builds in shared memory. The row's few source cells are marked
//   in per-lane bit masks first and then worked one per lane, so the warp
//   runs the source work about once per row, not once per 32 columns.
// - Then one thread per target broker scans the tile's rows in ascending
//   order with a strict < and keeps (min, lowest row); its loop body has
//   no branch (every cell is computed, a predicate decides whether it
//   counts), so unrolled rows overlap. This loop is the issue-bound part.
// - Tiles shrink when P is small so that every SM gets several blocks.
// - Candidates meet through 64-bit atomicMin on (order-preserving value
//   bits << 32 | row): the lexicographic (value, row) minimum, which is
//   what a strict-< scan over ascending rows computes, in any order of
//   arrival. No float atomics; two launches on the same inputs give the
//   same bits. Block i offers to copy i % kKeyCopies of the keys, which
//   spreads concurrent blocks' atomics over more L2 lines; the last block
//   to finish folds the copies and unpacks them into the outputs, so a
//   call is one memset and one kernel launch.
// - The kernel is specialised on the allowed mask, the colocation counts
//   and the leader pass, so the row loops test no option that is off.
// The TPU kernel's one-hot [B, B2] matmul column selection, its every-step
// dead writes and its int32 grid index maps are Mosaic workarounds and are
// not carried over: pair columns arrive as (s_i, t_i, live) indices.
//
// Exactness:
// - Build with --fmad=false and without --use_fast_math: the plain version
//   rounds rel*rel*h - F and A* + C after every operation, and
//   overload_penalty divides by avg (IEEE division).
// - -0.0 is packed as +0.0 (strict < treats them as equal, so the lowest
//   row must win between them too).
// - A NaN candidate never wins (strict < is false); a NaN among a row's
//   sources makes A* NaN, which excludes the row exactly like the plain
//   version's NaN-propagating min. A column with no candidate returns
//   (+inf, 0).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 128;  // partition rows per block, at most
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaskBudget = 96 * 1024;  // staged mask bytes per block
constexpr int kBlocksPerSm = 8;  // tiles shrink until the grid has these
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

// copy n bytes from device memory into shared memory, 16 at a time where
// the source is aligned (dst is 16-byte aligned)
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = n / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n16; i += kThreads) d4[i] = s4[i];
    done = n16 * 16;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

struct Args {
  const int32_t* replicas;  // [P, R]
  const float* cols;        // [P, 5]: w | ncur | ntgt | ncons | pvalid
  const uint8_t* member;    // [P, B]
  const uint8_t* allowed;   // [P, B] or null (every broker allowed)
  const float* crows;       // [P, B] or null (no colocation terms)
  const float* loads;       // [B]
  const float* F;           // [B]
  const uint8_t* bvalid;    // [B]
  const float* scal;        // [3]: avg | min_replicas | lambda
  const int32_t* s_i;       // [B2]
  const int32_t* t_i;       // [B2]
  const uint8_t* live;      // [B2]
  int P, R, B, B2, tile;
};

struct Outs {
  float *vf, *vl, *vpf, *vpl;
  int32_t *pf, *pl, *ppf, *ppl;
};

// Key columns, ncol = 2B + 2*B2: [0, B) follower target | [B, 2B) leader
// target | [2B, 2B+B2) follower pair | [2B+B2, 2B+2*B2) leader pair.
// `keys` holds kKeyCopies such arrays; `done` counts finished blocks; keys
// and done start as all-ones bytes.
template <bool kAlw, bool kColo, bool kLead>
__global__ void __launch_bounds__(kThreads)
score_tiles(Args a, unsigned long long* keys, unsigned int* done, Outs o) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ float s_cols[kMaxTile * 5];
  __shared__ float s_astar[kMaxTile];  // follower source minimum A*
  __shared__ float s_al[kMaxTile];     // leader source term A_l
  __shared__ float s_w[kMaxTile];      // follower delta w
  __shared__ float s_wl[kMaxTile];     // leader delta w*(ncur+ncons)
  __shared__ int32_t s_lead[kMaxTile];
  __shared__ bool s_last;

  const int B = a.B, B2 = a.B2;
  const int p0 = blockIdx.x * a.tile;
  const int nrows = max(0, min(a.tile, a.P - p0));
  const float avg = a.scal[0], minrep = a.scal[1], lam = a.scal[2];
  const float inf = INFINITY;
  const int ncol = 2 * B + 2 * B2;
  unsigned long long* const all_keys = keys;
  keys += (blockIdx.x % kKeyCopies) * ncol;
  unsigned long long* const keys_pf = keys + 2 * B;
  unsigned long long* const keys_pl = keys + 2 * B + B2;

  // dynamic shared memory (dyn_smem_bytes): member rows | allowed rows |
  // head [B] | next [B2] | t_i [B2] | loads [B] | F [B] | bvalid [B]
  const int mask_bytes = round16(a.tile * B);
  uint8_t* s_mem = s_dyn;
  uint8_t* s_alw = s_dyn + mask_bytes;
  // a live pair column per hot broker, and the next one with the same
  int32_t* s_head =
      reinterpret_cast<int32_t*>(s_dyn + mask_bytes * (kAlw ? 2 : 1));
  int32_t* s_next = s_head + B;
  int32_t* s_t = s_next + B2;
  float* s_loads = reinterpret_cast<float*>(s_t + B2);
  float* s_F = s_loads + B;
  uint8_t* s_bvalid = reinterpret_cast<uint8_t*>(s_F + B);

  stage(s_mem, a.member + (size_t)p0 * B, nrows * B);
  if (kAlw) stage(s_alw, a.allowed + (size_t)p0 * B, nrows * B);
  for (int i = threadIdx.x; i < nrows * 5; i += kThreads) {
    s_cols[i] = a.cols[(size_t)p0 * 5 + i];
  }
  for (int i = threadIdx.x; i < nrows; i += kThreads) {
    s_lead[i] = a.replicas[(size_t)(p0 + i) * a.R];
  }
  for (int b = threadIdx.x; b < B; b += kThreads) {
    s_head[b] = -1;
    s_loads[b] = a.loads[b];
    s_F[b] = a.F[b];
    s_bvalid[b] = a.bvalid[b];
  }
  for (int c = threadIdx.x; c < B2; c += kThreads) s_t[c] = a.t_i[c];
  __syncthreads();
  // chain the live pair columns by hot broker; the order within a chain is
  // free: every column of a chain is offered the same candidates, and the
  // keys' minimum does not depend on the order of the offers
  for (int c = threadIdx.x; c < B2; c += kThreads) {
    const int s = a.s_i[c];
    if (a.live[c] && s >= 0 && s < B) s_next[c] = atomicExch(&s_head[s], c);
  }
  __syncthreads();

  // ---- per row (one warp each): the source minima A* and A_l, and every
  // pair candidate, offered straight to its key -------------------------
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nrows; r += kWarps) {
    const int p = p0 + r;
    const float* c = s_cols + r * 5;
    const float w = c[0], ncur = c[1], ntgt = c[2], ncons = c[3];
    const bool elig = (c[4] > 0.0f) && (ntgt >= minrep);
    const int lead = s_lead[r];
    const uint8_t* mrow = s_mem + r * B;
    const uint8_t* arow = s_alw + r * B;
    const float* crow = kColo ? a.crows + (size_t)p * B : nullptr;
    // the pair target term at broker t, or +inf where t takes no move
    auto pair_target = [&](int t, float delta) {
      if (!s_bvalid[t] || mrow[t] || (kAlw && !arow[t])) return inf;
      float C = penalty(s_loads[t] + delta, avg) - s_F[t];
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
        float A = penalty(s_loads[b] - w, avg) - s_F[b];
        if (kColo) A = A - colo_sub(crow[b], lam);
        if (isnan(A)) has_nan = 1;
        else if (A < m) m = A;
        for (int pc = s_head[b]; pc >= 0; pc = s_next[pc]) {
          offer(&keys_pf[pc], A + pair_target(s_t[pc], w), p);
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
        al = penalty(s_loads[lead] - wl, avg) - s_F[lead];
        if (kColo) al = al - colo_sub(crow[lead], lam);
        for (int pc = s_head[lead]; pc >= 0; pc = s_next[pc]) {
          offer(&keys_pl[pc], al + pair_target(s_t[pc], wl), p);
        }
      }
      s_astar[r] = has_nan ? NAN : m;
      s_al[r] = al;
      s_w[r] = w;
      s_wl[r] = wl;
    }
  }
  __syncthreads();

  // ---- per target broker (one thread each): every cell is computed and a
  // predicate decides whether it counts, so the loop body has no branch;
  // ascending rows with a strict < keep the lowest row of a tie ----------
  for (int b = threadIdx.x; b < B; b += kThreads) {
    if (!s_bvalid[b]) continue;
    const float Lb = s_loads[b], Fb = s_F[b];
    float vf = inf, vl = inf;
    int rf = 0, rl = 0;
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
      const int cell = r * B + b;
      const bool ok = !s_mem[cell] && (!kAlw || s_alw[cell]);
      const float add =
          kColo ? colo_add(a.crows[(size_t)p0 * B + cell], lam) : 0.0f;
      const float as = s_astar[r];
      float C = penalty(Lb + s_w[r], avg) - Fb;
      if (kColo) C = C + add;
      const float v = as + C;
      const bool take = ok && isfinite(as) && v < vf;
      vf = take ? v : vf;
      rf = take ? p0 + r : rf;
      if (kLead) {
        const float al = s_al[r];
        float Cl = penalty(Lb + s_wl[r], avg) - Fb;
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

  // ---- the last block to finish unpacks the keys --------------------------
  __threadfence();  // this block's offers before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    // done starts at ~0u (all-ones bytes), so the n-th finisher reads n - 2
    s_last = atomicAdd(done, 1u) + 2u == gridDim.x;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // every block's offers before the reads
  for (int j = threadIdx.x; j < ncol; j += kThreads) {
    unsigned long long k = __ldcg(&all_keys[j]);
    for (int copy = 1; copy < kKeyCopies; ++copy) {
      k = min(k, __ldcg(&all_keys[copy * ncol + j]));
    }
    float v;
    int32_t r;
    unpack(k, v, r);
    if (j < B) {
      o.vf[j] = v; o.pf[j] = r;
    } else if (j < 2 * B) {
      o.vl[j - B] = v; o.pl[j - B] = r;
    } else if (j < 2 * B + B2) {
      o.vpf[j - 2 * B] = v; o.ppf[j - 2 * B] = r;
    } else {
      o.vpl[j - 2 * B - B2] = v; o.ppl[j - 2 * B - B2] = r;
    }
  }
}

// rows per tile: the largest power of two up to kMaxTile that still gives
// every SM kBlocksPerSm blocks (down to 16 rows), within the mask budget
int tile_rows(int P, int B, bool has_allowed, int n_sm) {
  int tile = kMaxTile;
  while (tile > 16 && (P + tile - 1) / tile < kBlocksPerSm * n_sm) tile /= 2;
  const int per_row = B * (has_allowed ? 2 : 1);
  while (tile > 1 && tile * per_row > kMaskBudget) tile /= 2;
  return tile;
}

// score_tiles' dynamic shared memory
int dyn_smem_bytes(int tile, int B, int B2, bool has_allowed) {
  return round16(tile * B) * (has_allowed ? 2 : 1) + 4 * (B + 2 * B2) +
         9 * B;
}

template <bool kAlw, bool kColo, bool kLead>
cudaError_t launch_tiles(const Args& a, unsigned long long* keys,
                         unsigned int* done, const Outs& o, int smem,
                         cudaStream_t st) {
  auto kernel = score_tiles<kAlw, kColo, kLead>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = a.P > 0 ? (a.P + a.tile - 1) / a.tile : 1;
  kernel<<<blocks, kThreads, smem, st>>>(a, keys, done, o);
  return cudaGetLastError();
}

using LaunchTiles = cudaError_t (*)(const Args&, unsigned long long*,
                                    unsigned int*, const Outs&, int,
                                    cudaStream_t);
// indexed by allowed << 2 | colocation << 1 | leader
const LaunchTiles kLaunchTiles[8] = {
    launch_tiles<false, false, false>, launch_tiles<false, false, true>,
    launch_tiles<false, true, false>,  launch_tiles<false, true, true>,
    launch_tiles<true, false, false>,  launch_tiles<true, false, true>,
    launch_tiles<true, true, false>,   launch_tiles<true, true, true>,
};

}  // namespace

extern "C" {

// 64-bit words of scratch a launch needs: the key copies, then the
// finished-block count.
long long shard_score_scratch_words(int B, int B2) {
  return static_cast<long long>(kKeyCopies) * (2 * B + 2 * B2) + 1;
}

// Launch the pass on `stream` with shard_score_scratch_words(B, B2) words
// of `scratch`. Returns the first CUDA error (0 = cudaSuccess); nothing is
// synchronised.
int shard_score_launch(
    const int32_t* replicas, const float* cols, const uint8_t* member,
    const uint8_t* allowed, const float* crows, const float* loads,
    const float* F, const uint8_t* bvalid, const float* scal,
    const int32_t* s_i, const int32_t* t_i, const uint8_t* live,
    int P, int R, int B, int B2, int allow_leader,
    unsigned long long* scratch,
    float* vf, int32_t* pf, float* vl, int32_t* pl,
    float* vpf, int32_t* ppf, float* vpl, int32_t* ppl,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long words = shard_score_scratch_words(B, B2);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0xFF, sizeof(*scratch) * words, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tile = tile_rows(P, B, allowed != nullptr, n_sm);
  const int smem = dyn_smem_bytes(tile, B, B2, allowed != nullptr);
  Args a{replicas, cols, member, allowed, crows, loads, F, bvalid, scal,
         s_i, t_i, live, P, R, B, B2, tile};
  Outs o{vf, vl, vpf, vpl, pf, pl, ppf, ppl};
  const int variant = (allowed ? 4 : 0) | (crows ? 2 : 0) |
                      (allow_leader ? 1 : 0);
  return static_cast<int>(kLaunchTiles[variant](
      a, scratch, reinterpret_cast<unsigned int*>(scratch + words - 1), o, smem,
      st));
}

const char* shard_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
