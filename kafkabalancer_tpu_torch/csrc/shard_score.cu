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
// Design (the tile body is score::stage_tile and score::score_staged in
// score_tile.cuh, which the whole-session kernel pallas_session.cu runs
// too):
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

#include "score_tile.cuh"

namespace {

using score::kKeyCopies;
using score::kThreads;

constexpr int kBlocksPerSm = 8;  // tiles shrink until the grid has these

struct Args {
  score::Rows rows;
  const float* loads;       // [B]
  const float* F;           // [B]
  const uint8_t* bvalid;    // [B]
  const float* scal;        // [3]: avg | min_replicas | lambda
  const int32_t* s_i;       // [B2]
  const int32_t* t_i;       // [B2]
  const uint8_t* live;      // [B2]
  int tile;
};

struct Outs {
  float *vf, *vl, *vpf, *vpl;
  int32_t *pf, *pl, *ppf, *ppl;
};

// One tile per block (score::stage_tile, score::score_staged), then the
// last block to finish folds the key copies into the outputs. `keys` holds
// kKeyCopies key arrays; `done` counts finished blocks; keys and done start
// as all-ones bytes.
template <bool kAlw, bool kColo, bool kLead>
__global__ void __launch_bounds__(kThreads)
score_tiles(Args a, unsigned long long* keys, unsigned int* done, Outs o) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ score::TileShared ts;
  __shared__ bool s_last;

  const int B = a.rows.B, B2 = a.rows.B2;
  const int ncol = score::key_columns(B, B2);
  unsigned long long* const all_keys = keys;
  keys += (blockIdx.x % kKeyCopies) * ncol;

  // dynamic shared memory (dyn_smem_bytes): member rows | allowed rows |
  // head [B] | next [B2] | t_i [B2] | loads [B] | F [B] | bvalid [B]
  const int mask_bytes = score::round16(a.tile * B);
  uint8_t* s_mem = s_dyn;
  uint8_t* s_alw = s_dyn + mask_bytes;
  int32_t* s_head =
      reinterpret_cast<int32_t*>(s_dyn + mask_bytes * (kAlw ? 2 : 1));
  int32_t* s_next = s_head + B;
  int32_t* s_t = s_next + B2;
  float* s_loads = reinterpret_cast<float*>(s_t + B2);
  float* s_F = s_loads + B;
  uint8_t* s_bvalid = reinterpret_cast<uint8_t*>(s_F + B);

  // a local copy: a reference to the kernel parameter would move it to
  // local memory
  const score::Rows rows = a.rows;
  const int p0 = blockIdx.x * a.tile;
  const int nrows = max(0, min(a.tile, rows.P - p0));
  const float avg = a.scal[0], minrep = a.scal[1], lam = a.scal[2];
  score::stage_tile<kAlw, false>(rows, ts, s_mem, s_alw, p0, nrows);
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

  const score::Table tb{s_loads, s_F, s_bvalid, s_head, s_next, s_t,
                        avg, minrep, lam};
  score::score_staged<kAlw, kColo, kLead>(rows, tb, ts, s_mem, s_alw, p0,
                                          nrows, keys);

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
    score::unpack(k, v, r);
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

// score_tiles' dynamic shared memory
int dyn_smem_bytes(int tile, int B, int B2, bool has_allowed) {
  return score::mask_bytes(tile, B, has_allowed) + 4 * (B + 2 * B2) + 9 * B;
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
  const int P = a.rows.P;
  const int blocks = P > 0 ? (P + a.tile - 1) / a.tile : 1;
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
  return static_cast<long long>(kKeyCopies) * score::key_columns(B, B2) + 1;
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
  const int tile =
      score::tile_rows(P, B, allowed != nullptr, n_sm, kBlocksPerSm);
  const int smem = dyn_smem_bytes(tile, B, B2, allowed != nullptr);
  Args a{{replicas, cols, member, allowed, crows, P, R, B, B2},
         loads, F, bvalid, scal, s_i, t_i, live, tile};
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
