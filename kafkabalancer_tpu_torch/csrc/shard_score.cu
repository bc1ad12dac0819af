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
// ~11 us at 3.35 TB/s. In practice latency and the instruction rate bind
// first: every (row, target) cell is a division by avg and ~20 more
// instructions, and the rest is a chain of dependent shared-memory and
// atomic round trips.
//
// Design (the block's body is score::score_rows in score_tile.cuh, which
// the whole-session kernel pallas_session.cu runs too):
// - As many blocks as fit the card at once (the occupancy, with registers
//   bounded so that four blocks fit an SM), each taking a contiguous chunk
//   of rows, a multiple of 16, that it walks in tiles of up to 64 rows;
//   each block stages the broker vectors and builds the hot-broker ->
//   pair-column chain once for all its tiles.
// - A tile's member (and allowed) rows are one contiguous run of bytes; the
//   block copies them, the row columns and the replica rows into shared
//   memory with cp.async (16 bytes a thread at a time).
// - Row pass, by the whole block: each thread takes 16-byte chunks of the
//   tile's member bytes and lists the member cells it finds (a warp prefix
//   and one shared atomicAdd per warp); after a barrier every thread works
//   about one listed cell: a source cell (a member broker of an eligible
//   row, not its leader) joins its row's A* through a 32-bit shared
//   atomicMin (NaN as the least key, so a NaN source makes A* NaN), and its
//   pair candidates (a pair column's hot broker must hold one of the row's
//   replicas, found through the chain) go straight to the device keys (a
//   reduction nobody waits for). One thread per row adds the leader term
//   A_l and its pair candidates.
// - Every warp lists the tile's live rows (finite A*, or A_l with leaders)
//   in ascending order; dead rows (padding, ineligible rows) are skipped.
// - Target pass: every thread takes kT adjacent target brokers (2 up to
//   B = 128, 4 above) and a row group, and walks its share of the live rows
//   in ascending order with a strict <; one read of kT mask bytes and of
//   the row's terms serves kT cells; the division's range is tested once
//   per row. The running minima stay in registers across all the block's
//   tiles and go to the block's keys once (shared atomicMin on the packed
//   key merges the row groups exactly).
// - Division: avg is one scalar per launch, so a cell's x / avg is RN(x*y)
//   corrected by one FMA step with y = RN(1/avg) (score::quot), the IEEE
//   division where the correction's conditions do not hold.
// - The block offers each of its target keys once to the device keys
//   through a 64-bit atomicMin on (order-preserving value bits << 32 | row): the
//   lexicographic (value, row) minimum, which is what a strict-< scan over
//   ascending rows computes, in any order of arrival. No float atomics; two
//   launches on the same inputs give the same bits. Block i offers to copy
//   i % kKeyCopies of the keys, which spreads concurrent blocks' atomics
//   over more L2 lines; the last block to finish folds the copies and
//   unpacks them into the outputs, so a call is one memset and one kernel
//   launch.
// - The kernel is specialised on the allowed mask, the colocation counts,
//   the leader pass and kT, so the row loops test no option that is off.
// Each of these choices was measured against its alternative in one call
// (scripts/kernel_ab.py, PERF.md).
// The TPU kernel's one-hot [B, B2] matmul column selection, its every-step
// dead writes and its int32 grid index maps are Mosaic workarounds and are
// not carried over: pair columns arrive as (s_i, t_i, live) indices.
//
// Exactness:
// - Build with --fmad=false and without --use_fast_math: the plain version
//   rounds rel*rel*h - F and A* + C after every operation. Explicit
//   __fmaf_rn in score::quot is the division's correction step, not a
//   contraction: its result is the IEEE quotient (held against __fdiv_rn
//   for every finite float32 x at each avg a chip_smoke.py run meets).
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

// target brokers per thread in the target pass: 2 up to this broker
// bucket, 4 above
constexpr int kTgt2MaxB = 128;
// blocks per SM the register allocation must allow
constexpr int kMinBlocks = 4;

struct Args {
  score::Rows rows;
  const float* loads;       // [B]
  const float* F;           // [B]
  const uint8_t* bvalid;    // [B]
  const float* scal;        // [3]: avg | min_replicas | lambda
  const int32_t* s_i;       // [B2]
  const int32_t* t_i;       // [B2]
  const uint8_t* live;      // [B2]
  int chunk, tile;          // score::split_rows
};

struct Outs {
  float *vf, *vl, *vpf, *vpl;
  int32_t *pf, *pl, *ppf, *ppl;
};

// One chunk of rows per block (score::score_rows), then the last block to
// finish folds the key copies into the outputs. `keys` holds kKeyCopies key
// arrays; `done` counts finished blocks; keys and done start as all-ones
// bytes.
template <bool kAlw, bool kColo, bool kLead, int kTgt>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
score_blocks(Args a, unsigned long long* keys, unsigned int* done, Outs o) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ score::TileShared ts;
  __shared__ bool s_last;

  const int B = a.rows.B, B2 = a.rows.B2;
  const int ncol = score::key_columns(B, B2);

  // dynamic shared memory (dyn_smem_bytes): score_rows' work area (the
  // block's target keys, the tile buffer) | head [B] | next [B2] | t_i [B2] |
  // loads [B] | F [B] | bvalid [B]
  int32_t* s_head = reinterpret_cast<int32_t*>(
      s_dyn + score::work_bytes(a.tile, B, a.rows.R, kAlw));
  int32_t* s_next = s_head + B;
  int32_t* s_t = s_next + B2;
  float* s_loads = reinterpret_cast<float*>(s_t + B2);
  float* s_F = s_loads + B;
  uint8_t* s_bvalid = reinterpret_cast<uint8_t*>(s_F + B);

  // a local copy: a reference to the kernel parameter would move it to
  // local memory
  const score::Rows rows = a.rows;
  const int r0 = blockIdx.x * a.chunk;
  const int r1 = min(rows.P, r0 + a.chunk);
  const float avg = a.scal[0], minrep = a.scal[1], lam = a.scal[2];
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

  const score::Table tb{s_loads, s_F, s_bvalid, s_head, s_next, s_t,
                        avg, minrep, lam};
  score::score_rows<kAlw, kColo, kLead, false, kTgt>(
      rows, tb, ts, s_dyn, a.tile, r0, r1,
      keys + (blockIdx.x % kKeyCopies) * ncol);

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
    unsigned long long k = __ldcg(&keys[j]);
    for (int copy = 1; copy < kKeyCopies; ++copy) {
      k = min(k, __ldcg(&keys[copy * ncol + j]));
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

// score_blocks' dynamic shared memory
int dyn_smem_bytes(int tile, int B, int B2, int R, bool has_allowed) {
  return score::work_bytes(tile, B, R, has_allowed) + 4 * (B + 2 * B2) +
         9 * B;
}

template <bool kAlw, bool kColo, bool kLead, int kTgt>
cudaError_t launch_blocks(Args a, unsigned long long* keys,
                          unsigned int* done, const Outs& o, int n_sm,
                          cudaStream_t st) {
  auto kernel = score_blocks<kAlw, kColo, kLead, kTgt>;
  const int B = a.rows.B, B2 = a.rows.B2;
  const int max_rows = score::max_tile(B, a.rows.R, kAlw);
  const int smem = dyn_smem_bytes(max_rows, B, B2, a.rows.R, kAlw);
  // blocks per SM at this shared memory size, asked once per size
  static int cached_smem = -1, cached_per_sm = 0;
  if (smem != cached_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_per_sm = per_sm;
    cached_smem = smem;
  }
  const score::Split sp =
      score::split_rows(a.rows.P, cached_per_sm * n_sm, max_rows);
  a.chunk = sp.chunk;
  a.tile = sp.tile;
  kernel<<<sp.blocks, kThreads, smem, st>>>(a, keys, done, o);
  return cudaGetLastError();
}

using LaunchBlocks = cudaError_t (*)(Args, unsigned long long*,
                                     unsigned int*, const Outs&, int,
                                     cudaStream_t);
// indexed by (B > kTgt2MaxB) << 3 | allowed << 2 | colocation << 1 | leader
const LaunchBlocks kLaunchBlocks[16] = {
    launch_blocks<false, false, false, 2>, launch_blocks<false, false, true, 2>,
    launch_blocks<false, true, false, 2>,  launch_blocks<false, true, true, 2>,
    launch_blocks<true, false, false, 2>,  launch_blocks<true, false, true, 2>,
    launch_blocks<true, true, false, 2>,   launch_blocks<true, true, true, 2>,
    launch_blocks<false, false, false, 4>, launch_blocks<false, false, true, 4>,
    launch_blocks<false, true, false, 4>,  launch_blocks<false, true, true, 4>,
    launch_blocks<true, false, false, 4>,  launch_blocks<true, false, true, 4>,
    launch_blocks<true, true, false, 4>,   launch_blocks<true, true, true, 4>,
};

// For each avgs[j]: how many finite float32 x give a score::quot(x, avg)
// whose bits differ from __fdiv_rn(x, avg), into bad[j] (zeroed first).
// Grid: (blocks over x, one row per avg).
__global__ void __launch_bounds__(kThreads)
div_check(const float* avgs, unsigned long long* bad) {
  const score::Div d = score::make_div(avgs[blockIdx.y]);
  unsigned int mine = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long u = blockIdx.x * kThreads + threadIdx.x;
       u < (1ull << 32); u += stride) {
    const float x = __uint_as_float(static_cast<unsigned int>(u));
    if (!isfinite(x)) continue;
    mine += __float_as_uint(score::quot(x, d)) !=
            __float_as_uint(__fdiv_rn(x, d.avg));
  }
  for (int off = 16; off > 0; off >>= 1) {
    mine += __shfl_xor_sync(0xffffffffu, mine, off);
  }
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&bad[blockIdx.y], mine);
}

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
  Args a{{replicas, cols, member, allowed, crows, P, R, B, B2},
         loads, F, bvalid, scal, s_i, t_i, live, 0, 0};
  Outs o{vf, vl, vpf, vpl, pf, pl, ppf, ppl};
  const int variant = (B > kTgt2MaxB ? 8 : 0) | (allowed ? 4 : 0) |
                      (crows ? 2 : 0) | (allow_leader ? 1 : 0);
  return static_cast<int>(kLaunchBlocks[variant](
      a, scratch, reinterpret_cast<unsigned int*>(scratch + words - 1), o,
      n_sm, st));
}

// The division check: bad[j] = the number of finite float32 x whose
// reciprocal-based quotient (score::quot) differs from the IEEE x / avgs[j],
// for j < n. Returns the first CUDA error; nothing is synchronised.
int shard_score_div_check(const float* avgs, int n, unsigned long long* bad,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(*bad) * n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  for (int j0 = 0; j0 < n; j0 += 65535) {
    const int rows = n - j0 < 65535 ? n - j0 : 65535;
    div_check<<<dim3(8 * n_sm, rows), kThreads, 0, st>>>(avgs + j0, bad + j0);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* shard_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
