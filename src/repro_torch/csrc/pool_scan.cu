// Algorithm 1 all-prefix termination scan for a request batch: kernel B2.
//
// Replaces: src/repro/kernels/pool_scan.py `_pool_scan_kernel` (launched by
// `_pool_scan_pallas`).  On the TPU its (2, nt) grid runs in order: phase 0
// walks the tiles carrying top[k-1], a found flag, k_stop and the winning
// prefix sum in SMEM; phase 1 emits the winning prefix's counts row.
//
// GPU blocks run in no order, so nothing is carried:
//   pool_term_kernel  a (ceil(K/1024), B) grid, one lane per thread.  Each
//                     lane computes its own termination flag.  top[k-1] is
//                     the same expression on csc[k-1], so a lane recomputes
//                     it instead of waiting for a neighbour.  The first
//                     terminating k of a block is found with warp ballots,
//                     and the request's first k over all blocks with one
//                     atomicMax on K - k (the slot starts at 0, which reads
//                     as "none").  Max is order-free, so the result is
//                     deterministic.  A block whose tile starts after a k
//                     already found returns at once.
//   pool_emit_kernel  the same grid: decodes k_stop / k_best / the k = 0
//                     guard as `_finalize` does (pool_scan.py:103-108) and
//                     writes the counts row as `_emit_row` (:111-116).
// The stable sort and the clamped prefix sums stay outside, as they sit
// outside the Pallas kernel in the reference.
//
// Bound on an H100: bytes.  The function must read s, c and csc up to each
// request's first terminating prefix and write the (B, K) int32 counts row,
// with a division per lane and prefix; the counts row dominates.  The design
// reads every operand once per kernel, coalesced, holds the per-request
// scalars in registers and skips tiles past the first termination.
//
// Exactness: --fmad=false, no fast math, IEEE division, and each expression
// keeps the reference's op order, (s * R) / (csc * c).  The float-to-int
// cast is the C cast (cvt.rzi.s32.f32, saturating), which is what PyTorch's
// CUDA `.to(torch.int32)` compiles to, so counts and k_stop equal the plain
// PyTorch version's on the same inputs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 1024;  // lanes per block, one per thread

__device__ __forceinline__ int ceil_i32(float x) { return (int)ceilf(x); }

__global__ void pool_term_kernel(const float* __restrict__ s,
                                 const float* __restrict__ c,
                                 const float* __restrict__ csc,
                                 const float* __restrict__ required,
                                 int* __restrict__ enc, int K) {
  __shared__ int first[TILE / 32];
  __shared__ int skip;
  const int b = blockIdx.y;
  const int base = blockIdx.x * TILE;
  if (threadIdx.x == 0) {
    const int found = *(volatile int*)&enc[b];
    skip = found > 0 && K - found < base;
  }
  __syncthreads();
  if (skip) return;

  const size_t row = (size_t)b * K;
  const int k = base + threadIdx.x;
  bool term = false;
  if (k < K) {
    const float R = required[b];
    const float s0 = s[row];
    const float c0 = c[row];
    const float cs = csc[row + k];
    const int newest = ceil_i32(s[row + k] * R / (cs * c[row + k]));
    if (k == 0) {
      term = newest == 0;  // x_prev_top = inf at k = 0
    } else {
      const int top = ceil_i32(s0 * R / (cs * c0));
      const int prev = ceil_i32(s0 * R / (csc[row + k - 1] * c0));
      term = top >= prev || newest == 0;
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, term);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) first[warp] = ballot ? warp * 32 + __ffs(ballot) - 1 : TILE;
  __syncthreads();
  if (warp == 0) {
    int v = first[lane];
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0 && v < TILE) atomicMax(&enc[b], K - (base + v));
  }
}

__global__ void pool_emit_kernel(const float* __restrict__ s,
                                 const float* __restrict__ c,
                                 const float* __restrict__ csc,
                                 const float* __restrict__ required,
                                 const int* __restrict__ enc,
                                 int* __restrict__ counts,
                                 int* __restrict__ k_stop,
                                 int* __restrict__ any_term, int K) {
  const int b = blockIdx.y;
  const int e = enc[b];
  const bool found = e > 0;
  const int ks = found ? K - e : 0;
  const int kb = found ? max(ks - 1, 0) : K - 1;
  const bool deg = found && ks == 0;  // termination at k = 0
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    k_stop[b] = ks;
    any_term[b] = found ? 1 : 0;
  }
  const int k = blockIdx.x * TILE + threadIdx.x;
  if (k >= K) return;
  const size_t row = (size_t)b * K;
  const float R = required[b];
  int v = 0;
  if (deg) {
    if (k == 0) v = ceil_i32(R / c[row]);  // single-type pool on the leader
  } else if (k <= kb) {
    v = ceil_i32(s[row + k] * R / (csc[row + kb] * c[row + k]));
  }
  counts[row + k] = v;
}

}  // namespace

// s, c, csc (B, K) float32 in score-descending order; required (B,).
// enc (B,) int32 is scratch.  Writes counts (B, K), k_stop (B,) and
// any_term (B,) as int32.
extern "C" int pool_scan_launch(const float* s, const float* c,
                                const float* csc, const float* required,
                                int* enc, int* counts, int* k_stop,
                                int* any_term, int B, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(enc, 0, sizeof(int) * (size_t)B, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((K + TILE - 1) / TILE, B);
  pool_term_kernel<<<grid, TILE, 0, st>>>(s, c, csc, required, enc, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pool_emit_kernel<<<grid, TILE, 0, st>>>(s, c, csc, required, enc, counts,
                                          k_stop, any_term, K);
  return (int)cudaGetLastError();
}
