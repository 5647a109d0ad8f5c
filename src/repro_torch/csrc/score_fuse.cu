// Masked Eq. 2-4 scoring for a whole request batch: kernel B1 of the port.
//
// Replaces: src/repro/kernels/score_fuse.py `_score_fuse_kernel` (launched by
// `_score_fuse_pallas`), which scores one request per call on a (2, nt) grid
// that runs in order: phase 0 carries seven scalars (masked min/max of area,
// slope, std and the masked C_min) in SMEM across tiles, phase 1 emits rows.
//
// Here the batch is one call of two kernels:
//   score_reduce_kernel  one block per row: U blocks take the six stat
//                        extrema of each unique filter mask, B blocks take
//                        each request's masked C_min = min p * ceil(R / cap).
//   score_emit_kernel    a (ceil(K/256), B) grid, one lane per thread, writes
//                        the combined / availability / cost rows.
// Blocks run in no order on the GPU, so the sequential carry becomes a
// block-level tree reduction; min and max are exact, so the scalars are the
// reference's bit for bit whatever the order.
//
// Bound on an H100: bytes.  Per call the function must read the (3, K)
// statistics, three (K,) catalog rows, the (B, K) and (U, K) byte masks and
// write three (B, K) float rows: about 13 bytes per request lane, against
// a handful of flops per lane.  The design reads each lane's operands once
// per kernel with neighbouring threads on neighbouring addresses, keeps
// every scalar of a request in registers, and never writes an intermediate
// (B, K) array.  The catalog rows and statistics are re-read by every
// request; at K = 32768 they are 0.8 MB and stay in the 50 MB L2.
//
// Exactness: built with --fmad=false and without fast math, so `/` is IEEE
// div.rn and no multiply-add is contracted.  Each expression keeps the op
// order of `_emit_rows` / `_tile_total` (score_fuse.py:75-112), so on the
// same inputs the rows equal the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int REDUCE_THREADS = 1024;  // one block per row: U + B blocks
constexpr int EMIT_THREADS = 256;

// NaN-propagating min / max, as torch.amin / jnp.min.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <bool IS_MIN>
__device__ float block_reduce(float v, float* smem) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_down_sync(full, v, o);
    v = IS_MIN ? min_nan(v, w) : max_nan(v, w);
  }
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  const float pad = IS_MIN ? CUDART_INF_F : -CUDART_INF_F;
  v = (threadIdx.x < (blockDim.x >> 5)) ? smem[threadIdx.x] : pad;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) {
      float w = __shfl_down_sync(full, v, o);
      v = IS_MIN ? min_nan(v, w) : max_nan(v, w);
    }
  }
  __syncthreads();  // smem is reused by the next reduction
  return v;         // the block's result, in thread 0
}

// Eq. 2 cost basis C_i = p_i * ceil(R / cap_i) (score_fuse.py:75-82).
__device__ __forceinline__ float total_cost(float price, float vcpu, float mem,
                                            bool use_cpus, float amount) {
  const float cap = use_cpus ? vcpu : mem;
  return price * ceilf(amount / cap);
}

// Elementwise tail of the masked MinMax (score_fuse.py:92-96).
__device__ __forceinline__ float minmax_norm(float x, float lo, float hi) {
  const float rng = hi - lo;
  return rng > 0.0f ? (x - lo) / rng : 0.0f;
}

__global__ void score_reduce_kernel(
    const float* __restrict__ stats, const float* __restrict__ prices,
    const float* __restrict__ vcpus, const float* __restrict__ memory_gb,
    const unsigned char* __restrict__ uniq_masks,
    const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ use_cpus,
    const float* __restrict__ amount, float* __restrict__ ext,
    float* __restrict__ cmin, int K, int n_ext) {
  __shared__ float smem[32];
  const int row = blockIdx.x;
  if (row < n_ext) {
    const unsigned char* m = uniq_masks + (size_t)row * K;
    float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      if (m[k]) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float x = stats[(size_t)i * K + k];
          lo[i] = min_nan(lo[i], x);
          hi[i] = max_nan(hi[i], x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float l = block_reduce<true>(lo[i], smem);
      const float h = block_reduce<false>(hi[i], smem);
      if (threadIdx.x == 0) {
        ext[row * 6 + 2 * i] = l;
        ext[row * 6 + 2 * i + 1] = h;
      }
    }
  } else {
    const int b = row - n_ext;
    const unsigned char* m = masks + (size_t)b * K;
    const bool uc = use_cpus[b] != 0;
    const float amt = amount[b];
    float lo = CUDART_INF_F;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      if (m[k]) {
        lo = min_nan(lo, total_cost(prices[k], vcpus[k], memory_gb[k], uc, amt));
      }
    }
    lo = block_reduce<true>(lo, smem);
    if (threadIdx.x == 0) cmin[b] = lo;
  }
}

__global__ void score_emit_kernel(
    const float* __restrict__ stats, const float* __restrict__ prices,
    const float* __restrict__ vcpus, const float* __restrict__ memory_gb,
    const unsigned char* __restrict__ use_cpus,
    const float* __restrict__ amount, const float* __restrict__ lam,
    const float* __restrict__ weight, const int* __restrict__ inv,
    const float* __restrict__ ext, const float* __restrict__ cmin,
    float* __restrict__ comb, float* __restrict__ avail,
    float* __restrict__ cost, int K) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float* e = ext + (size_t)inv[b] * 6;
  const float lam_b = lam[b];
  const float w = weight[b];
  const float total = total_cost(prices[k], vcpus[k], memory_gb[k],
                                 use_cpus[b] != 0, amount[b]);
  const float a3 = minmax_norm(stats[k], e[0], e[1]);
  const float sn = minmax_norm(stats[(size_t)K + k], e[2], e[3]);
  const float gn = minmax_norm(stats[2 * (size_t)K + k], e[4], e[5]);
  float av = 100.0f * a3 * (1.0f + lam_b * (sn - gn));
  av = av < 0.0f ? 0.0f : av;  // clip at 0; NaN passes, as torch.clamp
  const float co = 100.0f * cmin[b] / total;
  const size_t o = (size_t)b * K + k;
  comb[o] = w * av + (1.0f - w) * co;
  avail[o] = av;
  cost[o] = co;
}

}  // namespace

// stats (3, K); prices, vcpus, memory_gb (K,); uniq_masks (U, K) and masks
// (B, K) as bytes; use_cpus (B,) bytes; amount (B,).  Writes ext (n_ext, 6)
// as (lo, hi) pairs of area, slope, std, and cmin (n_cmin,).  Blocks
// 0..n_ext-1 take extrema, the next n_cmin blocks take C_min.
extern "C" int score_fuse_reduce(
    const float* stats, const float* prices, const float* vcpus,
    const float* memory_gb, const unsigned char* uniq_masks,
    const unsigned char* masks, const unsigned char* use_cpus,
    const float* amount, float* ext, float* cmin, int K, int n_ext,
    int n_cmin, void* stream) {
  score_reduce_kernel<<<n_ext + n_cmin, REDUCE_THREADS, 0,
                        (cudaStream_t)stream>>>(
      stats, prices, vcpus, memory_gb, uniq_masks, masks, use_cpus, amount,
      ext, cmin, K, n_ext);
  return (int)cudaGetLastError();
}

// Emits the (B, K) rows from ext (U, 6), inv (B,) and cmin (B,).
extern "C" int score_fuse_emit(
    const float* stats, const float* prices, const float* vcpus,
    const float* memory_gb, const unsigned char* use_cpus,
    const float* amount, const float* lam, const float* weight,
    const int* inv, const float* ext, const float* cmin, float* comb,
    float* avail, float* cost, int K, int B, void* stream) {
  dim3 grid((K + EMIT_THREADS - 1) / EMIT_THREADS, B);
  score_emit_kernel<<<grid, EMIT_THREADS, 0, (cudaStream_t)stream>>>(
      stats, prices, vcpus, memory_gb, use_cpus, amount, lam, weight, inv,
      ext, cmin, comb, avail, cost, K);
  return (int)cudaGetLastError();
}
