// Live-ingest tick: rank-1 update of the streaming moments fused with the
// Eq. 3 derivation, kernel B3.
//
// Replaces: src/repro/kernels/stats_update.py `_stats_update_kernel` (both
// variants, launched by `_stats_update_pallas`).  On the TPU its (nt,) grid
// streams K in tiles with the window length and evict flag in SMEM; there
// is no carry between tiles.  Here one thread owns one candidate: it reads
// the six moment halves, `ref` and the four columns (int8 codes and the
// candidate's scale on the quantized tier, decoded `code * scale` in
// registers), and writes the six new halves and (area, slope, std).
// `length` and `evict` arrive by value.
//
// Bound on an H100: bytes.  Per candidate the float32 tier reads 11 and
// writes 9 float32 values (80 bytes; the int8 tier reads 4 codes and a
// scale in place of 4 float32 columns) against about 70 flops, far under
// the card's 20 flops per byte.  At K = 32768 that is 2.6 MB, under a
// microsecond at 3.35 TB/s, so a launch costs more than the work: the
// design keeps to one launch per tick and coalesced loads, and leaves the
// launch overhead alone.
//
// Exactness: --fmad=false, no fast math, IEEE division and sqrtf, and the
// op order of `_update_tile` / `stats_from_moments` in
// src/repro_torch/kernels/stats_update.py and core/scoring.py, so the
// outputs equal the plain PyTorch version's bit for bit.  (The JAX
// reference on the CPU differs at ulp level: XLA contracts some of these
// products and sums into fused multiply-adds.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

// One Neumaier-compensated add: (s, c) += x.
__device__ __forceinline__ void cadd(float& s, float& c, float x) {
  const float t = s + x;
  c = c + (fabsf(s) >= fabsf(x) ? (s - t) + x : (x - t) + s);
  s = t;
}

template <bool QUANTIZED>
__device__ __forceinline__ float column(const void* y, const float* scale,
                                        int k) {
  if (QUANTIZED) {
    return (float)static_cast<const int8_t*>(y)[k] * scale[k];
  }
  return static_cast<const float*>(y)[k];
}

template <bool QUANTIZED>
__global__ void stats_update_kernel(
    const float* __restrict__ s0_in, const float* __restrict__ s0c_in,
    const float* __restrict__ s1_in, const float* __restrict__ s1c_in,
    const float* __restrict__ q_in, const float* __restrict__ qc_in,
    const float* __restrict__ ref_in, const void* __restrict__ y_new_in,
    const void* __restrict__ y_old_in, const void* __restrict__ y_first_in,
    const void* __restrict__ y_last_in, const float* __restrict__ scale,
    float* __restrict__ out, int K, int evict, float length) {
  const int k = blockIdx.x * BLOCK + threadIdx.x;
  if (k >= K) return;
  const float y_new = column<QUANTIZED>(y_new_in, scale, k);
  const float y_old = column<QUANTIZED>(y_old_in, scale, k);
  const float y_first = column<QUANTIZED>(y_first_in, scale, k);
  const float y_last = column<QUANTIZED>(y_last_in, scale, k);
  const float ref = ref_in[k];
  float s0 = s0_in[k], s0c = s0c_in[k];
  float s1 = s1_in[k], s1c = s1c_in[k];
  float q = q_in[k], qc = qc_in[k];

  // S1 first, from the pre-update S0 pair; a gated term is exactly +0.0.
  const float s0_pre = s0, s0c_pre = s0c;
  cadd(s1, s1c, (length - 1.0f) * y_new);
  cadd(s1, s1c, evict ? y_old : 0.0f);
  cadd(s1, s1c, evict ? -s0_pre : 0.0f);
  cadd(s1, s1c, evict ? -s0c_pre : 0.0f);
  cadd(s0, s0c, y_new);
  cadd(s0, s0c, evict ? -y_old : 0.0f);
  const float d_new = y_new - ref;
  const float d_old = y_old - ref;
  cadd(q, qc, d_new * d_new);
  cadd(q, qc, evict ? -(d_old * d_old) : 0.0f);

  // stats_from_moments, op for op.
  const float S0 = s0 + s0c;
  const float S1 = s1 + s1c;
  const float Q = q + qc;
  const float T = length;
  const float area = T > 1.0f ? S0 - 0.5f * (y_first + y_last) : 0.5f * S0;
  const float denom = T * (T * T - 1.0f) / 12.0f;
  const float slope =
      (S1 - (T - 1.0f) / 2.0f * S0) / (denom > 0.0f ? denom : 1.0f);
  const float d = S0 / T - ref;
  const float var = Q / T - d * d;
  const float std = sqrtf(var < 0.0f ? 0.0f : var);  // NaN stays NaN

  const size_t n = (size_t)K;
  out[k] = s0;
  out[n + k] = s0c;
  out[2 * n + k] = s1;
  out[3 * n + k] = s1c;
  out[4 * n + k] = q;
  out[5 * n + k] = qc;
  out[6 * n + k] = area;
  out[7 * n + k] = slope;
  out[8 * n + k] = std;
}

}  // namespace

// Moments (s0, s0c, s1, s1c, q, qc, ref) are (K,) float32; the four columns
// are (K,) float32, or int8 codes with a (K,) float32 `scale` when
// `quantized` is 1 (`scale` is ignored otherwise).  Writes a (9, K) float32
// `out`: the six new moment halves, then area, slope and std.
extern "C" int stats_update_launch(
    const float* s0, const float* s0c, const float* s1, const float* s1c,
    const float* q, const float* qc, const float* ref, const void* y_new,
    const void* y_old, const void* y_first, const void* y_last,
    const float* scale, float* out, int K, int evict, int quantized,
    float length, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((K + BLOCK - 1) / BLOCK);
  if (quantized) {
    stats_update_kernel<true><<<grid, BLOCK, 0, st>>>(
        s0, s0c, s1, s1c, q, qc, ref, y_new, y_old, y_first, y_last, scale,
        out, K, evict, length);
  } else {
    stats_update_kernel<false><<<grid, BLOCK, 0, st>>>(
        s0, s0c, s1, s1c, q, qc, ref, y_new, y_old, y_first, y_last, scale,
        out, K, evict, length);
  }
  return (int)cudaGetLastError();
}
