// Live-ingest tick: rank-1 update of the streaming moments fused with the
// Eq. 3 derivation, kernel B3.
//
// Replaces: src/repro/kernels/stats_update.py `_stats_update_kernel` (both
// variants, launched by `_stats_update_pallas`).  On the TPU its (nt,) grid
// streams K in tiles with the window length and evict flag in SMEM; there
// is no carry between tiles.  Here a thread owns one candidate, on the grid
// of the wrapper's `stats_update_plan`, which gives every SM a block (at
// K = 32768, 256 blocks of 128 threads).  A thread issues every load before
// any arithmetic: the six moment halves and `ref`, the four columns
// (float32, bf16 or int8 codes) and, on the quantized tier, the candidate's
// scale; then it computes, then writes the six new halves and (area,
// slope, std).  bf16 and int8 columns are widened in registers
// (`__bfloat162float` is exact; int8 decodes `code * scale`), so no tier
// needs a cast launch before this one.  (Four candidates a thread with
// 16-byte accesses ran slower at K = 32768, PERF.md, Findings: a thread's
// four candidates, three IEEE divisions and a root each, serialize on two
// warps an SM, while a launch and one round trip to the L2 are the whole
// cost.)  `length` and `evict` arrive by value.
//
// Bound on an H100: bytes.  Per candidate the float32 tier reads 11 and
// writes 9 float32 values (80 bytes; the int8 tier reads 4 codes and a
// scale in place of 4 float32 columns, the bf16 tier 4 bf16 values)
// against about 70 flops, far under the card's 20 flops per byte.  At
// K = 32768 that is 2.6 MB, under a microsecond at 3.35 TB/s, so a launch
// and one round trip to memory cost more than the work: the design keeps to
// one launch per tick, fills every SM and has all of a thread's loads in
// flight at once.
//
// Exactness: --fmad=false, no fast math, IEEE division and sqrtf, and the
// op order of `_update_tile` / `stats_from_moments` in
// src/repro_torch/kernels/stats_update.py and core/scoring.py, so the
// outputs equal the plain PyTorch version's bit for bit.  (The JAX
// reference on the CPU differs at ulp level: XLA contracts some of these
// products and sums into fused multiply-adds.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Column { F32 = 0, I8 = 1, BF16 = 2 };

// One Neumaier-compensated add: (s, c) += x.
__device__ __forceinline__ void cadd(float& s, float& c, float x) {
  const float t = s + x;
  c = c + (fabsf(s) >= fabsf(x) ? (s - t) + x : (x - t) + s);
  s = t;
}

// The storage type of a column, and one value of it as float32: int8
// decodes `code * scale`, bf16 widens (exact).
template <int COL> struct Stored;
template <> struct Stored<F32> { using type = float; };
template <> struct Stored<I8> { using type = int8_t; };
template <> struct Stored<BF16> { using type = uint16_t; };

template <int COL, typename T>
__device__ __forceinline__ float decode(T v, float scale) {
  if constexpr (COL == F32) return v;
  else if constexpr (COL == I8) return (float)v * scale;
  else return __bfloat162float(__ushort_as_bfloat16(v));
}

struct Moments {
  const float* m[7];  // s0, s0c, s1, s1c, q, qc, ref
};
struct Columns {
  const void* y[4];   // y_new, y_old, y_first, y_last
};

template <int COL>
__global__ void stats_update_kernel(Moments in, Columns cols,
                                    const float* __restrict__ scale,
                                    float* __restrict__ out, int K, int evict,
                                    float length) {
  using T = typename Stored<COL>::type;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  // every load first
  float m[7];
  T y[4];
#pragma unroll
  for (int i = 0; i < 7; ++i) m[i] = __ldg(in.m[i] + k);
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = __ldg(static_cast<const T*>(cols.y[i]) + k);
  float sc = 1.0f;
  if constexpr (COL == I8) sc = __ldg(scale + k);

  const float y_new = decode<COL>(y[0], sc);
  const float y_old = decode<COL>(y[1], sc);
  const float y_first = decode<COL>(y[2], sc);
  const float y_last = decode<COL>(y[3], sc);
  float s0 = m[0], s0c = m[1];
  float s1 = m[2], s1c = m[3];
  float q = m[4], qc = m[5];
  const float ref = m[6];

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
  const float T_ = length;
  const float area = T_ > 1.0f ? S0 - 0.5f * (y_first + y_last) : 0.5f * S0;
  const float denom = T_ * (T_ * T_ - 1.0f) / 12.0f;
  const float slope =
      (S1 - (T_ - 1.0f) / 2.0f * S0) / (denom > 0.0f ? denom : 1.0f);
  const float d = S0 / T_ - ref;
  const float var = Q / T_ - d * d;
  const float std = sqrtf(var < 0.0f ? 0.0f : var);  // NaN stays NaN

  const float o[9] = {s0, s0c, s1, s1c, q, qc, area, slope, std};
#pragma unroll
  for (int i = 0; i < 9; ++i) out[(size_t)i * K + k] = o[i];
}

template <int COL>
int launch(const Moments& m, const Columns& c, const float* scale, float* out,
           int K, int evict, float length, int blocks, int threads,
           cudaStream_t st) {
  stats_update_kernel<COL><<<blocks, threads, 0, st>>>(m, c, scale, out, K,
                                                       evict, length);
  return (int)cudaGetLastError();
}

}  // namespace

// Moments (s0, s0c, s1, s1c, q, qc, ref) are (K,) float32; the four columns
// are (K,) float32 (`column` 0), int8 codes with a (K,) float32 `scale`
// (`column` 1) or bf16 (`column` 2); `scale` is ignored unless `column` is
// 1.  Writes a (9, K) float32 `out`: the six new moment halves, then area,
// slope and std.  `blocks` and `threads` come from the wrapper's
// `stats_update_plan`.
extern "C" int stats_update_launch(
    const float* s0, const float* s0c, const float* s1, const float* s1c,
    const float* q, const float* qc, const float* ref, const void* y_new,
    const void* y_old, const void* y_first, const void* y_last,
    const float* scale, float* out, int K, int evict, int column, int blocks,
    int threads, float length, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Moments m = {{s0, s0c, s1, s1c, q, qc, ref}};
  const Columns c = {{y_new, y_old, y_first, y_last}};
  switch (column) {
    case F32:
      return launch<F32>(m, c, scale, out, K, evict, length, blocks, threads,
                         st);
    case I8:
      return launch<I8>(m, c, scale, out, K, evict, length, blocks, threads,
                        st);
    case BF16:
      return launch<BF16>(m, c, scale, out, K, evict, length, blocks, threads,
                          st);
  }
  return (int)cudaErrorInvalidValue;
}
