// Chunked WKV6 scan (RWKV6 linear attention with data-dependent decay),
// kernel B5.
//
// Replaces: src/repro/kernels/rwkv6_scan.py `_wkv_kernel` (launched by
// `rwkv6_scan`).  On the TPU its grid is (B*H, chunks) with the chunk axis
// sequential and the (Dk, Dv) state carried in VMEM scratch.  Here one
// block owns one (batch, head) pair and walks its chunks in a loop, the
// float32 state resident in shared memory from s0 to s_final.  Per chunk of
// C = 32 steps it stages r, k, v (bf16 -> float32), log_w and its cumsum in
// shared memory, then evaluates the Pallas body's quadratic form:
//
//   cw      = cumsum(w)                                 (sequential per channel)
//   att_ij  = sum_d r_id exp(clip(cw_id - w_id - cw_jd, -60, 0)) k_jd,  j < i
//   out_i   = (r_i * exp(cw_i - w_i)) @ S + sum_j att_ij v_j + (r_i.u.k_i) v_i
//   S'      = exp(cw_C)^T * S + (k * exp(cw_C - cw))^T @ v
//
// Rows past S (the last chunk's padding) are zeros, as the wrapper pads:
// log_w = 0 leaves the cumsum unchanged and k = v = 0 add nothing.
//
// Bound on an H100 at the serving shape (B, S, H, D) = (16, 128, 64, 64):
// operations.  It reads 151 MB (bf16 r/k/v, float32 log_w, state in and
// out, float32 output): 45 us at 3.35 TB/s.  The pairwise decay alone is
// C*(C-1)/2*D exponentials and 3 flops each per chunk and head, about
// 3.2 GFLOP of float32 work in all with the three contractions: 48 us at
// 67 TFLOP/s, and the exponentials go through the SFU at a quarter of that
// rate.  This first version keeps everything in CUDA cores (no tensor
// cores: the contractions are 32 x 64 x 64, and float32 tf32 would change
// the numbers) and pads each shared-memory row by one float so that a warp
// walking a column hits 32 banks.
//
// Exactness: float32 throughout, no fast math.  It is held against the
// plain PyTorch version at a relative tolerance: the cumsum and the
// contractions sum in another order than PyTorch's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 32;          // chunk length
constexpr int THREADS = 256;

template <int D>
struct Smem {
  static constexpr int P = D + 1;                  // padded row pitch
  static constexpr int ROWS = C * P;
  // r, k, v, w, cw (C x P each), att (C x (C + 1)), bonus (C), s (D x D)
  static constexpr int FLOATS = 5 * ROWS + C * (C + 1) + C + D * D;
  static constexpr int BYTES = FLOATS * 4;
};

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    wkv_kernel(const uint16_t* __restrict__ r_in,
               const uint16_t* __restrict__ k_in,
               const uint16_t* __restrict__ v_in,
               const float* __restrict__ w_in, const float* __restrict__ u_in,
               const float* __restrict__ s0, float* __restrict__ out,
               float* __restrict__ s_final, int S, int H) {
  using L = Smem<D>;
  constexpr int P = L::P;
  extern __shared__ float smem[];
  float* r = smem;
  float* k = r + L::ROWS;
  float* v = k + L::ROWS;
  float* w = v + L::ROWS;
  float* cw = w + L::ROWS;
  float* att = cw + L::ROWS;                // C x (C + 1)
  float* bonus = att + C * (C + 1);         // C
  float* s = bonus + C;                     // D x D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const size_t row_stride = (size_t)H * D;  // one time step of (H, D)
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;

  const float* s_in = s0 + (size_t)bh * D * D;
  for (int i = tid; i < D * D; i += THREADS) s[i] = s_in[i];

  const int n_chunks = (S + C - 1) / C;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * C;
    // stage the chunk (zero rows past S)
    for (int i = tid; i < C * D; i += THREADS) {
      const int row = i / D;
      const int d = i % D;
      const int t = t0 + row;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (t < S) {
        const size_t g = base + (size_t)t * row_stride + d;
        rv = bf16_to_float(r_in[g]);
        kv = bf16_to_float(k_in[g]);
        vv = bf16_to_float(v_in[g]);
        wv = w_in[g];
      }
      r[row * P + d] = rv;
      k[row * P + d] = kv;
      v[row * P + d] = vv;
      w[row * P + d] = wv;
    }
    __syncthreads();

    // cw = cumsum(w) along the chunk, one channel a thread
    if (tid < D) {
      float acc = 0.f;
      for (int row = 0; row < C; ++row) {
        acc = acc + w[row * P + tid];
        cw[row * P + tid] = acc;
      }
    }
    __syncthreads();

    // att (strictly lower triangular) and the bonus r_i . (u * k_i)
    for (int e = tid; e < C * C; e += THREADS) {
      const int i = e / C;
      const int j = e % C;
      float acc = 0.f;
      if (j < i) {
        for (int d = 0; d < D; ++d) {
          const float x = cw[i * P + d] - w[i * P + d] - cw[j * P + d];
          const float decay = expf(fminf(fmaxf(x, -60.f), 0.f));
          acc = acc + r[i * P + d] * decay * k[j * P + d];
        }
      }
      att[i * (C + 1) + j] = acc;
    }
    if (tid < C) {
      const float* u = u_in + (size_t)h * D;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) {
        acc = acc + r[tid * P + d] * u[d] * k[tid * P + d];
      }
      bonus[tid] = acc;
    }
    __syncthreads();

    // r <- r * exp(cw - w): the inter-chunk query (r is not read again)
    for (int i = tid; i < C * D; i += THREADS) {
      const int row = i / D;
      const int d = i % D;
      r[row * P + d] = r[row * P + d] *
                       expf(cw[row * P + d] - w[row * P + d]);
    }
    __syncthreads();

    // out_i = inter + intra + bonus
    for (int e = tid; e < C * D; e += THREADS) {
      const int i = e / D;
      const int c = e % D;
      float inter = 0.f;
      for (int d = 0; d < D; ++d) inter = inter + r[i * P + d] * s[d * D + c];
      float intra = 0.f;
      for (int j = 0; j < i; ++j) intra = intra + att[i * (C + 1) + j] * v[j * P + c];
      const float o = inter + intra + bonus[i] * v[i * P + c];
      if (t0 + i < S) out[base + (size_t)(t0 + i) * row_stride + c] = o;
    }
    __syncthreads();

    // k <- k * exp(cw_C - cw): the state update's keys (k is not read again)
    for (int i = tid; i < C * D; i += THREADS) {
      const int row = i / D;
      const int d = i % D;
      k[row * P + d] = k[row * P + d] *
                       expf(cw[(C - 1) * P + d] - cw[row * P + d]);
    }
    __syncthreads();

    // S' = exp(cw_C)^T * S + k_scaled^T @ v, each thread its own entries
    for (int e = tid; e < D * D; e += THREADS) {
      const int dk = e / D;
      const int dv = e % D;
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc = acc + k[j * P + dk] * v[j * P + dv];
      s[e] = expf(cw[(C - 1) * P + dk]) * s[e] + acc;
    }
    __syncthreads();
  }

  float* s_out = s_final + (size_t)bh * D * D;
  for (int i = tid; i < D * D; i += THREADS) s_out[i] = s[i];
}

template <int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_final, int B,
           int S, int H, cudaStream_t st) {
  const int bytes = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<D><<<B * H, THREADS, bytes, st>>>(
      static_cast<const uint16_t*>(r), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_final), S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v (B, S, H, D) bf16; w (B, S, H, D) float32 log decays; u (H, D)
// float32; s0 (B, H, D, D) float32; out (B, S, H, D) float32; s_final
// (B, H, D, D) float32; all contiguous.  D is 16, 32 or 64.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* out, void* s_final, int B, int S, int H,
                                 int D, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16>(r, k, v, w, u, s0, out, s_final, B, S, H, st);
    case 32:
      return launch<32>(r, k, v, w, u, s0, out, s_final, B, S, H, st);
    case 64:
      return launch<64>(r, k, v, w, u, s0, out, s_final, B, S, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
