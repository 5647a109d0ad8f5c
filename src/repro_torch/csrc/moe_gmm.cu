// MoE grouped expert matmuls over dense (E, C, D) capacity buffers,
// kernels B7 (gated up-projection) and B8 (down-projection).
//
// Replaces: src/repro/kernels/moe_gmm.py `_gmm_up_kernel` (launched by
// `moe_gmm`) and `_gmm_down_kernel` (launched by `moe_gmm_down`).  On the TPU
// each runs an (E, C/bc, F/bf, D/bd) grid whose last axis walks the
// contraction in order and carries float32 accumulators in VMEM scratch,
// masking the ragged tails of C, D and F.  Here one block owns an output
// tile of (16*MT) rows x 128 columns of one expert and walks the whole
// contraction itself, so nothing carries between blocks:
//
//   B7:  out[e] = silu(x[e] @ w1[e]) * (x[e] @ w3[e])   x (E,C,D), w (E,D,F)
//   B8:  out[e] = h[e] @ w2[e]                          h (E,C,F), w2 (E,F,D)
//
// Each stage copies a (16*MT) x 32 tile of activations and a 32 x 128 tile
// of each weight into shared memory with cp.async (two stages in flight);
// four warps, side by side along the columns, load fragments with ldmatrix
// (.trans for the row-major weights) and run mma.sync m16n8k16 bf16
// products into float32 accumulators.  The epilogue takes silu(acc1)*acc3
// in float32 (B7) and casts once to bf16.  Rows past C, contraction steps
// past D (B7) or F (B8), and columns past the output width are zero-filled
// on load or skipped on store.  Shapes whose rows are not 16-byte aligned
// take element-wise loads instead of cp.async.
//
// Bound on an H100: at decode (C = 8 rows per expert) bytes: the kernel
// must read every weight of the layer once (738 MB for B7, 369 MB for B8
// at DeepSeek-V2-Lite's widths) for ~3 flops a byte, far under the card's
// ~295 bf16 flops per byte.  So each block reads its weight tiles exactly
// once for all its rows (MT = 1 when C <= 16), and the (E x F/128) grid puts
// several blocks on every SM to keep enough loads in flight.  At prefill
// (C = 240) the tiles are 64 rows high and a weight tile is read once per
// 64 rows; the tensor cores through mma.sync, not wgmma, cap the rate.
//
// Numerics: products of bf16 are exact in float32; the sums run in the
// tensor cores' float32 order, unlike the plain version's float32 einsum,
// so results agree to float32 rounding before the final cast.  silu is
// a / (1 + expf(-a)) with IEEE division (built with --fmad=false, no fast
// math), as PyTorch computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // output columns per block
constexpr int BK = 32;             // contraction depth per stage
constexpr int THREADS = 128;       // four warps along the columns
constexpr int WN = BN / 4;         // 32 columns per warp: four n8 tiles
constexpr int A_STRIDE = BK + 8;   // 80-byte rows: ldmatrix without conflicts
constexpr int B_STRIDE = BN + 8;   // 272-byte rows

template <int MT, int NB>
struct Tiles {
  __nv_bfloat16 a[2][16 * MT][A_STRIDE];
  __nv_bfloat16 b[2][NB][BK][B_STRIDE];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight bf16 of row `row` (of `len` elements; `row_ok` false past the last
// row) starting at column `col` into shared memory at `dst`, zero past the
// end.  `vec`: every row starts 16-byte aligned and len % 8 == 0, so a chunk
// is wholly inside or wholly outside the row.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst,
                                           const __nv_bfloat16* row,
                                           bool row_ok, int col, int len,
                                           bool vec) {
  if (vec) {
    const bool ok = row_ok && col < len;
    cp_async16(dst, ok ? row + col : row, ok);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dst[j] = (row_ok && col + j < len) ? row[col + j] : __float2bfloat16(0.0f);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[e] (M x N) = epilogue(a[e] (M x K) @ w_i[e] (K x N)) for i < NB.
// NB == 2: silu(acc0) * acc1 (B7); NB == 1: acc0 (B8).
template <int MT, int NB>
__global__ void __launch_bounds__(THREADS)
    gmm_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ w0,
               const __nv_bfloat16* __restrict__ w1,
               __nv_bfloat16* __restrict__ out, int M, int K, int N,
               int vec) {
  constexpr int BM = 16 * MT;
  __shared__ __align__(16) Tiles<MT, NB> t;

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const __nv_bfloat16* a_e = a + (size_t)e * M * K;
  const __nv_bfloat16* w_e[2] = {w0 + (size_t)e * K * N,
                                 NB > 1 ? w1 + (size_t)e * K * N : nullptr};

  auto load_stage = [&](int s, int k0) {
    // activations: BM rows x 32 columns = BM * 4 chunks of 8
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const bool row_ok = m0 + r < M;
      const __nv_bfloat16* row = a_e + (size_t)(row_ok ? m0 + r : 0) * K;
      load_chunk(&t.a[s][r][c], row, row_ok, k0 + c, K, vec);
    }
    // weights: 32 rows x 128 columns = 512 chunks of 8 per matrix
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < BK * (BN / 8) / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / (BN / 8);
        const int c = (i % (BN / 8)) * 8;
        const bool row_ok = k0 + r < K;
        const __nv_bfloat16* row =
            w_e[nb] + (size_t)(row_ok ? k0 + r : 0) * N;
        load_chunk(&t.b[s][nb][r][c], row, row_ok, n0 + c, N, vec);
      }
    }
  };

  float acc[NB][MT][4][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nb][mt][j][q] = 0.0f;

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) load_stage(s ^ 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();   // stage kt has landed (its group is not the newest)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4(af[mt], &t.a[s][mt * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int pair = 0; pair < 2; ++pair) {
          uint32_t bf[4];   // b0, b1 of n8 tile 2*pair, then of 2*pair + 1
          ldsm_x4_trans(bf, &t.b[s][nb][kk + (lane & 15)]
                                 [warp * WN + pair * 16 + (lane >> 4) * 8]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[nb][mt][2 * pair], af[mt], bf[0], bf[1]);
            mma_bf16(acc[nb][mt][2 * pair + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();      // the next iteration's load overwrites stage s ^ 1
  }
  cp_async_wait<0>();

  // accumulator fragment: q = 0, 1 at (row g, cols 2t, 2t+1); q = 2, 3 at
  // row g + 8, with g = lane / 4 and t = lane % 4
  const int g = lane >> 2;
  const int tq = lane & 3;
  __nv_bfloat16* out_e = out + (size_t)e * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + mt * 16 + g + (q >> 1) * 8;
        const int col = n0 + warp * WN + j * 8 + tq * 2 + (q & 1);
        if (row < M && col < N) {
          float v = acc[0][mt][j][q];
          if (NB > 1) {
            v = v / (1.0f + expf(-v)) * acc[NB - 1][mt][j][q];
          }
          out_e[(size_t)row * N + col] = __float2bfloat16(v);
        }
      }
    }
  }
}

template <int NB>
int launch(const void* a, const void* w0, const void* w1, void* out, int E,
           int M, int K, int N, cudaStream_t st) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w0) |
        reinterpret_cast<uintptr_t>(w1)) &
       15) == 0;
  const int vec = aligned && K % 8 == 0 && N % 8 == 0;
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* p0 = static_cast<const __nv_bfloat16*>(w0);
  const auto* p1 = static_cast<const __nv_bfloat16*>(w1);
  auto* po = static_cast<__nv_bfloat16*>(out);
  const int gx = (N + BN - 1) / BN;
  if (M <= 16) {
    gmm_kernel<1, NB><<<dim3(gx, (M + 15) / 16, E), THREADS, 0, st>>>(
        pa, p0, p1, po, M, K, N, vec);
  } else if (M <= 32) {
    gmm_kernel<2, NB><<<dim3(gx, (M + 31) / 32, E), THREADS, 0, st>>>(
        pa, p0, p1, po, M, K, N, vec);
  } else {
    gmm_kernel<4, NB><<<dim3(gx, (M + 63) / 64, E), THREADS, 0, st>>>(
        pa, p0, p1, po, M, K, N, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// B7: x (E, C, D), w1 and w3 (E, D, F), out (E, C, F); all bf16, contiguous.
extern "C" int moe_gmm_up_launch(const void* x, const void* w1, const void* w3,
                                 void* out, int E, int C, int D, int F,
                                 void* stream) {
  return launch<2>(x, w1, w3, out, E, C, D, F, (cudaStream_t)stream);
}

// B8: h (E, C, F), w2 (E, F, D), out (E, C, D); all bf16, contiguous.
extern "C" int moe_gmm_down_launch(const void* h, const void* w2, void* out,
                                   int E, int C, int F, int D, void* stream) {
  return launch<1>(h, w2, w2, out, E, C, F, D, (cudaStream_t)stream);
}
