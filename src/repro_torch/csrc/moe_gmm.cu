// MoE grouped expert matmuls over dense (E, C, D) capacity buffers,
// kernels B7 (gated up-projection) and B8 (down-projection).
//
// Replaces: src/repro/kernels/moe_gmm.py `_gmm_up_kernel` (launched by
// `moe_gmm`) and `_gmm_down_kernel` (launched by `moe_gmm_down`).  On the TPU
// each runs an (E, C/bc, F/bf, D/bd) grid whose last axis walks the
// contraction in order and carries float32 accumulators in VMEM scratch,
// masking the ragged tails of C, D and F.  Here each block owns an output
// tile of one expert and walks the whole contraction itself, so nothing
// carries between blocks:
//
//   B7:  out[e] = silu(x[e] @ w1[e]) * (x[e] @ w3[e])   x (E,C,D), w (E,D,F)
//   B8:  out[e] = h[e] @ w2[e]                          h (E,C,F), w2 (E,F,D)
//
// B7 (`gmm_kernel`): one block owns (16*MT) rows x 128 columns.  Each stage
// copies a (16*MT) x 32 tile of activations and a 32 x 128 tile of each
// weight into shared memory with cp.async (two stages in flight); four
// warps, side by side along the columns, load fragments with ldmatrix
// (.trans for the row-major weights) and run mma.sync m16n8k16 bf16
// products into float32 accumulators.  The epilogue takes silu(acc1)*acc3
// in float32 and casts once to bf16.  Rows past C, contraction steps past
// D, and columns past F are zero-filled on load or skipped on store.
// Shapes whose rows are not 16-byte aligned take element-wise loads.
//
// B8 (`gmm_down_kernel`, Hopper only): what bounds it is bytes.  At
// DeepSeek-V2-Lite's prefill (C = 240) it must stream 369 MB of w2 for 89
// GFLOP, 0.11 ms against 0.09 ms of tensor work; at decode (C = 8) the
// weights are all there is.  So a block owns one expert's 128 output
// columns for ALL its rows (up to 256 in one row group, four m64 tiles;
// more rows loop over row groups inside the block): each w2 byte leaves
// device memory once.  The grid is persistent, one block an SM walking the
// E x (D / 128) output tiles, the column tiles of one expert side by side
// so they share that expert's h in the L2, and the next tile's loads run
// under this tile's stores.  One producer thread (warpgroup 0, its registers given up with setmaxnreg)
// keeps a ring of 4-8 stages of TMA loads in flight: per stage an (up to
// 256) x 64 tile of h and a 64 x 128 tile of w2 (two 64-column boxes,
// N-major), 128-byte swizzled, guarded by full and empty mbarriers.  Two
// consumer warpgroups run wgmma m64n128k16 straight from shared memory
// (w2 through the descriptor's transpose bit; one stage's products still
// in flight when the next stage's are issued), two m64 row tiles each
// (one at C <= 128; at C <= 64 the second warpgroup idles: decode is
// bytes-bound and the one product per stage is not the limit), and cast
// to bf16 from registers, storing rows below C and columns below D.  The
// tensor maps zero-fill rows past C, contraction steps past F and
// columns past D, so a ragged tail adds zeros.  TMA needs 16-byte rows:
// F and D multiples of 8 (the wrapper pads other shapes).
//
// Numerics: products of bf16 are exact in float32; the sums run in the
// tensor cores' float32 order, unlike the plain version's float32 einsum,
// so results agree to float32 rounding before the final cast.  silu (B7)
// is a / (1 + expf(-a)) with IEEE division (built with --fmad=false, no
// fast math), as PyTorch computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// B8 on Hopper: TMA ring, producer thread, wgmma consumers
// ---------------------------------------------------------------------------

namespace down {

constexpr int BN = 128;            // output columns per block
constexpr int BK = 64;             // contraction depth per stage: one swizzle row
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// MT m64 row tiles a row group (1, 2 or 4); the ring is as deep as ~192 KB
// of shared memory allows.
template <int MT>
struct Plan {
  static constexpr int BM = 64 * MT;            // rows per row group
  static constexpr int A_BYTES = BM * BK * 2;   // h tile
  static constexpr int B_HALF = BK * 64 * 2;    // 64 columns of the w2 tile
  static constexpr int STAGE = A_BYTES + 2 * B_HALF;
  static constexpr int STAGES = MT == 4 ? 4 : (MT == 2 ? 6 : 8);
  static constexpr int CONSUMERS = MT == 1 ? 1 : 2;
  static constexpr int TILES = (MT + 1) / 2;    // m64 tiles per consumer
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// Persistent: block x takes the output tiles x, x + gridDim.x, ...; tile t
// is expert t / col_tiles, columns 128 * (t % col_tiles).  The producer
// runs on into the next tile's loads while the consumers store this one.
template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_down_kernel(const __grid_constant__ CUtensorMap h_map,
                    const __grid_constant__ CUtensorMap w_map,
                    __nv_bfloat16* __restrict__ out, int E, int C, int F,
                    int D) {
  using P = Plan<MT>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::STAGES * P::STAGE);
  uint64_t* empty = full + P::STAGES;

  const int col_tiles = (D + BN - 1) / BN;
  const int n_tiles = E * col_tiles;
  const int groups = (C + P::BM - 1) / P::BM;
  const int nk = (F + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread walks (tile, row group, contraction step) in order
    regs_shrink<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int e = tile / col_tiles;
        const int n0 = (tile % col_tiles) * BN;
        for (int rg = 0; rg < groups; ++rg) {
          for (int kt = 0; kt < nk; ++kt) {
            mbar_wait(&empty[s], phase ^ 1);
            uint8_t* a = smem + s * P::STAGE;
            uint8_t* b = a + P::A_BYTES;
            mbar_expect_tx(&full[s], P::STAGE);
            tma_load_3d(a, &h_map, &full[s], kt * BK, rg * P::BM, e);
            tma_load_3d(b, &w_map, &full[s], n0, kt * BK, e);
            tma_load_3d(b + P::B_HALF, &w_map, &full[s], n0 + 64, kt * BK, e);
            if (++s == P::STAGES) {
              s = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  regs_grow<CONSUMER_REGS>();
  const int c = wg - 1;               // consumer c owns m64 tiles c, c + 2
  if (c >= P::CONSUMERS) return;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const uint32_t base = smem_u32(smem);
  float acc[P::TILES][64];
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e = tile / col_tiles;
    const int n0 = (tile % col_tiles) * BN;
    for (int rg = 0; rg < groups; ++rg) {
#pragma unroll
      for (int i = 0; i < P::TILES; ++i)
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[i][j] = 0.0f;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[s], phase);
        const uint32_t a = base + s * P::STAGE;
        const uint32_t b = a + P::A_BYTES;
#pragma unroll
        for (int i = 0; i < P::TILES; ++i) fence_regs(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < P::TILES; ++i) {
          const uint32_t a_tile = a + (c + 2 * i) * 64 * 128;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            wgmma_m64n128k16_ss<1>(acc[i],
                                   sw128_desc(a_tile + 32 * kk, 16, 1024),
                                   sw128_desc(b + 2048 * kk, P::B_HALF, 1024),
                                   1);
          }
        }
        wgmma_commit();
        // one group stays in flight: the previous stage's products are done
        wgmma_wait<1>();
        if (kt > 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == P::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < P::TILES; ++i) fence_regs(acc[i]);
      if (nk > 0 && t == 0) mbar_arrive(&empty[prev]);
      // epilogue: one bf16 pair per (row, 8-column group) of each tile
#pragma unroll
      for (int i = 0; i < P::TILES; ++i) {
        const int row0 = rg * P::BM + (c + 2 * i) * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half;
          if (row >= C) continue;
          __nv_bfloat16* dst = out + ((size_t)e * C + row) * D;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * (lane % 4);
            if (col < D) {
              *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                  __floats2bfloat162_rn(acc[i][4 * j + 2 * half],
                                        acc[i][4 * j + 2 * half + 1]);
            }
          }
        }
      }
    }
  }
}

template <int MT>
int launch(const void* h, const void* w2, void* out, int E, int C, int F,
           int D, int grid_x, cudaStream_t st) {
  using P = Plan<MT>;
  CUtensorMap h_map, w_map;
  const uint64_t h_dims[3] = {(uint64_t)F, (uint64_t)C, (uint64_t)E};
  const uint64_t h_strides[2] = {(uint64_t)F * 2, (uint64_t)C * F * 2};
  const uint32_t h_box[3] = {BK, P::BM, 1};
  const uint64_t w_dims[3] = {(uint64_t)D, (uint64_t)F, (uint64_t)E};
  const uint64_t w_strides[2] = {(uint64_t)D * 2, (uint64_t)F * D * 2};
  const uint32_t w_box[3] = {64, BK, 1};
  int err = hopper::make_tensor_map(&h_map, h, 3, h_dims, h_strides, h_box);
  if (err) return err;
  err = hopper::make_tensor_map(&w_map, w2, 3, w_dims, w_strides, w_box);
  if (err) return err;
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      gmm_down_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  gmm_down_kernel<MT><<<grid_x, THREADS, P::SMEM, st>>>(
      h_map, w_map, static_cast<__nv_bfloat16*>(out), E, C, F, D);
  return (int)cudaGetLastError();
}

}  // namespace down

}  // namespace

// B7: x (E, C, D), w1 and w3 (E, D, F), out (E, C, F); all bf16, contiguous.
extern "C" int moe_gmm_up_launch(const void* x, const void* w1, const void* w3,
                                 void* out, int E, int C, int D, int F,
                                 void* stream) {
  return launch<2>(x, w1, w3, out, E, C, D, F, (cudaStream_t)stream);
}

// B8: h (E, C, F), w2 (E, F, D), out (E, C, D); all bf16, contiguous,
// 16-byte aligned, F and D multiples of 8.  `row_tiles` (1, 2 or 4 m64
// tiles a row group) and `grid_x` (persistent blocks, at most one an SM)
// come from the wrapper's launch plan.
extern "C" int moe_gmm_down_launch(const void* h, const void* w2, void* out,
                                   int E, int C, int F, int D, int row_tiles,
                                   int grid_x, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (F % 8 || D % 8) return (int)cudaErrorInvalidValue;
  if (row_tiles == 1) return down::launch<1>(h, w2, out, E, C, F, D, grid_x, st);
  if (row_tiles == 2) return down::launch<2>(h, w2, out, E, C, F, D, grid_x, st);
  if (row_tiles == 4) return down::launch<4>(h, w2, out, E, C, F, D, grid_x, st);
  return (int)cudaErrorInvalidValue;
}
