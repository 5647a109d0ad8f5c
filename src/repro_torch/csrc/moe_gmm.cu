// MoE grouped expert matmuls over dense (E, C, D) capacity buffers,
// kernels B7 (gated up-projection) and B8 (down-projection).
//
// Replaces: src/repro/kernels/moe_gmm.py `_gmm_up_kernel` (launched by
// `moe_gmm`) and `_gmm_down_kernel` (launched by `moe_gmm_down`).  On the TPU
// each runs an (E, C/bc, F/bf, D/bd) grid whose last axis walks the
// contraction in order and carries float32 accumulators in VMEM scratch,
// masking the ragged tails of C, D and F.  Here each block owns output
// tiles of one expert and walks the whole contraction itself, so nothing
// carries between blocks:
//
//   B7:  out[e] = silu(x[e] @ w1[e]) * (x[e] @ w3[e])   x (E,C,D), w (E,D,F)
//   B8:  out[e] = h[e] @ w2[e]                          h (E,C,F), w2 (E,F,D)
//
// What bounds both on an H100 is bytes.  At DeepSeek-V2-Lite's prefill
// (E = 64, C = 240, D = 2048, F = 1408) B7 must stream 844 MB (w1 and w3
// 739 MB, x 63 MB, out 43 MB) for 177 GFLOP: 0.25 ms against 0.18 ms of
// tensor work; B8 475 MB for 89 GFLOP.  At decode (C = 8) the weights are
// nearly all there is (B7 742 MB, B8 373 MB).  So a tile is one expert's
// output columns for ALL its rows (up to 256 in one row group, four m64
// tiles; more rows loop over row groups inside the block): each weight
// byte leaves device memory once per launch.  B7's tile is 64 columns of
// F (w1's and w3's columns n0 .. n0 + 63), B8's 128 columns of D.
//
// One template, `gmm_tiles<MT, UP>`, runs both: a persistent grid, one
// block an SM walking the E x (N / cols) tiles, the column tiles of one
// expert side by side so they share its activations in the L2, the next
// tile's loads running under this tile's stores.  One producer thread
// (warpgroup 0, its registers given up with setmaxnreg) keeps a ring of
// 4-8 stages of TMA loads in flight, guarded by full and empty mbarriers:
// per stage an (up to 256) x 64 tile of the activations (K-major) and two
// 64 x 64 boxes of weights (N-major), 128-byte swizzled.  B8's two boxes
// are w2's columns n0 and n0 + 64; B7's are w1's and w3's columns n0, so
// one wgmma m64n128k16 (weights through the descriptor's transpose bit)
// computes [x @ w1 | x @ w3] side by side.  The stage is 2 * 64 * (rows +
// 128) bytes either way.  Two consumer warpgroups run the products straight
// from shared memory, one stage's products still in flight when the next
// stage's are issued, two m64 row tiles each (one at C <= 128; at C <= 64
// the second warpgroup idles: decode is bytes-bound).  The tensor maps
// zero-fill rows past C, contraction steps past K and columns past N, so a
// ragged tail adds zeros; TMA needs 16-byte rows, so the wrappers pad
// other shapes.
//
// Epilogues, from registers (wgmma's accumulator layout, hopper.cuh):
// thread t holds acc[4j + 2 half + q] at row 16 (t / 32) + (t % 32) / 4 +
// 8 half and column 8j + 2 (t % 4) + q.  B8 casts each pair to bf16.  For
// B7, w1's column c (< 64) is acc[k] and w3's column c is acc[k + 32] of
// the same thread; it takes a / (1 + expf(-a)) * b in float32 with IEEE
// division (built with --fmad=false, no fast math), as PyTorch computes
// silu(a) * b, casts once to bf16 and stores rows below C and columns
// below F.
//
// Numerics: products of bf16 are exact in float32; the sums run in the
// tensor cores' float32 order, unlike the plain version's float32 einsum,
// so results agree to float32 rounding before the final cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;             // contraction depth per stage: one swizzle row
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// MT m64 row tiles a row group (1, 2 or 4); the ring is as deep as ~192 KB
// of shared memory allows.
template <int MT>
struct Plan {
  static constexpr int BM = 64 * MT;            // rows per row group
  static constexpr int A_BYTES = BM * BK * 2;   // activation tile
  static constexpr int B_HALF = BK * 64 * 2;    // one 64-column weight box
  static constexpr int STAGE = A_BYTES + 2 * B_HALF;
  static constexpr int STAGES = MT == 4 ? 4 : (MT == 2 ? 6 : 8);
  static constexpr int CONSUMERS = MT == 1 ? 1 : 2;
  static constexpr int TILES = (MT + 1) / 2;    // m64 tiles per consumer
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// out (E, C, N) from a (E, C, K) and the weight boxes of b_map (and, for
// B7, b2_map), both over (E, K, N).  UP: B7 (64-column tiles of w1 beside
// w3, silu(a) * b); else B8 (128-column tiles of one weight, a).
//
// Persistent: block x takes the output tiles x, x + gridDim.x, ...; tile t
// is expert t / col_tiles, columns cols * (t % col_tiles).  The producer
// runs on into the next tile's loads while the consumers store this one.
template <int MT, bool UP>
__device__ __forceinline__ void gmm_tiles(const CUtensorMap* a_map,
                                          const CUtensorMap* b_map,
                                          const CUtensorMap* b2_map,
                                          __nv_bfloat16* __restrict__ out,
                                          int E, int C, int K, int N) {
  using P = Plan<MT>;
  using namespace hopper;
  constexpr int COLS = UP ? 64 : 128;   // output columns a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::STAGES * P::STAGE);
  uint64_t* empty = full + P::STAGES;

  const int col_tiles = (N + COLS - 1) / COLS;
  const int n_tiles = E * col_tiles;
  const int groups = (C + P::BM - 1) / P::BM;
  const int nk = (K + BK - 1) / BK;
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
        const int n0 = (tile % col_tiles) * COLS;
        for (int rg = 0; rg < groups; ++rg) {
          for (int kt = 0; kt < nk; ++kt) {
            mbar_wait(&empty[s], phase ^ 1);
            uint8_t* a = smem + s * P::STAGE;
            uint8_t* b = a + P::A_BYTES;
            mbar_expect_tx(&full[s], P::STAGE);
            tma_load_3d(a, a_map, &full[s], kt * BK, rg * P::BM, e);
            tma_load_3d(b, b_map, &full[s], n0, kt * BK, e);
            tma_load_3d(b + P::B_HALF, b2_map, &full[s], UP ? n0 : n0 + 64,
                        kt * BK, e);
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
    const int n0 = (tile % col_tiles) * COLS;
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
          __nv_bfloat16* dst = out + ((size_t)e * C + row) * N;
#pragma unroll
          for (int j = 0; j < COLS / 8; ++j) {
            const int col = n0 + 8 * j + 2 * (lane % 4);
            if (col >= N) continue;
            const int k = 4 * j + 2 * half;
            float v0 = acc[i][k], v1 = acc[i][k + 1];
            if constexpr (UP) {   // w1's column c is acc[k], w3's acc[k + 32]
              v0 = v0 / (1.0f + expf(-v0)) * acc[i][k + 32];
              v1 = v1 / (1.0f + expf(-v1)) * acc[i][k + 33];
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_up_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w1_map,
                  const __grid_constant__ CUtensorMap w3_map,
                  __nv_bfloat16* __restrict__ out, int E, int C, int D,
                  int F) {
  gmm_tiles<MT, true>(&x_map, &w1_map, &w3_map, out, E, C, D, F);
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_down_kernel(const __grid_constant__ CUtensorMap h_map,
                    const __grid_constant__ CUtensorMap w_map,
                    __nv_bfloat16* __restrict__ out, int E, int C, int F,
                    int D) {
  gmm_tiles<MT, false>(&h_map, &w_map, &w_map, out, E, C, F, D);
}

// Tensor maps of a (E, C, K) and the weights w (and w_2 for B7) as
// (E, K, N), then the launch of `grid_x` persistent blocks.
template <int MT, bool UP>
int launch(const void* a, const void* w, const void* w_2, void* out, int E,
           int C, int K, int N, int grid_x, cudaStream_t st) {
  using P = Plan<MT>;
  CUtensorMap a_map, w_map, w2_map;
  const uint64_t a_dims[3] = {(uint64_t)K, (uint64_t)C, (uint64_t)E};
  const uint64_t a_strides[2] = {(uint64_t)K * 2, (uint64_t)C * K * 2};
  const uint32_t a_box[3] = {BK, P::BM, 1};
  const uint64_t w_dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t w_strides[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t w_box[3] = {64, BK, 1};
  int err = hopper::make_tensor_map(&a_map, a, 3, a_dims, a_strides, a_box);
  if (!err) err = hopper::make_tensor_map(&w_map, w, 3, w_dims, w_strides, w_box);
  if (!err && UP) {
    err = hopper::make_tensor_map(&w2_map, w_2, 3, w_dims, w_strides, w_box);
  }
  if (err) return err;
  auto* po = static_cast<__nv_bfloat16*>(out);
  // above 48 KB only after opting in (per device, so on every launch)
  cudaError_t attr;
  if constexpr (UP) {
    attr = cudaFuncSetAttribute(gmm_up_kernel<MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                P::SMEM);
    if (attr != cudaSuccess) return (int)attr;
    gmm_up_kernel<MT><<<grid_x, THREADS, P::SMEM, st>>>(a_map, w_map, w2_map,
                                                        po, E, C, K, N);
  } else {
    attr = cudaFuncSetAttribute(gmm_down_kernel<MT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                P::SMEM);
    if (attr != cudaSuccess) return (int)attr;
    gmm_down_kernel<MT><<<grid_x, THREADS, P::SMEM, st>>>(a_map, w_map, po, E,
                                                          C, K, N);
  }
  return (int)cudaGetLastError();
}

template <bool UP>
int launch_rows(const void* a, const void* w, const void* w_2, void* out,
                int E, int C, int K, int N, int row_tiles, int grid_x,
                cudaStream_t st) {
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if (row_tiles == 1) return launch<1, UP>(a, w, w_2, out, E, C, K, N, grid_x, st);
  if (row_tiles == 2) return launch<2, UP>(a, w, w_2, out, E, C, K, N, grid_x, st);
  if (row_tiles == 4) return launch<4, UP>(a, w, w_2, out, E, C, K, N, grid_x, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All operands bf16, contiguous, 16-byte aligned, the contraction and
// output widths multiples of 8.  `row_tiles` (1, 2 or 4 m64 tiles a row
// group) and `grid_x` (persistent blocks, at most one an SM) come from the
// wrapper's launch plan.
//
// B7: x (E, C, D), w1 and w3 (E, D, F), out (E, C, F).
extern "C" int moe_gmm_up_launch(const void* x, const void* w1, const void* w3,
                                 void* out, int E, int C, int D, int F,
                                 int row_tiles, int grid_x, void* stream) {
  return launch_rows<true>(x, w1, w3, out, E, C, D, F, row_tiles, grid_x,
                           (cudaStream_t)stream);
}

// B8: h (E, C, F), w2 (E, F, D), out (E, C, D).
extern "C" int moe_gmm_down_launch(const void* h, const void* w2, void* out,
                                   int E, int C, int F, int D, int row_tiles,
                                   int grid_x, void* stream) {
  return launch_rows<false>(h, w2, w2, out, E, C, F, D, row_tiles, grid_x,
                            (cudaStream_t)stream);
}
