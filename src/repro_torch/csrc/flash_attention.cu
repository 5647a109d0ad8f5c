// Causal GQA flash attention with an online softmax, kernel B4.
//
// Replaces: src/repro/kernels/flash_attention.py `_flash_kernel` (launched by
// `flash_attention`).  On the TPU its grid is (B*H, Sq/128, Sk/128) with the
// key axis innermost and sequential: m, l and the output accumulator live in
// VMEM scratch across the key blocks, and the BlockSpec index map fetches
// K/V of query head h from KV group h // G.  Here one block owns one
// (batch, head, 128-row query tile) and walks the key tiles itself, so
// nothing carries between blocks:
//
//   q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D); bf16
//   s     = (q @ k_tile^T) * scale      (float32; masked entries excluded)
//   m_new = max(m, rowmax(s));  p = exp(s - m_new) (0 where masked)
//   corr  = exp(m - m_new);     l = l * corr + rowsum(p)
//   acc   = acc * corr + bf16(p) @ v_tile
//   out   = acc / max(l, 1e-30)
//
// What bounds it on an H100: at (8, 4096, 14, 64) the causal half needs
// 4*B*H*(S^2/2)*D = 0.24 TFLOP of bf16 products against 0.13 GB of inputs
// and output, so the tensor cores (0.24 ms at 989 TFLOP/s).  Only wgmma
// reaches their full rate.  At D = 64 one exponential per (query, key)
// pair stands against 4*64 = 256 tensor-core operations: the SM's 16 MUFU
// ops a clock take as long as its ~4096 bf16 tensor ops a clock, so the
// softmax must run under the products.  What each piece does about it:
//
// - Three warpgroups a block.  Warpgroup 0 is the producer: it gives up
//   its registers (setmaxnreg 24) and one thread issues TMA loads, Q once
//   and the 128-key K and V tiles of the KV group into a ring of 3 stages
//   at D = 64 (2 at D = 128) guarded by full and empty mbarriers.  Tensor
//   maps describe q, k and v as 4-D (D, heads, S, B) with 64 x 1 x 128 x 1
//   boxes, 128-byte swizzled; rows past Sq or Sk load as zeros (so p = 0
//   meets a zero V row, never an unread one).  At D = 128 a row is two
//   64-column boxes.
// - Warpgroups 1 and 2 own 64 query rows each (setmaxnreg 240).  S = Q K^T
//   is wgmma m64n128k16 with both operands in shared memory (K-major).
//   O += P V is wgmma m64n{D}k16 with A = P from registers: the float32 S
//   accumulators, packed as bf16 pairs, already have the register-A layout,
//   and V is read N-major through the descriptor's transpose bit (no
//   transpose in memory).
// - The two consumers take turns issuing their S products through two
//   named barriers, so one's softmax runs under the other's products.
//   (Issuing S_j together with P_{j-1} V_{j-1}, to run a consumer's own
//   softmax under its own products, measured slower on the H100.)
// - Softmax: scale * log2(e) is folded into one explicit fused multiply-add
//   per score and the exponential is ex2.approx (one MUFU op).  The causal
//   and Sk masks are computed only on tiles that straddle the diagonal or
//   Sk; there a masked score becomes -inf, so its p is exactly 0, as the
//   Pallas body's `* mask` gives.  The row max and row sum reduce across
//   the four lanes that share a row.
// - Key tiles wholly above the diagonal are never loaded (on such a tile
//   corr = 1 and p = 0, so skipping it changes no bit).  The heaviest query
//   tiles (last rows, most key tiles) are the grid's first row of blocks.
//
// Numerics: products of bf16 are exact in float32; sums run in the tensor
// cores' order and the exponential is ex2.approx (about 2 float32 ulps),
// unlike the plain version's float32 einsum and exp, so an output can land
// one bf16 ulp from it, or one bf16 rounding of p further.  The final
// division is IEEE (built with --fmad=false, no fast math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;            // query rows per block: two warpgroups of 64
constexpr int BK = 128;            // keys per tile
constexpr int THREADS = 384;       // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float M_INIT = -1e30f;   // running max before any key
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Plan {
  static constexpr int ATOMS = D / 64;            // 64-column boxes per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_TILE = BK * D * 2;      // one K or V tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_TILE + (1 + 2 * STAGES) * 8;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 64) {
    hopper::wgmma_m64n64k16_rs<1>(o, a, db);
  } else {
    hopper::wgmma_m64n128k16_rs<1>(o, a, db);
  }
}

// grid (B*H, ceil(Sq / BQ)): x = batch * H + head, y = query tile counted
// from the last, so the first row of blocks holds the heaviest tiles.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int KV, int causal, float scale) {
  using P = Plan<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;                              // ATOMS x (BQ rows x 128 B)
  uint8_t* skv = smem + P::Q_BYTES;                // per stage: K tile, V tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + P::STAGES * 2 * P::KV_TILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + P::STAGES;

  const int nq = (Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.y;        // heaviest tiles first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / KV);                      // the KV group of head h
  const int q0 = qt * BQ;
  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, Sq) - 1) / BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: Q once, then the key tiles in order through the ring
    regs_shrink<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, P::Q_BYTES);
#pragma unroll
      for (int a = 0; a < P::ATOMS; ++a) {
        tma_load_4d(sq + a * BQ * 128, &q_map, q_full, 64 * a, h, q0, b);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_kv; ++j) {
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* kt = skv + s * 2 * P::KV_TILE;
        uint8_t* vt = kt + P::KV_TILE;
        mbar_expect_tx(&full[s], 2 * P::KV_TILE);
#pragma unroll
        for (int a = 0; a < P::ATOMS; ++a) {
          tma_load_4d(kt + a * BK * 128, &k_map, &full[s], 64 * a, g, j * BK, b);
          tma_load_4d(vt + a * BK * 128, &v_map, &full[s], 64 * a, g, j * BK, b);
        }
        if (++s == P::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  regs_grow<CONSUMER_REGS>();
  const int c = wg - 1;                            // rows q0 + 64c .. + 63
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int row0 = q0 + 64 * c + 16 * warp + lane / 4;   // and row0 + 8
  const float sl2e = scale * LOG2E;
  const uint32_t q_addr = smem_u32(sq) + c * 64 * 128;
  const uint32_t kv_addr = smem_u32(skv);

  float m[2] = {M_INIT, M_INIT};   // running max of the raw scores
  float l[2] = {0.0f, 0.0f};       // this lane's share of the row sums
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float sc[64];
  uint32_t p[32];

  // turns on the tensor cores: consumer c waits on barrier 1 + c and hands
  // the turn on through barrier 2 - c; consumer 1 hands consumer 0 the
  // first turn and skips its last hand-off, so both barriers end balanced
  if (c == 1 && n_kv > 0) bar_arrive(1, 256);
  mbar_wait(q_full, 0);

  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    const uint32_t k_addr = kv_addr + s * 2 * P::KV_TILE;
    const uint32_t v_addr = k_addr + P::KV_TILE;
    mbar_wait(&full[s], phase);
    bar_sync(1 + c, 256);  // this consumer's turn

    // S = Q K^T for this warpgroup's 64 rows x 128 keys
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint32_t off = (kd / 4) * BQ * 128 + (kd % 4) * 32;
      const uint32_t koff = (kd / 4) * BK * 128 + (kd % 4) * 32;
      wgmma_m64n128k16_ss<0>(sc, sw128_desc(q_addr + off, 16, 1024),
                             sw128_desc(k_addr + koff, 16, 1024), kd > 0);
    }
    wgmma_commit();
    if (c == 0 || j + 1 < n_kv) bar_arrive(2 - c, 256);
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax; sc[i] sits at row row0 + 8 * ((i / 2) % 2), key
    // k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2
    const bool edge =
        (causal && k0 + BK - 1 > q0 + 64 * c) || k0 + BK > Sk;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (col >= Sk || (causal && col > row)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    }
    float corr[2], neg[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m[r] - mx[r]) * sl2e);
      neg[r] = -mx[r] * sl2e;
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i / 2) % 2;
      const float e = ex2(__fmaf_rn(sc[i], sl2e, neg[r]));
      sc[i] = e;
      sum[r] += e;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    // O += bf16(P) V: the k16 step kk takes p[4kk .. 4kk + 3] and keys
    // 16kk .. 16kk + 15 of the V tile (16 rows of 128 bytes further on)
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      pv_product<D>(o, a, sw128_desc(v_addr + 2048 * kk, BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (t == 0) mbar_arrive(&empty[s]);
    if (++s == P::STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < Sq) {
      __nv_bfloat16* dst = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int grid_x, int grid_y,
           float scale, cudaStream_t st) {
  using P = Plan<D>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int seq[3] = {Sq, Sk, Sk};
  const int heads[3] = {H, KV, KV};
  const uint32_t box[4] = {64, 1, BQ, 1};        // BQ == BK
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads[i],
                              (uint64_t)seq[i], (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads[i] * D * 2,
                                 (uint64_t)seq[i] * heads[i] * D * 2};
    const int err = hopper::make_tensor_map(&maps[i], ptrs[i], 4, dims,
                                            strides, box);
    if (err) return err;
  }
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_kernel<D><<<dim3(grid_x, grid_y), THREADS, P::SMEM, st>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), Sq, Sk, H,
      KV, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D); all bf16,
// contiguous, 16-byte aligned; H a multiple of KV; D 64 or 128.  The grid
// (grid_x = B * H, grid_y = query tiles) comes from the wrapper's launch
// plan.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KV, int D, int causal,
                                      int grid_x, int grid_y, float scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (grid_x != B * H || grid_y != (Sq + BQ - 1) / BQ) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (D == 64) {
    return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, grid_x, grid_y,
                      scale, st);
  }
  if (D == 128) {
    return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, grid_x, grid_y,
                       scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
