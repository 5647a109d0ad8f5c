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
//   s     = (q @ k_tile^T) * scale      (float32; masked entries -1e30)
//   m_new = max(m, rowmax(s));  p = exp(s - m_new) (0 where masked)
//   corr  = exp(m - m_new);     l = l * corr + rowsum(p)
//   acc   = acc * corr + bf16(p) @ v_tile
//   out   = acc / max(l, 1e-30)
//
// Eight warps own 16 query rows each.  The Q tile and two stages of K/V
// tiles (128 keys each) sit in dynamic shared memory, loaded with cp.async
// (the next tile's loads in flight while the current one is computed);
// rows are padded by 8 elements so ldmatrix reads no bank twice.  Both
// products run on mma.sync m16n8k16 (bf16 in, float32 accumulate): Q @ K^T
// with fragments from ldmatrix, P @ V with P's float32 accumulators
// repacked in registers as the A operand and V through ldmatrix.trans.
// Row max and row sum are reduced across the four lanes that share a row.
//
// Causal: key tiles wholly above the diagonal are skipped.  That is
// bit-safe: on such a tile every entry is masked, so m is unchanged, corr
// is exp(0) = 1 and p = 0, and l and acc keep their bits.  Rows past Sq are
// zero-filled on load and never written; keys past Sk are zero-filled and
// masked.  The heaviest query tiles (last rows, most key tiles) launch
// first.
//
// Bound on an H100: at (8, 4096, 14, 64) the causal half needs
// 4*B*H*(S^2/2)*D = 0.24 TFLOP of bf16 products against 0.13 GB of
// inputs and output, so it is bound by the tensor cores (0.24 ms at 989
// TFLOP/s).  mma.sync, not wgmma, caps this kernel well below that.
//
// Numerics: products of bf16 are exact in float32; sums run in the tensor
// cores' order, unlike the plain version's float32 einsum, so an output can
// land one bf16 ulp from it.  exp is expf and the division IEEE (built
// with --fmad=false, no fast math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;            // query rows per block
constexpr int BK = 128;            // keys per tile
constexpr int WARPS = BQ / 16;     // one warp per 16 query rows
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;

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

// Two floats as a bf16 pair (x in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// `rows` x D tile of a (.., S, heads, D) tensor: rows r0 .. r0 + rows - 1 of
// head `head` (row stride heads * D) into shared memory with row stride
// D + 8; rows at or past `S` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base, int r0,
                                          int S, int heads, int head,
                                          int rows) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool ok = r0 + r < S;
    const __nv_bfloat16* src =
        base + ((size_t)(ok ? r0 + r : 0) * heads + head) * D + c;
    cp_async16(dst + r * (D + 8) + c, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int KV, int causal, float scale) {
  constexpr int LD = D + 8;          // padded row, in elements
  constexpr int DT = D / 8;          // n8 tiles of the output
  constexpr int NT = BK / 8;         // n8 tiles of a score row block
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sq = smem;                      // BQ x LD
  __nv_bfloat16* skv = smem + BQ * LD;           // 2 stages x (K, V) x BK x LD

  const int nq = (Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;       // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / KV);                    // the KV group of head h
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;                      // fragment row in 0..7
  const int tq = lane & 3;                       // fragment column pair

  const __nv_bfloat16* qb = q + (size_t)b * Sq * H * D;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * KV * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * KV * D;

  int n_kv = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, Sq) - 1;
    n_kv = min(n_kv, last_row / BK + 1);
  }

  auto load_kv = [&](int stage, int j) {
    __nv_bfloat16* dk = skv + (size_t)stage * 2 * BK * LD;
    load_tile<D>(dk, kb, j * BK, Sk, KV, g, BK);
    load_tile<D>(dk + BK * LD, vb, j * BK, Sk, KV, g, BK);
  };

  load_tile<D>(sq, qb, q0, Sq, H, h, BQ);
  cp_async_commit();
  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  // rows gr and gr + 8 of this warp's 16
  const int row0 = q0 + warp * 16 + gr;
  const int rows[2] = {row0, row0 + 8};
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};         // this lane's share of the row sums
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int j = 0; j < n_kv; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_kv) load_kv(stage ^ 1, j + 1);
    cp_async_commit();
    cp_async_wait<1>();    // Q and tile j have landed
    __syncthreads();
    const __nv_bfloat16* sk = skv + (size_t)stage * 2 * BK * LD;
    const __nv_bfloat16* sv = sk + BK * LD;
    const int k0 = j * BK;

    // s = Q K^T for this warp's 16 rows x 128 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < D; kd += 16) {
      uint32_t a[4];
      ldsm_x4(a, sq + (warp * 16 + (lane & 15)) * LD + kd + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // keys np*16 + (0..7 | 8..15), dims kd + (0..7 | 8..15)
        uint32_t bk[4];
        ldsm_x4(bk, sk + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kd + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax, row by row (e = 0, 1: row gr; e = 2, 3: row gr + 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + n * 8 + tq * 2 + c;
          const bool ok = col < Sk && (!causal || col <= rows[r]);
          const float x = ok ? s[n][2 * r + c] * scale : NEG_INF;
          s[n][2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = s[n][2 * r + c];
          const float p = x == NEG_INF ? 0.0f : expf(x - m_new);
          s[n][2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }

    // acc += bf16(p) @ V: the accumulators of key tiles 2kk, 2kk + 1 are
    // the A fragment of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, sv + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                              (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();       // the next iteration's load overwrites stage ^ 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    if (rows[r] < Sq) {
      __nv_bfloat16* dst = out + (((size_t)b * Sq + rows[r]) * H + h) * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + tq * 2;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            o[dt][2 * r] / denom, o[dt][2 * r + 1] / denom);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, float scale,
           cudaStream_t st) {
  const size_t smem = (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16);
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<D><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), out (B, Sq, H, D); all bf16,
// contiguous, 16-byte aligned; H a multiple of KV; D 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KV, int D, int causal,
                                      float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, st);
  if (D == 128) return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
