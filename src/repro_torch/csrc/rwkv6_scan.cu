// Chunked WKV6 scan (RWKV6 linear attention with data-dependent decay),
// kernel B5.
//
// Replaces: src/repro/kernels/rwkv6_scan.py `_wkv_kernel` (launched by
// `rwkv6_scan`).  On the TPU its grid is (B*H, chunks) with the chunk axis
// sequential and the (Dk, Dv) state carried in VMEM scratch.  Here one
// block owns one (batch, head) pair and walks its chunks of C = 32 steps in
// a loop, the float32 state carried from s0 to s_final.  Per chunk it
// evaluates the Pallas body's quadratic form:
//
//   cw      = cumsum(w)                       (w = log_w <= 0, per channel)
//   att_ij  = sum_d r_id exp(clip(cw_{i-1,d} - cw_jd, -60, 0)) k_jd,  j < i
//   out_i   = (r_i * exp(cw_{i-1})) @ S + sum_j att_ij v_j + (r_i.u.k_i) v_i
//   S'      = exp(cw_C)^T * S + (k * exp(cw_C - cw))^T @ v
//
// (cw_{i-1} is the previous row's cumsum, 0 for the chunk's first row; the
// Pallas body writes it cw_i - w_i.)  Rows past S (the last chunk's
// padding) load as zeros: log_w = 0 leaves the cumsum unchanged and k = v
// = 0 add nothing.
//
// Bound on an H100 at rwkv6-7b's prefill, (B, S, H, D) = (16, 128, 64,
// 64): bytes.  It reads and writes 151 MB (bf16 r/k/v, float32 log_w, state
// in and out, float32 output): 45 us at 3.35 TB/s.  The algorithm below
// issues per chunk and head 328 K multiply-adds on the tensor cores (the
// inter term 32 x 64 x 64, the off-diagonal block 16 x 16 x 64, att @ v
// over the 16 and 32 columns its two row halves see, the state update 64 x
// 32 x 64), three or two times over for the split below: 6.6 GFLOP of TF32
// in all, 13 us at 495 TFLOP/s; and 15.4 K pairwise exponentials (two 16 x
// 16 triangles x 64 channels) with their float32 operations, 6.1 K
// per-element ones, the scan and the operand splits: 0.87 GFLOP of float32
// work, 13 us at 67 TFLOP/s (chip_smoke.py's `wkv_cost` counts both).
//
// Design:
//
// - Loads.  The next chunk's r, k, v (bf16) and log_w (float32) are copied
//   with cp.async into the other half of a double buffer at the start of
//   each chunk, under this chunk's work; 16-byte pieces, XOR-swizzled by row
//   so that a warp reading one 8-channel piece of 32 rows meets no bank
//   conflict.  r, k and v are read from this stage all chunk long: bf16
//   values are exact TF32 operands.
// - Cumsum.  Lane i of a warp holds row i of eight channels; cw is a warp
//   scan (shuffles), and cw_{i-1}, cw_15 and cw_31 are shuffles too.
// - Factored decay.  The chunk is split into two sub-chunks of 16 rows at
//   boundary b = 15.  For i >= 16 > j the decay factors exactly:
//     exp(cw_{i-1} - cw_j) = exp(cw_{i-1} - cw_b) * exp(cw_b - cw_j),
//   and both exponents are <= 0 whatever log_w is, so nothing overflows
//   (a factorisation against the chunk start, exp(cw_{i-1}) exp(-cw_j),
//   overflows float32 once -cw_j passes 88: the model clamps a step's log
//   decay to [-54.6, 0), so a chunk's cumsum reaches about -1750).  The
//   off-diagonal 16 x 16 block is then the product q~ k~^T of
//   q~_i = r_i exp(cw_{i-1} - cw_b) and k~_j = k_j exp(cw_b - cw_j), both
//   computed with the cumsum, on the tensor cores (four warps: two n8
//   tiles x two halves of the channels, the second half added where att
//   is read).  Dropping the -60 clip there changes only terms whose true
//   exponent is below -60: the reference adds exp(-60) r k ~ 8.7e-27 |r||k|
//   for each, the factored form something smaller or 0, far below the
//   1e-4 contract.  Only the two diagonal 16 x 16 triangles keep the
//   pairwise exp(clip(cw_{i-1} - cw_j, -60, 0)): their 240 (i, j) pairs go
//   one to a thread, so every lane works, eight channels a step from
//   16-byte loads.
// - Contractions.  The inter term, the off-diagonal block, att @ v and the
//   state update run as mma.sync m16n8k8 TF32 products with the 3xTF32
//   split (a = a_hi + a_lo; a_lo b_hi + a_hi b_lo + a_hi b_hi), which keeps
//   about float32 accuracy: one TF32 pass (10-bit mantissa) would err by
//   the order of the 1e-4 contract itself.  Where b is v (bf16, exact in
//   TF32) b_lo is 0 and two products suffice.  The split rounds with
//   integer operations, not cvt.  The float32 arrays are XOR-swizzled so
//   that the fragment loads of both operand shapes and the row-per-lane
//   stores meet no bank conflict.
// - Exponentials go through ex2.approx: the exponent's difference is taken
//   first, in float32 as the reference does, then scaled by log2(e) in one
//   multiply.
// - State.  The (D, D) state stays in registers as the state update's
//   accumulators (16 floats a thread at D = 64), decayed and updated there;
//   a copy in shared memory feeds the next chunk's inter term.  ptxas fits
//   this in 128 registers without spills (two 256-thread blocks an SM,
//   100,352 bytes of shared memory each) once the inter term's and att @
//   v's step loops are not unrolled; unrolled, it spilled.
// - Three barriers a chunk: after the loads and cumsum, after att, and
//   after the outputs and the state update.
//
// Exactness: float32 throughout except the 3xTF32 products, no fast math
// beyond ex2.approx.  It is held against the plain PyTorch version at
// 1e-4 of max|plain|: the cumsum and the contractions sum in another
// order, and ex2.approx is not expf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int C = 32;            // chunk length
constexpr int SUB = 16;          // sub-chunk length: boundary b = SUB - 1
constexpr int THREADS = 256;     // eight warps
constexpr int WARPS = THREADS / 32;
constexpr int PAIRS = SUB * (SUB - 1);   // strict lower triangles of both sub-blocks
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Element (row, col) of a swizzled float array with rows of PW floats lives
// at row * PW + (col ^ swz(row)).  swz_a: conflict-free for A-fragment loads
// (lanes at rows g, columns t), swz_b: for B-fragment loads (rows t,
// columns g); both are one-to-one on 32 rows, so a warp storing one column
// of 32 rows, or reading one column of distinct rows, meets no conflict.
__device__ __forceinline__ int swz_a(int row) {
  return ((row & 7) << 2) | ((row >> 3) & 3);
}
__device__ __forceinline__ int swz_b(int row) {
  return ((row & 3) << 3) | ((row >> 2) & 7);
}

template <int D>
struct Layout {
  static constexpr int PW = D < 32 ? 32 : D;   // pitch of swizzled arrays
  static constexpr int CP = D + 4;             // pitch of cw: 16-byte rows, 8 rows on 8 bank groups
  static constexpr int NT = D / 8;             // n8 tiles (and 8-channel pieces) of D
  // float arrays, offsets in floats
  static constexpr int CW = 0;                 // cumsum, C x CP
  static constexpr int RD = CW + C * CP;       // r exp(cw_{i-1})           (swz_a)
  static constexpr int QK = RD + C * PW;       // rows < 16: k~, else q~     (swz_a)
  static constexpr int KS = QK + C * PW;       // k exp(cw_C - cw)           (swz_b)
  static constexpr int S = KS + C * PW;        // state, D x D               (swz_b)
  static constexpr int ATT = S + D * PW;       // att, C x C                 (swz_a)
  static constexpr int ATT2 = ATT + C * C;     // 2nd half of att's off-diagonal block
  static constexpr int BON = ATT2 + C * C;     // bonus partials, NT x C
  static constexpr int E = BON + NT * C;       // exp(cw_C), D
  static constexpr int U = E + D;              // u, D
  static constexpr int FLOATS = U + D;
  // raw chunk as loaded: r, k, v bf16 then log_w float32, C x D each; r,
  // k and v are read from here all chunk long
  static constexpr int RAW_BYTES = 3 * C * D * 2 + C * D * 4;
  static constexpr int BYTES = FLOATS * 4 + 2 * RAW_BYTES;
  static constexpr int XB = (NT < 8 ? NT : 8) - 1;        // bf16 piece swizzle
  static constexpr int XW = (D / 4 < 8 ? D / 4 : 8) - 1;  // float32 piece swizzle
};

// Byte offset of bf16 element (row, d) in a raw array: rows of D bf16 in
// 16-byte pieces, piece p of a row stored at p ^ (row & XB).
template <int D>
__device__ __forceinline__ int raw_at(int row, int d) {
  return row * D * 2 + 16 * ((d >> 3) ^ (row & Layout<D>::XB)) + 2 * (d & 7);
}

// 16 bytes global -> shared; zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// e^x for x = a difference already taken: one multiply by log2(e), ex2.approx.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

// bf16 as float32 bits (also an exact TF32 operand)
__device__ __forceinline__ uint32_t bf16_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t w) {
  return w & 0xffff0000u;
}
__device__ __forceinline__ uint32_t bf16_bits(const uint8_t* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16;
}

// x rounded to TF32 (nearest, ties away), as float32 bits
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8) a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (t, g),
// b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).  An operand x = hi + lo, both TF32 (the remainder
// of the rounding is exact in float32, and its own TF32 rounding leaves
// about 2^-21 of x).
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Frag split4(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  Frag f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f.hi[e] = tf32(a[e]);
    f.lo[e] = tf32(a[e] - __uint_as_float(f.hi[e]));
  }
  return f;
}

// d += a @ b to about float32 accuracy: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Frag& a,
                                           float b0, float b1) {
  const uint32_t bh0 = tf32(b0), bh1 = tf32(b1);
  const uint32_t bl0 = tf32(b0 - __uint_as_float(bh0));
  const uint32_t bl1 = tf32(b1 - __uint_as_float(bh1));
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// d += a @ b for b exact in TF32 (bf16 values): a_lo b + a_hi b.
__device__ __forceinline__ void mma_2xtf32(float (&d)[4], const Frag& a,
                                           uint32_t b0, uint32_t b1) {
  mma_tf32(d, a.lo, b0, b1);
  mma_tf32(d, a.hi, b0, b1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    wkv_kernel(const uint16_t* __restrict__ r_in,
               const uint16_t* __restrict__ k_in,
               const uint16_t* __restrict__ v_in,
               const float* __restrict__ w_in, const float* __restrict__ u_in,
               const float* __restrict__ s0, float* __restrict__ out,
               float* __restrict__ s_final, int S, int H) {
  using L = Layout<D>;
  constexpr int PW = L::PW;
  constexpr int CP = L::CP;
  constexpr int NT = L::NT;
  constexpr int MTS = D / 16;                       // m16 tiles of the state
  constexpr int OUT_Q = (2 * NT + WARPS - 1) / WARPS;          // out tiles a warp
  constexpr int ST_Q = (MTS * NT + WARPS - 1) / WARPS;         // state tiles a warp
  extern __shared__ __align__(16) float smem[];
  float* sCW = smem + L::CW;
  float* sRD = smem + L::RD;
  float* sQK = smem + L::QK;
  float* sKS = smem + L::KS;
  float* sS = smem + L::S;
  float* sATT = smem + L::ATT;
  float* sATT2 = smem + L::ATT2;
  float* sBON = smem + L::BON;
  float* sE = smem + L::E;
  float* sU = smem + L::U;
  uint8_t* raw = reinterpret_cast<uint8_t*>(smem + L::FLOATS);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t row_stride = (size_t)H * D;  // one time step of (H, D)
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const int n_chunks = (S + C - 1) / C;

  // the next chunk's raw rows into buffer `buf`, swizzled by row
  auto stage = [&](int ch, int buf) {
    uint8_t* dst = raw + buf * L::RAW_BYTES;
    const int t0 = ch * C;
    constexpr int BF_PIECES = C * NT;        // 16-byte pieces of one bf16 array
    constexpr int W_PIECES = C * D / 4;
    for (int p = tid; p < 3 * BF_PIECES + W_PIECES; p += THREADS) {
      if (p < 3 * BF_PIECES) {
        const int arr = p / BF_PIECES;
        const int row = (p % BF_PIECES) / NT;
        const int piece = p % NT;
        const uint16_t* src = arr == 0 ? r_in : (arr == 1 ? k_in : v_in);
        const bool ok = t0 + row < S;
        const size_t off = base + (size_t)(ok ? t0 + row : 0) * row_stride;
        cp_async16(dst + arr * C * D * 2 + raw_at<D>(row, 8 * piece),
                   src + off + 8 * piece, ok);
      } else {
        const int q = p - 3 * BF_PIECES;
        const int row = q / (D / 4);
        const int piece = q % (D / 4);
        const bool ok = t0 + row < S;
        const size_t off = base + (size_t)(ok ? t0 + row : 0) * row_stride;
        cp_async16(dst + 3 * C * D * 2 + row * D * 4 +
                       16 * (piece ^ (row & L::XW)),
                   w_in + off + 4 * piece, ok);
      }
    }
    cp_async_commit();
  };

  // this thread's diagonal pair: sub-block s, row i' > column j' of its
  // strict lower triangle, enumerated row by row
  int pi = 1, pj = 0;
  if (tid < PAIRS) {
    const int s = tid / (PAIRS / 2);
    const int q = tid % (PAIRS / 2);
    int i = 1;
    while (i * (i + 1) / 2 <= q) ++i;
    pi = SUB * s + i;
    pj = SUB * s + q - i * (i - 1) / 2;
  }

  // state tiles of this warp: tile w + WARPS * q is m16 tile (.) % MTS,
  // n8 tile (.) / MTS; accumulators in the C-fragment layout
  float sacc[ST_Q][4];
  const float* s_in = s0 + (size_t)bh * D * D;
#pragma unroll
  for (int q = 0; q < ST_Q; ++q) {
    const int tile = warp + WARPS * q;
    if (tile < MTS * NT) {
      const int r0 = 16 * (tile % MTS) + g;
      const int c0 = 8 * (tile / MTS) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e / 2);
        const int col = c0 + e % 2;
        sacc[q][e] = s_in[row * D + col];
        sS[row * PW + (col ^ swz_b(row))] = sacc[q][e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[q][e] = 0.f;
    }
  }
  for (int i = tid; i < C * C; i += THREADS) sATT[i] = 0.f;   // j >= i stays 0
  for (int i = tid; i < D; i += THREADS) sU[i] = u_in[(size_t)h * D + i];

  if (n_chunks > 0) stage(0, 0);
  cp_async_wait_all();
  __syncthreads();

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * C;
    if (ch + 1 < n_chunks) stage(ch + 1, (ch + 1) & 1);
    const uint8_t* rawr = raw + (ch & 1) * L::RAW_BYTES;   // this chunk's r
    const uint8_t* rawk = rawr + C * D * 2;
    const uint8_t* rawv = rawk + C * D * 2;

    // ---- phase 1: unpack, cumsum, per-element decays; lane = row -------
    if (warp < NT) {
      const int i = lane;
      const int pb = raw_at<D>(i, 8 * warp);
      const uint4 r4 = *reinterpret_cast<const uint4*>(rawr + pb);
      const uint4 k4 = *reinterpret_cast<const uint4*>(rawk + pb);
      const float* wrow =
          reinterpret_cast<const float*>(rawv + C * D * 2 + i * D * 4);
      const float4 wa = *reinterpret_cast<const float4*>(
          wrow + 4 * ((2 * warp) ^ (i & L::XW)));
      const float4 wb = *reinterpret_cast<const float4*>(
          wrow + 4 * ((2 * warp + 1) ^ (i & L::XW)));
      const uint32_t rw[4] = {r4.x, r4.y, r4.z, r4.w};
      const uint32_t kw[4] = {k4.x, k4.y, k4.z, k4.w};
      const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      float bonus = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int d = 8 * warp + m;
        const float r = __uint_as_float(m % 2 ? bf16_hi(rw[m / 2])
                                              : bf16_lo(rw[m / 2]));
        const float k = __uint_as_float(m % 2 ? bf16_hi(kw[m / 2])
                                              : bf16_lo(kw[m / 2]));
        float cw = w8[m];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(FULL, cw, off);
          if (i >= off) cw = cw + y;
        }
        float cwp = __shfl_up_sync(FULL, cw, 1);    // cw_{i-1}
        if (i == 0) cwp = 0.f;
        const float c_b = __shfl_sync(FULL, cw, SUB - 1);
        const float c_last = __shfl_sync(FULL, cw, C - 1);
        const int a = i * PW + (d ^ swz_a(i));
        sCW[i * CP + d] = cw;
        sRD[a] = r * exp_approx(cwp);
        // k~_i = k_i exp(cw_b - cw_i) above the boundary, q~_i = r_i
        // exp(cw_{i-1} - cw_b) below it: both exponents <= 0
        const bool below = i >= SUB;
        sQK[a] = (below ? r : k) *
                 exp_approx(fminf(below ? cwp - c_b : c_b - cw, 0.f));
        sKS[i * PW + (d ^ swz_b(i))] = k * exp_approx(c_last - cw);
        if (i == 0) sE[d] = exp_approx(c_last);
        bonus = bonus + r * sU[d] * k;
      }
      sBON[warp * C + i] = bonus;
    }
    __syncthreads();

    // ---- phase 2: inter term, off-diagonal block, diagonal pairs -------
    // output tile w + WARPS * q: m16 tile (w & 1), n8 tile (w >> 1) + 4q
    const int mt = warp & 1;
    float oacc[OUT_Q][4];
#pragma unroll
    for (int q = 0; q < OUT_Q; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[q][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < NT; ++ks) {
      const int r0 = 16 * mt + g, r1 = r0 + 8;
      const int c0 = 8 * ks + t, c1 = c0 + 4;
      const Frag a = split4(sRD[r0 * PW + (c0 ^ swz_a(r0))],
                            sRD[r1 * PW + (c0 ^ swz_a(r1))],
                            sRD[r0 * PW + (c1 ^ swz_a(r0))],
                            sRD[r1 * PW + (c1 ^ swz_a(r1))]);
#pragma unroll
      for (int q = 0; q < OUT_Q; ++q) {
        const int nt = (warp >> 1) + (WARPS / 2) * q;
        if (nt < NT) {
          const int col = 8 * nt + g;
          mma_3xtf32(oacc[q], a, sS[c0 * PW + (col ^ swz_b(c0))],
                     sS[c1 * PW + (col ^ swz_b(c1))]);
        }
      }
    }
    if (warp < 4) {
      // att[16 + .][8 (w & 1) + .] = q~ k~^T over the channel half w >> 1;
      // the second half goes to ATT2 and is added where att is read
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int i0 = SUB + g, i1 = i0 + 8;
      const int j = 8 * (warp & 1) + g;
      const int half = warp >> 1;
#pragma unroll 2
      for (int ks = half * NT / 2; ks < (half + 1) * NT / 2; ++ks) {
        const int c0 = 8 * ks + t, c1 = c0 + 4;
        const Frag a = split4(sQK[i0 * PW + (c0 ^ swz_a(i0))],
                              sQK[i1 * PW + (c0 ^ swz_a(i1))],
                              sQK[i0 * PW + (c1 ^ swz_a(i0))],
                              sQK[i1 * PW + (c1 ^ swz_a(i1))]);
        mma_3xtf32(acc, a, sQK[j * PW + (c0 ^ swz_a(j))],
                   sQK[j * PW + (c1 ^ swz_a(j))]);
      }
      const int jc = 8 * (warp & 1) + 2 * t;
      float* dst = half ? sATT2 : sATT;
      dst[i0 * C + (jc ^ swz_a(i0))] = acc[0];
      dst[i0 * C + ((jc + 1) ^ swz_a(i0))] = acc[1];
      dst[i1 * C + (jc ^ swz_a(i1))] = acc[2];
      dst[i1 * C + ((jc + 1) ^ swz_a(i1))] = acc[3];
    }
    if (tid < PAIRS) {
      // a pair of a diagonal sub-block: the pairwise clipped decay, eight
      // channels a step (one 16-byte piece of r and k, two of each cw row)
      float acc = 0.f;
      const float* cwi = sCW + (pi - 1) * CP;
      const float* cwj = sCW + pj * CP;
#pragma unroll 1
      for (int p = 0; p < NT; ++p) {
        const uint4 r4 =
            *reinterpret_cast<const uint4*>(rawr + raw_at<D>(pi, 8 * p));
        const uint4 k4 =
            *reinterpret_cast<const uint4*>(rawk + raw_at<D>(pj, 8 * p));
        const float4 ci0 = *reinterpret_cast<const float4*>(cwi + 8 * p);
        const float4 ci1 = *reinterpret_cast<const float4*>(cwi + 8 * p + 4);
        const float4 cj0 = *reinterpret_cast<const float4*>(cwj + 8 * p);
        const float4 cj1 = *reinterpret_cast<const float4*>(cwj + 8 * p + 4);
        const uint32_t rw[4] = {r4.x, r4.y, r4.z, r4.w};
        const uint32_t kw[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ci[8] = {ci0.x, ci0.y, ci0.z, ci0.w,
                             ci1.x, ci1.y, ci1.z, ci1.w};
        const float cj[8] = {cj0.x, cj0.y, cj0.z, cj0.w,
                             cj1.x, cj1.y, cj1.z, cj1.w};
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float r = __uint_as_float(m % 2 ? bf16_hi(rw[m / 2])
                                                : bf16_lo(rw[m / 2]));
          const float k = __uint_as_float(m % 2 ? bf16_hi(kw[m / 2])
                                                : bf16_lo(kw[m / 2]));
          const float x = fminf(fmaxf(ci[m] - cj[m], -60.f), 0.f);
          acc = __fmaf_rn(r * exp_approx(x), k, acc);
        }
      }
      sATT[pi * C + (pj ^ swz_a(pi))] = acc;
    }
    __syncthreads();

    // ---- phase 3: out = inter + att @ v + bonus; state update ----------
    // rows 0-15 attend only to columns 0-15; v (bf16) is an exact TF32
    // operand, so two products suffice
#pragma unroll 1
    for (int ks = 0; ks < C / 8; ++ks) {
      if (mt == 0 && ks >= SUB / 8) break;
      const int r0 = 16 * mt + g, r1 = r0 + 8;
      const int c0 = 8 * ks + t, c1 = c0 + 4;
      const int o00 = r0 * C + (c0 ^ swz_a(r0)), o10 = r1 * C + (c0 ^ swz_a(r1));
      const int o01 = r0 * C + (c1 ^ swz_a(r0)), o11 = r1 * C + (c1 ^ swz_a(r1));
      float a00 = sATT[o00], a10 = sATT[o10], a01 = sATT[o01], a11 = sATT[o11];
      if (mt == 1 && ks < SUB / 8) {     // the off-diagonal block's 2nd half
        a00 = a00 + sATT2[o00];
        a10 = a10 + sATT2[o10];
        a01 = a01 + sATT2[o01];
        a11 = a11 + sATT2[o11];
      }
      const Frag a = split4(a00, a10, a01, a11);
#pragma unroll
      for (int q = 0; q < OUT_Q; ++q) {
        const int nt = (warp >> 1) + (WARPS / 2) * q;
        if (nt < NT) {
          const int col = 8 * nt + g;
          mma_2xtf32(oacc[q], a, bf16_bits(rawv + raw_at<D>(c0, col)),
                     bf16_bits(rawv + raw_at<D>(c1, col)));
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 16 * mt + g + 8 * hf;
      float bon = 0.f;
#pragma unroll
      for (int p = 0; p < NT; ++p) bon = bon + sBON[p * C + i];
      if (t0 + i >= S) continue;
      float* dst = out + base + (size_t)(t0 + i) * row_stride;
#pragma unroll
      for (int q = 0; q < OUT_Q; ++q) {
        const int nt = (warp >> 1) + (WARPS / 2) * q;
        if (nt < NT) {
          const int col = 8 * nt + 2 * t;
          const uint32_t vw =
              *reinterpret_cast<const uint32_t*>(rawv + raw_at<D>(i, col));
          float2 o;
          o.x = oacc[q][2 * hf] + bon * __uint_as_float(bf16_lo(vw));
          o.y = oacc[q][2 * hf + 1] + bon * __uint_as_float(bf16_hi(vw));
          *reinterpret_cast<float2*>(dst + col) = o;
        }
      }
    }
    // S' = exp(cw_C) * S + (k exp(cw_C - cw))^T @ v, in the accumulators.
    // A warp's state tiles w + WARPS q share their m16 tile (w % MTS: MTS
    // divides WARPS), so one A fragment a step serves all of them.
    const int d0 = 16 * (warp % MTS) + g, d1 = d0 + 8;
    {
      const float e0 = sE[d0], e1 = sE[d1];
#pragma unroll
      for (int q = 0; q < ST_Q; ++q) {
        sacc[q][0] = e0 * sacc[q][0];
        sacc[q][1] = e0 * sacc[q][1];
        sacc[q][2] = e1 * sacc[q][2];
        sacc[q][3] = e1 * sacc[q][3];
      }
    }
    if (warp < MTS * NT) {
#pragma unroll
      for (int ks = 0; ks < C / 8; ++ks) {
        const int j0 = 8 * ks + t, j1 = j0 + 4;
        const Frag a = split4(sKS[j0 * PW + (d0 ^ swz_b(j0))],
                              sKS[j0 * PW + (d1 ^ swz_b(j0))],
                              sKS[j1 * PW + (d0 ^ swz_b(j1))],
                              sKS[j1 * PW + (d1 ^ swz_b(j1))]);
#pragma unroll
        for (int q = 0; q < ST_Q; ++q) {
          const int tile = warp + WARPS * q;
          if (tile >= MTS * NT) continue;
          const int col = 8 * (tile / MTS) + g;
          mma_2xtf32(sacc[q], a, bf16_bits(rawv + raw_at<D>(j0, col)),
                     bf16_bits(rawv + raw_at<D>(j1, col)));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ST_Q; ++q) {
      const int tile = warp + WARPS * q;
      if (tile >= MTS * NT) continue;
      const int d0 = 16 * (tile % MTS) + g;
      const int c0 = 8 * (tile / MTS) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = d0 + 8 * (e / 2);
        const int cc = c0 + e % 2;
        sS[row * PW + (cc ^ swz_b(row))] = sacc[q][e];
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  float* s_out = s_final + (size_t)bh * D * D;
#pragma unroll
  for (int q = 0; q < ST_Q; ++q) {
    const int tile = warp + WARPS * q;
    if (tile < MTS * NT) {
      const int r0 = 16 * (tile % MTS) + g;
      const int c0 = 8 * (tile / MTS) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_out[(r0 + 8 * (e / 2)) * D + c0 + e % 2] = sacc[q][e];
      }
    }
  }
}

template <int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_final, int B,
           int S, int H, cudaStream_t st) {
  const int bytes = Layout<D>::BYTES;
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
// (B, H, D, D) float32; all contiguous, r, k, v and w 16-byte aligned.  D
// is 16, 32 or 64.
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
