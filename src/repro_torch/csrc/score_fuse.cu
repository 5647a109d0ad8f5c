// Masked Eq. 2-4 scoring for a whole request batch: kernel B1 of the port.
//
// Replaces: src/repro/kernels/score_fuse.py `_score_fuse_kernel` (launched by
// `_score_fuse_pallas`), which scores one request per call on a (2, nt) grid
// that runs in order: phase 0 carries seven scalars (masked min/max of area,
// slope, std and the masked C_min) in SMEM across tiles, phase 1 emits rows.
//
// Here the batch is one call of two kernels, on the grids of the wrapper's
// `score_plan`:
//   score_reduce_kernel  a K-split: block (g, y) owns lanes [g s, g s + s)
//                        of K and up to 32 rows (the U unique filter
//                        masks' six stat extrema, then the B requests'
//                        masked C_min = min p * ceil(R / cap)), 4 rows a
//                        warp and 4 lanes a thread.  A thread loads its 4
//                        rows' masks and its lanes' statistics and catalog
//                        values once, all before it computes (one memory
//                        round trip a slice); each warp folds its rows
//                        across its lanes through shared memory and writes
//                        one partial (lo, hi) sextuple or C_min per row and
//                        slice to scratch.
//   score_emit_kernel    a (ceil(K / 2048), B) grid: each block first
//                        merges the G partials of its request's row (and
//                        the blocks of column 0 write the merged extrema
//                        and C_min out), then writes the combined /
//                        availability / cost rows, 8 lanes a thread.
// Partials are merged at the head of the emit kernel rather than in a third
// launch: they lie row-major over the slices, so a block of 256 threads
// reads G <= 2 x SMs partials of a row in one coalesced load a thread, and
// a launch more would cost as much as the merge.
//
// Phase 0 alone (the K-sharded pipeline's per-shard carries, which it
// merges across shards before any row is emitted) is the reduce kernel and
//   score_merge_kernel   one block a row of the U extrema rows and the B
//                        C_min rows: the same merge, written out.
//
// Rows are read and written 16 bytes a thread (`float4`, masks as `uchar4`)
// when K is a multiple of 4 and every array starts on a 16-byte boundary
// (the wrapper decides: `vec_ok`); else every lane goes one by one.
//
// Bound on an H100: bytes.  Per call the function must read the (3, K)
// statistics, three (K,) catalog rows, the (B, K) and (U, K) byte masks and
// write three (B, K) float rows: about 13 bytes per request lane, against a
// handful of flops per lane.
//
// Exactness: min and max are exact, so the partials merge to the
// reference's scalars in any order (NaN propagates, as torch.amin does; a
// zero may come out as -0 where torch has +0 or back, which compares equal
// and moves no emitted value but a zero's sign).  Built with --fmad=false
// and without fast math, so `/` is IEEE div.rn and no multiply-add is
// contracted.  Each expression keeps
// the op order of `_emit_rows` / `_tile_total` (score_fuse.py:63-76), so on
// the same inputs the rows equal the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int REDUCE_WARPS = 8;
constexpr int REDUCE_THREADS = 32 * REDUCE_WARPS;
constexpr int RPW = 4;                               // rows a warp
constexpr int REDUCE_ROWS = REDUCE_WARPS * RPW;      // rows a block (grid y)
constexpr int EMIT_THREADS = 256;
constexpr int EMIT_GROUPS = 2;       // 4-lane groups a thread
constexpr int LANES = 4;             // lanes a group: one float4
constexpr unsigned FULL = 0xffffffffu;

// NaN-propagating min / max, as torch.amin / jnp.min: one instruction
// each (the sign of a zero result may differ from torch's, which compares
// equal)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Eq. 2 cost basis C_i = p_i * ceil(R / cap_i) (score_fuse.py:57-60).
__device__ __forceinline__ float total_cost(float price, float vcpu, float mem,
                                            bool use_cpus, float amount) {
  const float cap = use_cpus ? vcpu : mem;
  return price * ceilf(amount / cap);
}

// Elementwise tail of the masked MinMax (core/scoring.py `_minmax_from`).
__device__ __forceinline__ float minmax_norm(float x, float lo, float hi) {
  const float rng = hi - lo;
  return rng > 0.0f ? (x - lo) / rng : 0.0f;
}

// Four lanes k..k+3 of a float row: one 16-byte load, or lane by lane
// below `end` (the rest read as 0 and are masked out or not stored).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int k,
                                        int end) {
  if (VEC) return *reinterpret_cast<const float4*>(p + k);
  float4 r;
  r.x = k < end ? p[k] : 0.f;
  r.y = k + 1 < end ? p[k + 1] : 0.f;
  r.z = k + 2 < end ? p[k + 2] : 0.f;
  r.w = k + 3 < end ? p[k + 3] : 0.f;
  return r;
}

template <bool VEC>
__device__ __forceinline__ uchar4 mask4(const unsigned char* __restrict__ p,
                                        int k, int end) {
  if (VEC) return *reinterpret_cast<const uchar4*>(p + k);
  uchar4 r;
  r.x = k < end ? p[k] : 0;
  r.y = k + 1 < end ? p[k + 1] : 0;
  r.z = k + 2 < end ? p[k + 2] : 0;
  r.w = k + 3 < end ? p[k + 3] : 0;
  return r;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, int k, int end,
                                       float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(p + k) = v;
    return;
  }
  if (k < end) p[k] = v.x;
  if (k + 1 < end) p[k + 1] = v.y;
  if (k + 2 < end) p[k + 2] = v.z;
  if (k + 3 < end) p[k + 3] = v.w;
}

__device__ __forceinline__ float lane_of(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ bool lane_of(uchar4 m, int i) {
  return (i == 0 ? m.x : i == 1 ? m.y : i == 2 ? m.z : m.w) != 0;
}

template <bool IS_MIN>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = IS_MIN ? min_nan(v, w) : max_nan(v, w);
  }
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(REDUCE_THREADS) score_reduce_kernel(
    const float* __restrict__ stats, const float* __restrict__ prices,
    const float* __restrict__ vcpus, const float* __restrict__ memory_gb,
    const unsigned char* __restrict__ uniq_masks,
    const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ use_cpus,
    const float* __restrict__ amount, float* __restrict__ part_ext,
    float* __restrict__ part_cmin, int K, int n_ext, int n_cmin, int G,
    int slice) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = blockIdx.x;
  const int k0 = g * slice;
  const int k1 = min(K, k0 + slice);
  const int rows = n_ext + n_cmin;
  // this warp's rows: first + REDUCE_WARPS i, i < RPW (extrema rows first)
  const int first = blockIdx.y * REDUCE_ROWS + warp;
  const unsigned char* m[RPW];
  bool uc[RPW];
  float amt[RPW];
  float acc[RPW][6];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = first + REDUCE_WARPS * i;
    const int b = row - n_ext;
    m[i] = row < n_ext ? uniq_masks + (size_t)row * K
                       : masks + (size_t)min(b, n_cmin - 1) * K;
    uc[i] = row >= n_ext && row < rows && use_cpus[b] != 0;
    amt[i] = row >= n_ext && row < rows ? amount[b] : 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = j % 2 ? -CUDART_INF_F : CUDART_INF_F;
  }
  const bool any_ext = first < n_ext;
  const bool any_cmin =
      first + REDUCE_WARPS * (RPW - 1) >= n_ext && first < rows;
  for (int k = k0 + LANES * lane; k < k1; k += LANES * 32) {
    // every row's mask first, then the slice's operands: one round trip
    uchar4 mk[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      mk[i] = first + REDUCE_WARPS * i < rows ? mask4<VEC>(m[i], k, k1)
                                              : make_uchar4(0, 0, 0, 0);
    float4 x[3], p, v, mem;
    if (any_ext) {
#pragma unroll
      for (int s = 0; s < 3; ++s) x[s] = load4<VEC>(stats + (size_t)s * K, k, k1);
    }
    if (any_cmin) {
      p = load4<VEC>(prices, k, k1);
      v = load4<VEC>(vcpus, k, k1);
      mem = load4<VEC>(memory_gb, k, k1);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = first + REDUCE_WARPS * i;
      if (row < n_ext) {
#pragma unroll
        for (int s = 0; s < 3; ++s) {
#pragma unroll
          for (int l = 0; l < LANES; ++l) {
            const bool on = lane_of(mk[i], l);
            const float xl = lane_of(x[s], l);
            acc[i][2 * s] = min_nan(acc[i][2 * s], on ? xl : CUDART_INF_F);
            acc[i][2 * s + 1] =
                max_nan(acc[i][2 * s + 1], on ? xl : -CUDART_INF_F);
          }
        }
      } else if (row < rows) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const float total = total_cost(lane_of(p, l), lane_of(v, l),
                                         lane_of(mem, l), uc[i], amt[i]);
          acc[i][0] = min_nan(acc[i][0],
                              lane_of(mk[i], l) ? total : CUDART_INF_F);
        }
      }
    }
  }
  // every row's six values across the warp's lanes, through shared
  // memory: lane v < 24 folds value v (row v / 6) over the 32 lanes, then
  // writes the partial, row-major over the slices so that the emit's
  // merge reads them coalesced: part_ext[(u, j, g)], part_cmin[(b, g)]
  __shared__ float fold[REDUCE_WARPS][32][RPW * 6 + 1];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) fold[warp][lane][i * 6 + j] = acc[i][j];
  }
  __syncwarp();
  if (lane < RPW * 6) {
    const int i = lane / 6, j = lane % 6;
    float r = fold[warp][0][lane];
#pragma unroll
    for (int l = 1; l < 32; ++l) {
      const float x = fold[warp][l][lane];
      r = j % 2 ? max_nan(r, x) : min_nan(r, x);
    }
    const int row = first + REDUCE_WARPS * i;
    if (row < n_ext)
      part_ext[((size_t)row * 6 + j) * G + g] = r;
    else if (row < rows && j == 0)
      part_cmin[(size_t)(row - n_ext) * G + g] = r;
  }
}

// Merges the G partials of extrema row `u` (if `pe`) and C_min row `b` (if
// `pc`) over the block: out[0..5] the (lo, hi) pairs, out[6] C_min.  Every
// thread of the block calls it and gets the result.
__device__ void merge_row(const float* __restrict__ pe, int u,
                          const float* __restrict__ pc, int b, int G,
                          float (&out)[7]) {
  __shared__ float red[EMIT_THREADS / 32][7];
  float acc[7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
    acc[i] = (i % 2 == 0 || i == 6) ? CUDART_INF_F : -CUDART_INF_F;
  for (int g = threadIdx.x; g < G; g += EMIT_THREADS) {
    if (pe) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float x = pe[((size_t)u * 6 + i) * G + g];
        acc[i] = i % 2 == 0 ? min_nan(acc[i], x) : max_nan(acc[i], x);
      }
    }
    if (pc) acc[6] = min_nan(acc[6], pc[(size_t)b * G + g]);
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
    acc[i] = i % 2 == 0 || i == 6 ? warp_reduce<true>(acc[i])
                                   : warp_reduce<false>(acc[i]);
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) red[threadIdx.x / 32][i] = acc[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float v = red[0][i];
    for (int w = 1; w < EMIT_THREADS / 32; ++w)
      v = i % 2 == 0 || i == 6 ? min_nan(v, red[w][i]) : max_nan(v, red[w][i]);
    out[i] = v;
  }
  __syncthreads();  // red is reused by the next merge
}

// One block a row: rows [0, U) merge extrema row u into ext (U, 6), rows
// [U, U + B) C_min row b into cmin (B,).
__global__ void __launch_bounds__(EMIT_THREADS) score_merge_kernel(
    const float* __restrict__ part_ext, const float* __restrict__ part_cmin,
    float* __restrict__ ext, float* __restrict__ cmin, int U, int G) {
  const int row = blockIdx.x;
  float e[7];
  if (row < U) {
    merge_row(part_ext, row, nullptr, 0, G, e);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < 6; ++i) ext[(size_t)row * 6 + i] = e[i];
    }
  } else {
    merge_row(nullptr, 0, part_cmin, row - U, G, e);
    if (threadIdx.x == 0) cmin[row - U] = e[6];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(EMIT_THREADS) score_emit_kernel(
    const float* __restrict__ stats, const float* __restrict__ prices,
    const float* __restrict__ vcpus, const float* __restrict__ memory_gb,
    const unsigned char* __restrict__ use_cpus,
    const float* __restrict__ amount, const float* __restrict__ lam,
    const float* __restrict__ weight, const int* __restrict__ inv,
    float* __restrict__ ext, float* __restrict__ cmin,
    const float* __restrict__ part_ext, const float* __restrict__ part_cmin,
    float* __restrict__ comb, float* __restrict__ avail,
    float* __restrict__ cost, int K, int B, int U, int G) {
  const int b = blockIdx.y;
  const int u = inv[b];
  // this thread's operands first: their loads overlap the merge below
  float4 s0[EMIT_GROUPS], s1[EMIT_GROUPS], s2[EMIT_GROUPS];
  float4 p[EMIT_GROUPS], v[EMIT_GROUPS], mem[EMIT_GROUPS];
#pragma unroll
  for (int q = 0; q < EMIT_GROUPS; ++q) {
    // groups of 4 lanes EMIT_THREADS * 4 apart: each access is one
    // contiguous span of the warp
    const int k = (blockIdx.x * EMIT_GROUPS + q) * EMIT_THREADS * LANES +
                  threadIdx.x * LANES;
    if (k < K) {
      s0[q] = load4<VEC>(stats, k, K);
      s1[q] = load4<VEC>(stats + (size_t)K, k, K);
      s2[q] = load4<VEC>(stats + 2 * (size_t)K, k, K);
      p[q] = load4<VEC>(prices, k, K);
      v[q] = load4<VEC>(vcpus, k, K);
      mem[q] = load4<VEC>(memory_gb, k, K);
    }
  }
  const float lam_b = lam[b];
  const float w = weight[b];
  const bool uc = use_cpus[b] != 0;
  const float amt = amount[b];

  const float* pe = part_ext;
  const float* pc = part_cmin;
  float e[7];
  if (pe || pc) merge_row(pe, u, pc, b, G, e);
  if (!pe) {
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = ext[(size_t)u * 6 + i];
  }
  if (!pc) e[6] = cmin[b];
  if (blockIdx.x == 0) {
    // the merged scalars out: C_min of request b and extrema rows b, b + B,
    // ... (every unique mask, also one that no request carries)
    if (pc && threadIdx.x == 0) cmin[b] = e[6];
    if (pe) {
      for (int uu = b; uu < U; uu += B) {
        float f[7];
        if (uu == u) {
#pragma unroll
          for (int i = 0; i < 7; ++i) f[i] = e[i];
        } else {
          merge_row(pe, uu, nullptr, 0, G, f);
        }
        if (threadIdx.x == 0) {
#pragma unroll
          for (int i = 0; i < 6; ++i) ext[(size_t)uu * 6 + i] = f[i];
        }
      }
    }
  }

  const float c_min = e[6];
  const size_t o = (size_t)b * K;
#pragma unroll
  for (int q = 0; q < EMIT_GROUPS; ++q) {
    const int k = (blockIdx.x * EMIT_GROUPS + q) * EMIT_THREADS * LANES +
                  threadIdx.x * LANES;
    if (k >= K) break;
    float co4[LANES], av4[LANES], cb4[LANES];
#pragma unroll
    for (int i = 0; i < LANES; ++i) {
      const float total = total_cost(lane_of(p[q], i), lane_of(v[q], i),
                                     lane_of(mem[q], i), uc, amt);
      const float a3 = minmax_norm(lane_of(s0[q], i), e[0], e[1]);
      const float sn = minmax_norm(lane_of(s1[q], i), e[2], e[3]);
      const float gn = minmax_norm(lane_of(s2[q], i), e[4], e[5]);
      float av = 100.0f * a3 * (1.0f + lam_b * (sn - gn));
      av = av < 0.0f ? 0.0f : av;  // clip at 0; NaN passes, as torch.clamp
      const float co = 100.0f * c_min / total;
      cb4[i] = w * av + (1.0f - w) * co;
      av4[i] = av;
      co4[i] = co;
    }
    store4<VEC>(comb + o, k, K, make_float4(cb4[0], cb4[1], cb4[2], cb4[3]));
    store4<VEC>(avail + o, k, K, make_float4(av4[0], av4[1], av4[2], av4[3]));
    store4<VEC>(cost + o, k, K, make_float4(co4[0], co4[1], co4[2], co4[3]));
  }
}

}  // namespace

// stats (3, K); prices, vcpus, memory_gb (K,); uniq_masks (U, K) and masks
// (B, K) as bytes; use_cpus (B,) bytes; amount (B,).  Writes the partials
// part_ext (n_ext, 6, G) as (lo, hi) pairs of area, slope, std, and
// part_cmin (n_cmin, G), on a (G, row_groups) grid of K-slices of `slice`
// lanes.  `vec`: 16-byte accesses (see the header).
extern "C" int score_fuse_reduce(
    const float* stats, const float* prices, const float* vcpus,
    const float* memory_gb, const unsigned char* uniq_masks,
    const unsigned char* masks, const unsigned char* use_cpus,
    const float* amount, float* part_ext, float* part_cmin, int K, int n_ext,
    int n_cmin, int G, int slice, int row_groups, int vec, void* stream) {
  const dim3 grid(G, row_groups);
  auto kernel = vec ? score_reduce_kernel<true> : score_reduce_kernel<false>;
  kernel<<<grid, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      stats, prices, vcpus, memory_gb, uniq_masks, masks, use_cpus, amount,
      part_ext, part_cmin, K, n_ext, n_cmin, G, slice);
  return (int)cudaGetLastError();
}

// Emits the (B, K) rows on a (emit_blocks, B) grid.  With part_ext (U, 6,
// G) the extrema are merged from it and written to ext (U, 6), else read
// from ext; with part_cmin (B, G) likewise for cmin (B,).
extern "C" int score_fuse_emit(
    const float* stats, const float* prices, const float* vcpus,
    const float* memory_gb, const unsigned char* use_cpus,
    const float* amount, const float* lam, const float* weight,
    const int* inv, float* ext, float* cmin, const float* part_ext,
    const float* part_cmin, float* comb, float* avail, float* cost, int K,
    int B, int U, int G, int emit_blocks, int vec, void* stream) {
  const dim3 grid(emit_blocks, B);
  auto kernel = vec ? score_emit_kernel<true> : score_emit_kernel<false>;
  kernel<<<grid, EMIT_THREADS, 0, (cudaStream_t)stream>>>(
      stats, prices, vcpus, memory_gb, use_cpus, amount, lam, weight, inv,
      ext, cmin, part_ext, part_cmin, comb, avail, cost, K, B, U, G);
  return (int)cudaGetLastError();
}

// Merges the partials of score_fuse_reduce into ext (U, 6) and cmin (B,)
// on a grid of U + B blocks (phase 0 without an emit).
extern "C" int score_fuse_merge(const float* part_ext,
                                const float* part_cmin, float* ext,
                                float* cmin, int U, int B, int G,
                                void* stream) {
  score_merge_kernel<<<U + B, EMIT_THREADS, 0, (cudaStream_t)stream>>>(
      part_ext, part_cmin, ext, cmin, U, G);
  return (int)cudaGetLastError();
}

// Blocks an SM holds at once: reduce and emit, 16-byte variants.
extern "C" int score_fuse_occupancy(int* reduce_blocks, int* emit_blocks) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      reduce_blocks, score_reduce_kernel<true>, REDUCE_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        emit_blocks, score_emit_kernel<true>, EMIT_THREADS, 0);
  return (int)err;
}
