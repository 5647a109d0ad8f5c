// Algorithm 1 all-prefix termination scan for a request batch: kernel B2.
//
// Replaces: src/repro/kernels/pool_scan.py `_pool_scan_kernel` (launched by
// `_pool_scan_pallas`).  On the TPU its (2, nt) grid runs in order: phase 0
// walks the tiles carrying top[k-1], a found flag, k_stop and the winning
// prefix sum in SMEM; phase 1 emits the winning prefix's counts row.
//
// Here one launch does both, one thread-block cluster of CL blocks a
// request (grid (CL, B), `__cluster_dims__(CL, 1, 1)`), on the wrapper's
// `pool_scan_plan`.  Lanes come in tiles of TILE, 4 adjacent lanes a
// thread; tile e x CL + r is block r's e-th tile, so the e-th tiles of the
// blocks lie in order across the cluster.  In a tile a lane computes
// `newest` and `top`; `prev` (top[k-1]) is the neighbour lane's `top`,
// from the thread's own registers or from the thread before it by
// `__shfl_up_sync` (the first thread of a warp computes it from csc[k-1]:
// the same expression, so the same bits).  Each warp finds its first
// terminating lane with a ballot and leaves it, with csc of the lane before
// it (the winning prefix's sum), in shared memory; one `__syncthreads` a
// tile gives every thread the block's first.
//   tile 0  every block scans lanes [0, TILE) alike.  In the serving mix the
//           stop lies there: then each block knows the answer, and the
//           cluster has no barrier, no shared-memory traffic between blocks
//           and no other tile to read.
//   walk    otherwise block r walks its tiles in order (block 0 from its
//           second), the next one loading while one is scanned, and stops
//           at its first terminating lane or at its last tile.  Lanes past a
//           terminating lane cannot hold the first one, so a block's own
//           first is all the merge needs from it.  Then every block pushes
//           its first lane and prefix sum into the shared memory of each
//           block of the cluster, one `barrier.cluster`, and each takes the
//           min from its own copy.  A cluster barrier costs about as much as
//           a tile's scan (PERF.md, Findings), so the blocks meet once, not
//           after every tile.  (A block must not push into a block that has
//           not started: an arrive when the walk begins and its wait before
//           the push make sure each has, with the walk in between; after the
//           merge no block touches another's shared memory.)
//   emit    every block then knows k_stop, k_best, csc[k_best] and the k = 0
//           guard `deg`, decoded as `_finalize` does (pool_scan.py), and
//           writes the counts row over its own tiles, 16 bytes a thread when
//           K % 4 == 0 and the rows are aligned (the wrapper decides,
//           `_build.rows_aligned`), else lane by lane.  The last tile it
//           scanned is still in registers and every lane of a later tile
//           lies past k_best, so when the stop lies in tile 0 the emit reads
//           nothing; s and c of earlier tiles are read again, four tiles
//           at a time.
// Nothing global is set up: no memset, no atomic, no scratch.  The stable
// sort and the clamped prefix sums stay outside, as they sit outside the
// Pallas kernel in the reference.
//
// Bound on an H100: bytes.  The function must read s, c and csc up to each
// request's first terminating prefix and write the (B, K) int32 counts row,
// with two divisions per lane scanned; the counts row dominates.
//
// Exactness: --fmad=false, no fast math, IEEE division, and each expression
// keeps the reference's op order, (s * R) / (csc * c).  The float-to-int
// cast is the C cast (cvt.rzi.s32.f32, saturating), which is what PyTorch's
// CUDA `.to(torch.int32)` compiles to, so counts and k_stop equal the plain
// PyTorch version's on the same inputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;                   // blocks a cluster (a request)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 4;                // adjacent lanes a thread: one float4
constexpr int TILE = THREADS * LANES;   // lanes of a tile
constexpr int NONE = INT_MAX;           // "no termination"
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int ceil_i32(float x) { return (int)ceilf(x); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Lanes k .. k + 3 of a row; `pad` past K.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p, int k,
                                      int K, float pad, float (&v)[LANES]) {
  if (VEC) {  // K % 4 == 0: a group is wholly inside or wholly past K
    const float4 t = k < K ? *reinterpret_cast<const float4*>(p + k)
                           : make_float4(pad, pad, pad, pad);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < LANES; ++j) v[j] = k + j < K ? p[k + j] : pad;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(int* __restrict__ p, int k, int K,
                                       const int (&v)[LANES]) {
  if (VEC) {
    *reinterpret_cast<int4*>(p + k) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < LANES; ++j)
      if (k + j < K) p[k + j] = v[j];
  }
}

// A thread's 4 lanes of one tile, and csc of the lane before them (read
// by a warp's first thread only).
struct Lanes {
  float s[LANES], c[LANES], cs[LANES];
  float cs_prev;
};

template <bool VEC>
__device__ __forceinline__ void load_lanes(const float* __restrict__ sr,
                                           const float* __restrict__ cr,
                                           const float* __restrict__ cscr,
                                           int k0, int K, int lane, Lanes& t) {
  load4<VEC>(sr, k0, K, 0.0f, t.s);
  load4<VEC>(cr, k0, K, 1.0f, t.c);
  load4<VEC>(cscr, k0, K, 1.0f, t.cs);
  t.cs_prev = lane == 0 && k0 > 0 && k0 < K ? cscr[k0 - 1] : 1.0f;
}

// The block's first terminating lane in a tile (NONE if none) and csc of
// the lane before it, the same in every thread.  Each warp finds its own
// with a ballot and leaves it in shared memory; the slots alternate by tile
// parity `p`, so one `__syncthreads` a tile suffices (a warp writes a slot
// again only two tiles later, after every thread has read it).
struct First {
  int lane;
  float cs;
};

__device__ __forceinline__ First scan_tile(const Lanes& cur, int k0, int K,
                                           float R, float c0, float s0R,
                                           int lane, int warp, int p,
                                           int (&slot)[2][WARPS],
                                           float (&slot_cs)[2][WARPS]) {
  int top[LANES];
#pragma unroll
  for (int j = 0; j < LANES; ++j) top[j] = ceil_i32(s0R / (cur.cs[j] * c0));
  int prev = __shfl_up_sync(FULL, top[LANES - 1], 1);
  float cs_up = __shfl_up_sync(FULL, cur.cs[LANES - 1], 1);
  if (lane == 0 && k0 > 0 && k0 < K) {
    prev = ceil_i32(s0R / (cur.cs_prev * c0));
    cs_up = cur.cs_prev;
  }
  int mine = NONE;
  float mine_cs = 0.0f;
#pragma unroll
  for (int j = LANES - 1; j >= 0; --j) {  // the lowest terminating lane wins
    const int k = k0 + j;
    const int newest = ceil_i32(cur.s[j] * R / (cur.cs[j] * cur.c[j]));
    const int q = j ? top[j - 1] : prev;
    // x_prev_top = inf at k = 0
    const bool term = k == 0 ? newest == 0 : top[j] >= q || newest == 0;
    if (k < K && term) {
      mine = k;
      mine_cs = j ? cur.cs[j - 1] : cs_up;
    }
  }
  const unsigned ballot = __ballot_sync(FULL, mine != NONE);
  const int src = ballot ? __ffs(ballot) - 1 : 0;
  const int wfirst = __shfl_sync(FULL, mine, src);
  const float wcs = __shfl_sync(FULL, mine_cs, src);
  if (lane == 0) {
    slot[p][warp] = ballot ? wfirst : NONE;
    slot_cs[p][warp] = wcs;
  }
  __syncthreads();
  First f = {NONE, 0.0f};
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    if (slot[p][w] < f.lane) f.lane = slot[p][w], f.cs = slot_cs[p][w];
  return f;
}

template <bool VEC>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
pool_scan_kernel(const float* __restrict__ s, const float* __restrict__ c,
                 const float* __restrict__ csc,
                 const float* __restrict__ required, int* __restrict__ counts,
                 int* __restrict__ k_stop, bool* __restrict__ any_term, int K,
                 int tiles) {
  __shared__ int slot[2][WARPS];     // a warp's first lane in a tile (parity)
  __shared__ float slot_cs[2][WARPS];  // and csc of the lane before it
  __shared__ int res[CL];            // every block's first lane (pushed)
  __shared__ float res_cs[CL];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = blockIdx.x;  // == cluster.block_rank(): the cluster is (CL, 1)
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mine0 = threadIdx.x * LANES;  // a thread's first lane in a tile

  const size_t row = (size_t)b * K;
  const float* sr = s + row;
  const float* cr = c + row;
  const float* cscr = csc + row;
  const float R = required[b];
  const float c0 = cr[0];
  const float s0R = sr[0] * R;  // the numerator of every top
  const float cs_last = cscr[K - 1];  // k_best's prefix sum if none stops

  // Every block scans tile 0 alike: in the serving mix the stop lies there,
  // and the cluster needs no barrier, no shared-memory traffic and no
  // other tile.
  Lanes cur, nxt;
  load_lanes<VEC>(sr, cr, cscr, mine0, K, lane, cur);
  int p = 0;
  First f = scan_tile(cur, mine0, K, R, c0, s0R, lane, warp, p, slot, slot_cs);
  int found = f.lane, last = r == 0 ? 0 : -1;  // last: the tile in `cur`
  float stot = f.cs;
  if (found == NONE) {
    // The walk: block r scans its tiles e x CL + r in order (block 0 from
    // its second) to its first terminating lane or its last tile; then the
    // blocks merge their firsts.
    cluster_arrive();  // this block has started: the others may push to it
    First mine = {NONE, 0.0f};
    const int e0 = r == 0 ? 1 : 0;
    const auto lanes_of = [&](int e) { return (e * CL + r) * TILE + mine0; };
    if (e0 < tiles) load_lanes<VEC>(sr, cr, cscr, lanes_of(e0), K, lane, cur);
    for (int e = e0; e < tiles; ++e) {
      if (e + 1 < tiles)  // the next tile loads while this one is scanned
        load_lanes<VEC>(sr, cr, cscr, lanes_of(e + 1), K, lane, nxt);
      p ^= 1;
      mine = scan_tile(cur, lanes_of(e), K, R, c0, s0R, lane, warp, p, slot,
                       slot_cs);
      last = e;
      if (mine.lane != NONE || e + 1 == tiles) break;  // `cur` keeps tile e
      cur = nxt;
    }
    cluster_wait();  // every block has started
    // the merge: push, one barrier, the min from this block's own copy
    if (warp == 0 && lane < CL) {
      cluster.map_shared_rank(&res[0], lane)[r] = mine.lane;
      cluster.map_shared_rank(&res_cs[0], lane)[r] = mine.cs;
    }
    cluster_arrive();
    cluster_wait();
    stot = cs_last;
#pragma unroll
    for (int q = 0; q < CL; ++q)
      if (res[q] < found) found = res[q], stot = res_cs[q];
  }

  const bool any = found != NONE;
  const int ks = any ? found : 0;
  const int kb = any ? max(ks - 1, 0) : K - 1;
  const bool deg = any && ks == 0;  // termination at k = 0
  if (r == 0 && threadIdx.x == 0) {
    k_stop[b] = ks;
    any_term[b] = any;
  }
  // block r writes its own tiles: tile `last` is still in `cur`, every
  // lane of a later one lies past k_best, and the s and c of four earlier
  // ones are read again at a time
  int* out = counts + row;
  for (int e = 0; e < tiles; e += 4) {
    float sv[4][LANES], cv[4][LANES];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ((e + i) * CL + r) * TILE + mine0;
      if (!deg && e + i < tiles && k < K && k <= kb && e + i != last) {
        load4<VEC>(sr, k, K, 0.0f, sv[i]);
        load4<VEC>(cr, k, K, 1.0f, cv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ((e + i) * CL + r) * TILE + mine0;
      if (e + i >= tiles || k >= K) break;
      int v[LANES] = {0, 0, 0, 0};
      if (deg) {
        if (k == 0) v[0] = ceil_i32(R / c0);  // single-type pool on the leader
      } else if (k <= kb) {
        const bool held = e + i == last;
#pragma unroll
        for (int j = 0; j < LANES; ++j)
          if (k + j <= kb)
            v[j] = ceil_i32((held ? cur.s[j] : sv[i][j]) * R /
                            (stot * (held ? cur.c[j] : cv[i][j])));
      }
      store4<VEC>(out, k, K, v);
    }
  }
}

}  // namespace

// s, c, csc (B, K) float32 in score-descending order; required (B,).
// Writes counts (B, K) and k_stop (B,) as int32 and any_term (B,) as bool.
// `tiles` (a block's tiles) comes from the wrapper's `pool_scan_plan`;
// `vec` selects the 16-byte path (K % 4 == 0, 16-byte-aligned rows).
extern "C" int pool_scan_launch(const float* s, const float* c,
                                const float* csc, const float* required,
                                int* counts, int* k_stop, bool* any_term,
                                int B, int K, int tiles, int vec,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(CL, B);
  if (vec) {
    pool_scan_kernel<true><<<grid, THREADS, 0, st>>>(
        s, c, csc, required, counts, k_stop, any_term, K, tiles);
  } else {
    pool_scan_kernel<false><<<grid, THREADS, 0, st>>>(
        s, c, csc, required, counts, k_stop, any_term, K, tiles);
  }
  return (int)cudaGetLastError();
}

// The plan's constants as compiled, and how many clusters of the kernel the
// card holds at once.
extern "C" int pool_scan_geometry(int* cluster, int* threads, int* lanes,
                                  int* max_clusters) {
  *cluster = CL;
  *threads = THREADS;
  *lanes = LANES;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  return (int)cudaOccupancyMaxActiveClusters(
      max_clusters, (const void*)pool_scan_kernel<true>, &cfg);
}
