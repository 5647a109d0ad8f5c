// Chunked RG-LRU diagonal recurrence h_t = exp(log_a_t) * h_{t-1} + x_t,
// kernel B6.
//
// Replaces: src/repro/kernels/rglru_scan.py `_rglru_kernel` (launched by
// `rglru_scan`).  On the TPU its grid is (B, channel blocks, chunks) with
// the chunk axis sequential and the (1, bR) carry in VMEM scratch; inside a
// chunk of 128 rows it composes the recurrence by log-depth doubling on the
// VPU.
//
// Here a tile is 16 channels of one batch row, and a persistent block walks
// tiles (tile = blockIdx.x, += gridDim.x; the grid comes from the wrapper's
// `launch_plan`, sized by the kernel's occupancy) and, inside a tile, its
// chunks in order.  The doubling runs in registers: a warp takes one
// channel at a time, lane l holding rows l, l + 32, l + 64, l + 96 of the
// chunk.  Offsets 1-16 are one `__shfl_sync` a register from lane
// (l - off) mod 32 (a lane below the offset takes the register one slot
// down, and lane l < off of the first slot keeps its value); offsets 32 and
// 64 move between a lane's own registers.  No barrier and no shared memory
// inside the doubling.  Shared memory only turns the tile around: global
// rows are read and written with lanes along channels (64-byte row
// segments), and the (128 x 17) padded tile makes the column reads of the
// doubling free of bank conflicts.  The next chunk's log_a, x (and h0, at a
// tile's first chunk) arrive by `cp.async` into a second buffer while this
// one is scanned and stored, so a chunk costs two barriers: after its data
// is in, and after the doubling.  Rows past S are zeros (log_a = 0,
// x = 0): they touch no real row, so padding every chunk to 128 gives the
// real rows the bits of the Pallas kernel's `min(128, S)` chunk.
//
// Every output is computed as before: the carry folded into row 0 (the
// other rows add 0, as the Pallas body's `where` does, which turns -0 into
// +0), then on each step the values from before the step,
// `expf(la_t) * x_{t-off} + x_t` and `la_t + la_{t-off}`.
//
// Bound on an H100: bytes.  Per element it reads log_a and x (float32) and
// writes h: 12 bytes against about 24 flops and 6 exponentials of doubling
// work.  At (16, 128, 2560) that is 63 MB, 19 us at 3.35 TB/s.  Instruction
// throughput is the limit in practice: the 25 full-precision `expf` a lane and
// chunk-channel (about 8 instructions each, bit equality forbids a cheaper
// one) and 40 shuffles make some 400 instructions a channel, which the
// copies overlap.
//
// Exactness: built with --fmad=false and no fast math, so
// `exp(la) * x_sh + x` rounds the product and the sum separately, as
// PyTorch's eager ops do: on the card the outputs equal the plain PyTorch
// version's bit for bit (both use CUDA's expf).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 128;                 // chunk length
constexpr int CH = 16;                 // channels a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PITCH = CH + 1;          // padded tile row
constexpr int RP = THREADS / CH;       // rows a copy pass covers
constexpr int PER = C / RP;            // cells a thread copies, an array
constexpr int TILE = C * PITCH;        // floats of one (C x CH) tile
// two buffers of la and x tiles and of h0, and the carries
constexpr int SMEM_BYTES = 4 * (4 * TILE + 3 * CH);
constexpr unsigned FULL = 0xffffffffu;

struct Tile {
  int b, r0;
};

__device__ __forceinline__ Tile tile_of(int tile, int ctiles) {
  return {tile / ctiles, (tile % ctiles) * CH};
}

// 4 bytes from global to shared memory without passing a register; zeros
// when `in` is false (src is then any valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The doubling of one channel's chunk, in registers: v[j], a[j] hold row
// lane + 32 j.  Every step reads the values from before the step.
__device__ __forceinline__ void doubling(float (&v)[4], float (&a)[4],
                                         int lane) {
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const int off = 1 << d;
    const int src = (lane - off) & 31;
    const bool up = lane >= off;
    float vy[4], ay[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      vy[j] = __shfl_sync(FULL, v[j], src);
      ay[j] = __shfl_sync(FULL, a[j], src);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // row t - off: this slot in lane l - off, or the slot below in lane
      // l - off + 32
      const float vs = up ? vy[j] : vy[j > 0 ? j - 1 : 0];
      const float as = up ? ay[j] : ay[j > 0 ? j - 1 : 0];
      if (j > 0 || up) {
        v[j] = expf(a[j]) * vs + v[j];
        a[j] = a[j] + as;
      }
    }
  }
  // offset 32: row t - 32 is the same lane's register one slot down
#pragma unroll
  for (int j = 3; j >= 1; --j) {
    v[j] = expf(a[j]) * v[j - 1] + v[j];
    a[j] = a[j] + a[j - 1];
  }
  // offset 64 (the last step: la is not read again)
#pragma unroll
  for (int j = 3; j >= 2; --j) v[j] = expf(a[j]) * v[j - 2] + v[j];
}

__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ x_in,
                 const float* __restrict__ h0, float* __restrict__ hs,
                 float* __restrict__ h_last, int S, int R, int tiles) {
  extern __shared__ float smem[];
  float* const carry = smem + 4 * TILE;   // each channel's carry (lane 0)
  float* const h0s = carry + CH;          // a tile's h0, two buffers

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = threadIdx.x / CH;      // copy phases: cells (row0 + RP m,
  const int col = threadIdx.x % CH;       // col), lanes along channels
  const int ctiles = (R + CH - 1) / CH;
  const int n_chunks = (S + C - 1) / C;
  if ((int)blockIdx.x >= tiles || n_chunks == 0) return;
  // the items of this block, in order: chunks 0..n_chunks-1 of tiles
  // blockIdx.x, blockIdx.x + gridDim.x, ...
  const int n_items =
      n_chunks * ((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  // the carry is the chunk's last row: row S - 1 when the whole sequence is
  // shorter than a chunk (the Pallas chunk is then S rows), else row C - 1,
  // padding included, as the Pallas kernel pads the last chunk
  const int last = S < C ? S - 1 : C - 1;

  auto item = [&](int i, int& ch) {
    ch = i % n_chunks;
    return tile_of(blockIdx.x + (i / n_chunks) * gridDim.x, ctiles);
  };
  // item i's log_a and x (and h0 for a tile's first chunk) into buffer
  // i % 2, rows past S and channels past R as zeros, without waiting
  auto prefetch = [&](int i) {
    int ch;
    const Tile t = item(i, ch);
    float* la = smem + (i % 2) * TILE + row0 * PITCH + col;
    float* xi = smem + (2 + i % 2) * TILE + row0 * PITCH + col;
    const int r = t.r0 + col;
    const int rows = r < R ? S - ch * C - row0 : 0;   // rows left below row0
    const size_t at = ((size_t)t.b * S + ch * C + row0) * R + r;
    const float* pa = log_a + (rows > 0 ? at : 0);
    const float* px = x_in + (rows > 0 ? at : 0);
    const size_t step = (size_t)RP * R;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const bool in = RP * m < rows;
      cp_async4(la + RP * m * PITCH, in ? pa + m * step : log_a, in);
      cp_async4(xi + RP * m * PITCH, in ? px + m * step : x_in, in);
    }
    if (ch == 0 && threadIdx.x < CH) {
      const bool in = t.r0 + threadIdx.x < R;
      cp_async4(h0s + (i % 2) * CH + threadIdx.x,
                in ? h0 + (size_t)t.b * R + t.r0 + threadIdx.x : h0, in);
    }
    cp_commit();
  };

  prefetch(0);
  for (int i = 0; i < n_items; ++i) {
    cp_wait_all();
    __syncthreads();       // item i is in; buffer (i + 1) % 2 is free
    if (i + 1 < n_items) prefetch(i + 1);
    int ch;
    const Tile t = item(i, ch);
    const float* la = smem + (i % 2) * TILE;
    float* xi = smem + (2 + i % 2) * TILE;
#pragma unroll 1
    for (int q = 0; q < CH / WARPS; ++q) {
      const int c = warp + WARPS * q;
      const int r = t.r0 + c;
      float v[4], a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = la[(lane + 32 * j) * PITCH + c];
        v[j] = xi[(lane + 32 * j) * PITCH + c];
      }
      // fold the carry into row 0; every other row adds 0
      if (lane == 0) {
        const float h = ch > 0 ? carry[c] : h0s[(i % 2) * CH + c];
        v[0] = v[0] + expf(a[0]) * h;
      } else {
        v[0] = v[0] + 0.f;
      }
#pragma unroll
      for (int j = 1; j < 4; ++j) v[j] = v[j] + 0.f;
      doubling(v, a, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) xi[(lane + 32 * j) * PITCH + c] = v[j];
      const int lj = last / 32;
      const float pick = lj == 0 ? v[0] : lj == 1 ? v[1] : lj == 2 ? v[2] : v[3];
      const float h = __shfl_sync(FULL, pick, last % 32);
      if (lane == 0) {
        carry[c] = h;
        if (ch == n_chunks - 1 && r < R) h_last[(size_t)t.b * R + r] = h;
      }
    }
    __syncthreads();       // the chunk is scanned
    const int r = t.r0 + col;
    const int rows = r < R ? S - ch * C - row0 : 0;
    float* const out = hs + ((size_t)t.b * S + ch * C + row0) * R + r;
    const float* const cell = xi + row0 * PITCH + col;
#pragma unroll
    for (int m = 0; m < PER; ++m)
      if (RP * m < rows) out[m * (size_t)RP * R] = cell[RP * m * PITCH];
  }
}

}  // namespace

// log_a, x_in, hs (B, S, R) float32; h0, h_last (B, R) float32; contiguous.
// `grid` persistent blocks walk the B * ceil(R / 16) tiles.
extern "C" int rglru_scan_launch(const void* log_a, const void* x_in,
                                 const void* h0, void* hs, void* h_last, int B,
                                 int S, int R, int grid, void* stream) {
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      rglru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = B * ((R + CH - 1) / CH);
  rglru_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(x_in),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_last), S, R, tiles);
  return (int)cudaGetLastError();
}

// Blocks of rglru_kernel an SM holds at once, and its dynamic shared memory.
extern "C" int rglru_scan_occupancy(int* blocks_per_sm, int* smem_bytes) {
  *smem_bytes = SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, rglru_kernel, THREADS, SMEM_BYTES);
  return (int)err;
}
