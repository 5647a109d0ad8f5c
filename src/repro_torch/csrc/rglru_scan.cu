// Chunked RG-LRU diagonal recurrence h_t = exp(log_a_t) * h_{t-1} + x_t,
// kernel B6.
//
// Replaces: src/repro/kernels/rglru_scan.py `_rglru_kernel` (launched by
// `rglru_scan`).  On the TPU its grid is (B, channel blocks, chunks) with
// the chunk axis sequential and the (1, bR) carry in VMEM scratch; inside a
// chunk of 128 rows it composes the recurrence by log-depth doubling on the
// VPU.  Here a block owns 32 channels of one batch row and walks the chunks
// in a loop.  Its 256 threads are 32 channels x 8 row groups: each thread
// keeps one channel and rows g, g + 8, ... of the (128 x 32) chunk tile in
// shared memory.  The carry is folded into row 0 (the other rows add 0, as
// the Pallas body's `where` does), then seven doubling steps run, each
// reading the values from before the step into registers, a barrier, and
// the writes.  Rows past S are zeros (log_a = 0, x = 0): they touch no
// real row, so padding every chunk to 128 gives the real rows the bits of
// the Pallas kernel's `min(128, S)` chunk.
//
// Bound on an H100: bytes.  Per element it reads log_a and x (float32) and
// writes h: 12 bytes against about 24 flops and 6 exponentials of doubling
// work, far under the card's 20 flops per byte.  At (16, 128, 2560) that
// is 63 MB, 19 us at 3.35 TB/s.  The design keeps one pass over the data
// (each element is loaded and stored once; the doubling works in shared
// memory) and coalesced rows of 32 channels.
//
// Exactness: built with --fmad=false and no fast math, so
// `exp(la) * x_sh + x` rounds the product and the sum separately, as
// PyTorch's eager ops do: on the card the outputs equal the plain PyTorch
// version's bit for bit (both use CUDA's expf).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 128;                 // chunk length
constexpr int STEPS = 7;               // (C - 1).bit_length()
constexpr int CH = 32;                 // channels a block
constexpr int GROUPS = 8;              // row groups a block
constexpr int THREADS = CH * GROUPS;
constexpr int PER = C / GROUPS;        // rows a thread

__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ x_in,
                 const float* __restrict__ h0, float* __restrict__ hs,
                 float* __restrict__ h_last, int S, int R) {
  __shared__ float la[C][CH];
  __shared__ float xi[C][CH];

  const int lane = threadIdx.x % CH;
  const int g = threadIdx.x / CH;
  const int b = blockIdx.y;
  const int r = blockIdx.x * CH + lane;
  const bool live = r < R;
  const size_t base = (size_t)b * S * R + r;

  float h = live ? h0[(size_t)b * R + r] : 0.f;
  const int n_chunks = (S + C - 1) / C;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * C;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int t = g + GROUPS * m;
      const bool in = live && t0 + t < S;
      const size_t idx = base + (size_t)(t0 + t) * R;
      const float a = in ? log_a[idx] : 0.f;
      const float x = in ? x_in[idx] : 0.f;
      la[t][lane] = a;
      // fold the carry into row 0; every other row adds 0
      xi[t][lane] = t == 0 ? x + expf(a) * h : x + 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int d = 0; d < STEPS; ++d) {
      const int off = 1 << d;
      float nx[PER], nl[PER];
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int t = g + GROUPS * m;
        if (t >= off) {
          const float a = la[t][lane];
          nx[m] = expf(a) * xi[t - off][lane] + xi[t][lane];
          nl[m] = a + la[t - off][lane];
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int t = g + GROUPS * m;
        if (t >= off) {
          xi[t][lane] = nx[m];
          la[t][lane] = nl[m];
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int t = g + GROUPS * m;
      if (live && t0 + t < S) hs[base + (size_t)(t0 + t) * R] = xi[t][lane];
    }
    // the carry is the chunk's last row: row S - 1 when the whole sequence
    // is shorter than a chunk (the Pallas chunk is then S rows), else row
    // C - 1, padding included, as the Pallas kernel pads the last chunk
    h = xi[S < C ? S - 1 : C - 1][lane];
    __syncthreads();
  }
  if (live && g == 0) h_last[(size_t)b * R + r] = h;
}

}  // namespace

// log_a, x_in, hs (B, S, R) float32; h0, h_last (B, R) float32; contiguous.
extern "C" int rglru_scan_launch(const void* log_a, const void* x_in,
                                 const void* h0, void* hs, void* h_last, int B,
                                 int S, int R, void* stream) {
  const dim3 grid((R + CH - 1) / CH, B);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(x_in),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(h_last), S, R);
  return (int)cudaGetLastError();
}
