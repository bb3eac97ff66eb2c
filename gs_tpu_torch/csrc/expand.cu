// K2 — duplicate expansion of the binning stage, for Hopper (sm_90a).
//
// Replaces gs_tpu/ops/expand_pallas.py::_expand_kernel (:61-91, called from
// expand_rows :142). Output entry e carries column g of the [16, N] table
// `comb`, where g is the gaussian with offsets[g] <= e < offsets[g] +
// counts[g] (counts = comb row 1), and zeros where no gaussian owns e (past
// the total). Offsets are nondecreasing and zero-count gaussians sit last,
// so the owner is the LAST g with offsets[g] <= e: among gaussians sharing
// an offset only the last can have a nonzero count.
//
// Bound on the H100: bytes. It moves 16 x capacity x 4 B out (197 MB at
// the 1080p bench scene's 3.07M entries) and reads the 16 x N table once;
// the work is a binary search per entry, ~19 steps at N = 511k, nothing
// against 67 TFLOP/s. Design: one thread per output entry, so a warp
// writes 32 neighbouring entries of each row and every store is one
// coalesced 128-byte line. Neighbouring threads share their search path,
// so the 2 MB offsets array is served from L1/L2. The TPU kernel's one-hot
// matmul over a 384-gaussian window exists because the TPU has no cheap
// per-lane gather; here a gather is one load, and no window is needed.
#include "common.cuh"

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const float* __restrict__ comb,
                   const int* __restrict__ offsets, int n,
                   float* __restrict__ out, int capacity) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= capacity) return;
  int lo = 0, hi = n;  // first g with offsets[g] > e
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= e) lo = mid + 1; else hi = mid;
  }
  const int g = lo - 1;
  const bool hit = g >= 0 &&
      e < __ldg(offsets + g) + static_cast<int>(__ldg(comb + n + g));
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    out[static_cast<size_t>(r) * capacity + e] =
        hit ? __ldg(comb + static_cast<size_t>(r) * n + g) : 0.0f;
  }
}

}  // namespace

// comb [16, n] float32, offsets [n] int32, out [16, capacity] float32: all
// contiguous on `device`. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError().
extern "C" int gs_expand_rows(const float* comb, const int* offsets, int n,
                              float* out, int capacity, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (capacity + kThreads - 1) / kThreads;
  expand_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      comb, offsets, n, out, capacity);
  return static_cast<int>(cudaGetLastError());
}
