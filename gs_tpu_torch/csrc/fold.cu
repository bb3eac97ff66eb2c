// K4 — gradient fold: per-Gaussian sums of per-entry rows, for Hopper
// (sm_90a).
//
// Replaces gs_tpu/ops/fold_pallas.py::_fold_kernel (:50-79, called from
// fold_rows :140). out[r, g] = sum of data[r, col(e)] over the run
// e in [offsets[g], offsets[g] + counts[g]), cut at the n_entries entries
// there are (a run past them only arises under capacity overflow, whose
// gradients the caller zeroes). col(e) = index[e] when an index is given,
// else e: the render's backward passes the inverse of the tile sort, so
// the fold reads K3's tile-ordered rows where each Gaussian's entries sat
// before that sort, in one contiguous run per Gaussian (the expansion lays
// them out so), and no gid sort is needed.
//
// Bound on the H100: bytes. Each entry's rows are read once (40 B for 10
// rows, plus its 4 B index) and each Gaussian's sums written once; the
// adds are one per value read. Design: one warp per Gaussian run, lanes
// striding the run, a fixed shuffle tree, lane r writing row r: the sums
// come out the same from run to run (no atomics). The TPU kernel's one-hot
// matmul over 512-entry windows exists because a TPU lane cannot gather;
// here a gather is one load.
#include "common.cuh"

namespace {

constexpr int kMaxRows = 16;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fold_rows_kernel(const float* __restrict__ data, int d,
                 const int* __restrict__ index, int n_entries,
                 const int* __restrict__ offsets,
                 const int* __restrict__ counts, int n, int rows,
                 float* __restrict__ out) {
  const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n) return;  // the whole warp leaves together
  const long long lo = max(0LL, static_cast<long long>(offsets[g]));
  const long long hi = min(static_cast<long long>(n_entries),
                           static_cast<long long>(offsets[g]) + counts[g]);
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.0f;
  for (long long e = lo + lane; e < hi; e += 32) {
    const int col = index ? __ldg(index + e) : static_cast<int>(e);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < rows) acc[r] += __ldg(data + static_cast<size_t>(r) * d + col);
  }
  float mine = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      if (lane == r) mine = acc[r];
    }
  }
  if (lane < rows) out[static_cast<size_t>(lane) * n + g] = mine;
}

}  // namespace

// data [rows, d] float32, index [n_entries] int32 in [0, d) or null (then
// n_entries == d), offsets/counts [n] int32, out [rows, n] float32: all
// contiguous on `device`, 1 <= rows <= 16. Launches on `stream`, allocates
// nothing, does not synchronise. Returns cudaGetLastError().
extern "C" int gs_fold_rows(const float* data, int d, const int* index,
                            int n_entries, const int* offsets,
                            const int* counts, int n, int rows, float* out,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fold_rows_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      data, d, index, n_entries, offsets, counts, n, rows, out);
  return static_cast<int>(cudaGetLastError());
}
