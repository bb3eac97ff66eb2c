// Shared by every kernel library of gs_tpu_torch: each .cu file is built on
// its own into a plain-C shared library (gs_tpu_torch/ops/_cuda.py), and each
// library exports this error-string helper for the Python wrappers.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* gs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What the compiler made of kernel `fn` launched with `threads` threads:
// attrs[0] registers per thread, [1] static shared bytes per CTA, [2] local
// (spill) bytes per thread, [3] CTAs an SM holds at once, [4] threads per
// CTA. Returns the first CUDA error.
static inline int kernel_attributes(const void* fn, int threads, int* attrs) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.sharedSizeBytes);
  attrs[2] = static_cast<int>(a.localSizeBytes);
  attrs[4] = threads;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[3], fn, threads, 0));
}
