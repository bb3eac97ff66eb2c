// Shared by every kernel library of gs_tpu_torch: each .cu file is built on
// its own into a plain-C shared library (gs_tpu_torch/ops/_cuda.py), and each
// library exports this error-string helper for the Python wrappers.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* gs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
