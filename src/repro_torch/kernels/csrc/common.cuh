// Shared helpers for the repro_torch CUDA kernels.
//
// Each .cu file builds into its own shared library with a plain C interface
// (loaded with ctypes by kernels/build.py).  Every exported entry point
// launches on the stream it is given and returns cudaGetLastError() as an
// int, so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define REPRO_LAUNCH_CHECK()                      \
  do {                                            \
    cudaError_t err_ = cudaGetLastError();        \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

#define REPRO_FULL_MASK 0xffffffffu

// The library's own error text (each library carries its own copy of the
// CUDA runtime, so the wrapper asks the library that failed).
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

__device__ __forceinline__ float repro_shfl(float v, int src_lane) {
  return __shfl_sync(REPRO_FULL_MASK, v, src_lane);
}
