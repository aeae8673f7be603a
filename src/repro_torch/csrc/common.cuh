// Shared helpers for the port's CUDA kernels: element types and the
// dtype codes the Python wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Launch F<float> or F<__nv_bfloat16> by dtype code; an unknown code is a
// caller bug that the wrappers already reject.
#define REPRO_DISPATCH(dtype, T, ...)                  \
  do {                                                 \
    if ((dtype) == repro::kF32) {                      \
      using T = float;                                 \
      __VA_ARGS__;                                     \
    } else if ((dtype) == repro::kBF16) {              \
      using T = __nv_bfloat16;                         \
      __VA_ARGS__;                                     \
    } else {                                           \
      return (int)cudaErrorInvalidValue;               \
    }                                                  \
  } while (0)

}  // namespace repro
