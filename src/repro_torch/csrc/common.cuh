// Shared helpers for the port's CUDA kernels: element types, the dtype
// codes the Python wrappers pass (0 = float32, 1 = bfloat16) and the
// shared-memory opt-in.
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

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 inputs, float32 sums
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMaxSmem = 232448;   // 227 KB opt-in dynamic shared memory
constexpr int kMaxDevices = 64;

// The shared-memory opt-in is an attribute of each device: set it once per
// device and kernel.
template <typename Kernel>
int opt_in_smem(Kernel kernel, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  return 0;
}

}  // namespace repro
