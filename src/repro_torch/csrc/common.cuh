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

// Asynchronous copies of `bytes` (4, 8 or 16) from global into shared
// memory (cp.async; 16 bytes bypass L1), committed and waited for by group.
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Stage `rows` rows of `row_bytes` from global memory (rows `stride` bytes
// apart) into shared memory (rows `smem_stride` bytes apart), in pieces of
// `gran` bytes spread over `nthreads` threads (this one is `tid`):
// cp.async for 4, 8 and 16, a plain load and store for 2 (a bfloat16 view
// at an odd element).  The caller picks `gran` with copy_granule, so
// every piece is aligned.
__device__ __forceinline__ void stage_rows(void* smem, int smem_stride,
                                           const void* gmem, int64_t stride,
                                           int rows, int row_bytes, int gran,
                                           int tid, int nthreads) {
  const int per_row = row_bytes / gran;
  char* dst = (char*)smem;
  const char* src = (const char*)gmem;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row, c = (i - r * per_row) * gran;
    if (gran >= 4)
      cp_async(dst + r * smem_stride + c, src + r * stride + c, gran);
    else
      *(uint16_t*)(dst + r * smem_stride + c) = *(const uint16_t*)(src + r * stride + c);
  }
}

// The widest piece (16, 8 or 4 bytes, else the element) that divides the
// address and every byte stride and width given: decided on the host from
// the pointers and strides, so a view that is not 16-byte aligned takes a
// narrower copy rather than being refused.
inline int copy_granule(const void* p, int elem, int64_t a, int64_t b, int64_t c) {
  for (int g = 16; g > elem; g /= 2)
    if ((uintptr_t)p % g == 0 && (a * elem) % g == 0 && (b * elem) % g == 0 &&
        (c * elem) % g == 0)
      return g;
  return elem;
}

// A sum over partials, the second pass of a kernel whose blocks cannot
// add into one output without atomics: out[o, i] = sum_p part[o, p, i]
// over p in ascending order (part [outer, P, inner] float32), stored as
// float32 or, with `bf16`, rounded to bfloat16.  Every output element is
// summed by one thread in a fixed order, so repeated calls are
// bit-identical.
struct SumJob {
  const float* part;
  void* out;
  int64_t outer, inner;
  int P, bf16;
};

__device__ __forceinline__ void sum_partials(const SumJob& j) {
  const int64_t n = j.outer * j.inner;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t o = e / j.inner, i = e - o * j.inner;
    const float* p = j.part + o * j.P * j.inner + i;
    float v = p[0];
    for (int q = 1; q < j.P; ++q) v += p[(int64_t)q * j.inner];
    if (j.bf16)
      ((__nv_bfloat16*)j.out)[e] = __float2bfloat16(v);
    else
      ((float*)j.out)[e] = v;
  }
}

// blocks of 256 threads for a sum over n outputs (a grid-stride loop past 2048)
inline unsigned sum_blocks(int64_t n) {
  const int64_t b = (n + 255) / 256;
  return (unsigned)(b < 1 ? 1 : b > 2048 ? 2048 : b);
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
