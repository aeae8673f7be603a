// The selective_scan kernels' shared shape (csrc/selective_scan.cu, the
// forward, and csrc/selective_scan_bwd.cu, its backward): the lanes per
// channel, the channels per block and the steps per staged chunk, which
// are also the backward's checkpoint interval
// (kernels/selective_scan/ref.py:scan_chunk mirrors kSteps).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kScanThreads = 128;

template <typename T, int N> struct ScanShape {
  static constexpr int kLanes = N / 4;               // lanes per channel
  static constexpr int kCh = kScanThreads / kLanes;      // channels per block
  // steps per staged chunk: two chunks of operands and the lanes' partial
  // sums of y fit the 48 KB of static shared memory
  static constexpr int kSteps = N == 8 ? 16 : sizeof(T) == 2 ? 32 : 24;
};

// 4 consecutive values of T from shared memory, as floats (16 or 8 bytes)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *(const float4*)p;
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *(const uint2*)p;
  const float2 lo = __bfloat1622float2(*(const __nv_bfloat162*)&v.x);
  const float2 hi = __bfloat1622float2(*(const __nv_bfloat162*)&v.y);
  o[0] = lo.x, o[1] = lo.y, o[2] = hi.x, o[3] = hi.y;
}

}  // namespace repro
