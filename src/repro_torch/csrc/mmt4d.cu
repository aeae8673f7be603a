// mmt4d: packed matmul with a fused epilogue,
//   C_pack[mo, no, :, :] = act(sum_ko A_pack[mo, ko] @ B_pack[no, ko]^T + bias[no])
// A_pack [Mo, Ko, m_r, k_r], B_pack [No, Ko, n_r, k_r], bias [No, n_r] (optional),
// C_pack [Mo, No, m_r, n_r]; float32 accumulation, bias and activation applied
// in float32, then one cast to the element type (as the TPU kernel does).
//
// Replaces the Pallas kernel src/repro/kernels/mmt4d/kernel.py:113
// (mmt4d_kernel_call at :68, body _kernel at :43).  The TPU grid walks K_o
// sequentially and carries the sum in a VMEM scratch tile; on the GPU the K
// loop runs inside one block instead: one block per output tile (mo, no),
// each K step stages the packed A and B tiles (each one contiguous run of
// memory, which is what packing buys) in shared memory as float32, and each
// thread keeps m_r*n_r/256 sums in registers.  B rows are padded by one
// float in shared memory so the threads of a warp, which read 32 different
// B rows at one k, hit 32 different banks.
//
// Bound: at decode widths bytes (the weights are read once per step, M_o =
// 1), at prefill widths operations.  This version runs on the CUDA cores in
// float32, so it is far from either bound: a decode linear has M_o = 1 and
// N_o = 2..12 output tiles, a handful of blocks on 132 SMs.  A later PR
// should split K across blocks at decode widths, and use wgmma with TMA
// loads of the packed tiles (and m_r = 64 tiles) at prefill widths.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;   // m_r * n_r <= 4096

enum Act : int { kNone = 0, kGelu = 1, kSilu = 2, kRelu = 3, kTanh = 4 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kGelu: {  // tanh approximation, as jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kSilu: return x / (1.0f + expf(-x));
    case kRelu: return fmaxf(x, 0.0f);
    case kTanh: return tanhf(x);
    default: return x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mmt4d_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const T* __restrict__ bias, T* __restrict__ c,
             int64_t No, int64_t Ko, int m_r, int n_r, int k_r, int act) {
  extern __shared__ float smem[];
  float* As = smem;                    // [m_r][k_r]
  float* Bs = smem + m_r * k_r;        // [n_r][k_r + 1]
  const int bp = k_r + 1;
  const int64_t mo = blockIdx.x / No, no = blockIdx.x % No;
  const int tid = threadIdx.x;
  const int outs = m_r * n_r;

  float acc[kMaxPerThread];
#pragma unroll
  for (int q = 0; q < kMaxPerThread; ++q) acc[q] = 0.0f;

  const int a_tile = m_r * k_r, b_tile = n_r * k_r;
  for (int64_t ko = 0; ko < Ko; ++ko) {
    const T* at = a + (mo * Ko + ko) * a_tile;
    const T* bt = b + (no * Ko + ko) * b_tile;
    for (int i = tid; i < a_tile; i += kThreads) As[i] = repro::to_float(at[i]);
    for (int i = tid; i < b_tile; i += kThreads)
      Bs[(i / k_r) * bp + i % k_r] = repro::to_float(bt[i]);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxPerThread; ++q) {
      const int o = tid + q * kThreads;
      if (o < outs) {
        const float* ar = As + (o / n_r) * k_r;
        const float* br = Bs + (o % n_r) * bp;
        float s = acc[q];
        for (int kk = 0; kk < k_r; ++kk) s = fmaf(ar[kk], br[kk], s);
        acc[q] = s;
      }
    }
    __syncthreads();
  }

  T* ct = c + (mo * No + no) * outs;
#pragma unroll
  for (int q = 0; q < kMaxPerThread; ++q) {
    const int o = tid + q * kThreads;
    if (o < outs) {
      float v = acc[q];
      if (bias != nullptr) v += repro::to_float(bias[no * n_r + o % n_r]);
      ct[o] = repro::from_float<T>(activate(v, act));
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* bias, void* c,
           int64_t Mo, int64_t No, int64_t Ko, int m_r, int n_r, int k_r,
           int act, cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)m_r * k_r + (size_t)n_r * (k_r + 1));
  // the shared-memory opt-in is an attribute of each device: set it once
  // for every device the kernel runs on
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(
        mmt4d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  if (Mo * No == 0) return 0;
  mmt4d_kernel<T><<<(unsigned)(Mo * No), kThreads, smem, stream>>>(
      (const T*)a, (const T*)b, (const T*)bias, (T*)c, No, Ko, m_r, n_r, k_r,
      act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_mmt4d(const void* a, const void* b, const void* bias,
                           void* c, int dtype, int64_t Mo, int64_t No,
                           int64_t Ko, int m_r, int n_r, int k_r, int act,
                           void* stream) {
  if ((int64_t)m_r * n_r > (int64_t)kThreads * kMaxPerThread ||
      sizeof(float) * ((size_t)m_r * k_r + (size_t)n_r * (k_r + 1)) > 232448)
    return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, T,
    return launch<T>(a, b, bias, c, Mo, No, Ko, m_r, n_r, k_r, act,
                     (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;  // unreachable: every dtype returns
}
