// unpack: A_pack[B, Mo, Ko, t0, t1] (contiguous) -> A[B, m, k] (contiguous),
// the tile padding dropped.
//
// Replaces the Pallas kernel src/repro/kernels/unpack/kernel.py:31
// (unpack_kernel_call, body _kernel at :18).  One thread per output element:
// writes are coalesced along k, and reads are coalesced within each t1-wide
// tile row.
//
// Bound: bytes.  At decode widths the arrays are a few KB and the launch
// itself dominates; a later PR should fuse the unpack into the producing
// mmt4d epilogue (or into RoPE and the KV scatter) rather than speed it up.
#include "common.cuh"

namespace {

template <typename T>
__global__ void unpack_kernel(const T* __restrict__ ap, T* __restrict__ out,
                              int64_t total, int64_t m, int64_t k,
                              int64_t Mo, int64_t Ko, int t0, int t1) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int64_t c = idx % k;
  int64_t r = (idx / k) % m;
  int64_t b = idx / (k * m);
  int64_t src = (((b * Mo + r / t0) * Ko + c / t1) * t0 + r % t0) * t1 + c % t1;
  out[idx] = ap[src];
}

}  // namespace

extern "C" int repro_unpack(const void* ap, void* out, int dtype, int64_t B,
                            int64_t Mo, int64_t Ko, int t0, int t1, int64_t m,
                            int64_t k, void* stream) {
  int64_t total = B * m * k;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  REPRO_DISPATCH(dtype, T,
    unpack_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)ap, (T*)out, total, m, k, Mo, Ko, t0, t1));
  return (int)cudaGetLastError();
}
