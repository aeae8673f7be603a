// pack: A[B, M, K] (any strides) -> A_pack[B, ceil(M/t0), ceil(K/t1), t0, t1],
// partial tiles zero-filled (the paper's padding semantics).
//
// Replaces the Pallas kernel src/repro/kernels/pack/kernel.py:46
// (pack_kernel_call, body _kernel at :24).  The TPU kernel streams row-major
// (TM*t0, TK*t1) blocks through VMEM; here one thread writes one output
// element, so writes are fully coalesced, and reads go through the input's
// strides: the RHS of a matmul is packed from B^T, a strided view, without a
// .contiguous() copy first.
//
// Bound: bytes (a pure index remap, no arithmetic).  When the input is a
// transposed view, neighbouring threads read addresses a row apart, so the
// reads are not coalesced; a later PR should stage a tile through shared
// memory (read rows coalesced, write tiles coalesced) and move 16 bytes per
// thread.
#include "common.cuh"

namespace {

template <typename T>
__global__ void pack_kernel(const T* __restrict__ a, T* __restrict__ out,
                            int64_t total, int64_t M, int64_t K,
                            int64_t sb, int64_t sm, int64_t sk,
                            int t0, int t1, int64_t Mo, int64_t Ko) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // out index = (((b*Mo + mo)*Ko + ko)*t0 + i)*t1 + j
  int64_t j = idx % t1;
  int64_t r = idx / t1;
  int64_t i = r % t0;
  r /= t0;
  int64_t ko = r % Ko;
  r /= Ko;
  int64_t mo = r % Mo;
  int64_t b = r / Mo;
  int64_t row = mo * t0 + i, col = ko * t1 + j;
  T v = repro::from_float<T>(0.0f);
  if (row < M && col < K) v = a[b * sb + row * sm + col * sk];
  out[idx] = v;
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int repro_pack(const void* a, void* out, int dtype, int64_t B,
                          int64_t M, int64_t K, int64_t sb, int64_t sm,
                          int64_t sk, int t0, int t1, void* stream) {
  int64_t Mo = (M + t0 - 1) / t0, Ko = (K + t1 - 1) / t1;
  int64_t total = B * Mo * Ko * t0 * t1;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  REPRO_DISPATCH(dtype, T,
    pack_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)a, (T*)out, total, M, K, sb, sm, sk, t0, t1, Mo, Ko));
  return (int)cudaGetLastError();
}
