// pack: A[B, M, K] (any strides) -> A_pack[B, ceil(M/t0), ceil(K/t1), t0, t1],
// partial tiles zero-filled (the paper's padding semantics).
//
// Replaces the Pallas kernel src/repro/kernels/pack/kernel.py:46
// (pack_kernel_call, body _kernel at :24).  The TPU kernel streams row-major
// (TM*t0, TK*t1) blocks through VMEM.  Here one block writes one output tile
// (t0 x t1, one contiguous run of memory), or a 32-row part of one; the
// tile's coordinates are divided out once per block, never per element.  The input's strides pick one of
// three ways to read, in the same kernel:
//
// - contiguous rows (sk == 1, rows 16-byte aligned, K a multiple of the
//   vector): every thread moves 16-byte vectors, eight in flight, and writes
//   zero vectors past the edge (the tied head packs its 57 MB embedding
//   table this way on every step);
// - a transposed view (sm == 1: prepack_params packs W^T): one block per 32
//   rows of a tile stages them in shared memory, read along the input's
//   contiguous dimension (coalesced) and written as 16-byte pieces; rows
//   are padded to an odd number of 4-byte words, so the staging writes, one
//   row per thread, hit 32 different banks;
// - any other strides: one element per thread, coalesced writes.
//
// Bound: bytes (a pure index remap, no arithmetic).  The output is
// bit-exact in every branch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;        // 16-byte vectors in flight per thread
constexpr int kStageRows = 32;    // tile rows staged per pass (transposed)
constexpr size_t kMaxStageBytes = 48 * 1024;

enum Mode : int { kVector = 0, kTransposed = 1, kScalar = 2 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ a, T* __restrict__ out, int64_t M, int64_t K,
            int64_t sb, int64_t sm, int64_t sk, int t0, int t1, int64_t Mo,
            int64_t Ko, int mode, int parts) {
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte vector
  const int64_t tile = blockIdx.x / parts;   // ((b * Mo + mo) * Ko + ko)
  const int64_t ko = tile % Ko, bm = tile / Ko;
  const int64_t mo = bm % Mo, b = bm / Mo;
  const int64_t row0 = mo * t0, col0 = ko * t1;
  const T* src = a + b * sb + row0 * sm + col0 * sk;   // element (row0, col0)
  T* dst = out + tile * t0 * t1;
  const int rows = M - row0 < t0 ? (int)(M - row0) : t0;   // valid rows
  const int cols = K - col0 < t1 ? (int)(K - col0) : t1;   // valid columns
  const int tid = threadIdx.x;

  if (mode == kVector) {
    const int vpr = t1 / V;             // vectors per tile row
    const int nv = t0 * vpr;
    for (int base = 0; base < nv; base += kThreads * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kThreads + tid;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (q < nv) {
          const int i = q / vpr, j = (q - i * vpr) * V;
          if (i < rows && j < cols)
            v[u] = __ldg(reinterpret_cast<const uint4*>(src + i * sm + j));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = base + u * kThreads + tid;
        if (q < nv) reinterpret_cast<uint4*>(dst)[q] = v[u];
      }
    }
  } else if (mode == kTransposed) {
    extern __shared__ __align__(16) unsigned char stage_raw[];
    T* s = reinterpret_cast<T*>(stage_raw);
    const int ld = t1 + 4 / (int)sizeof(T);   // an odd number of words
    const int vpr = t1 / V;
    const int i0 = (int)(blockIdx.x % parts) * kStageRows;   // this block's rows
    const int nr = min(kStageRows, t0 - i0);
    // element (i, j) of the tile lies at src[i + j * sk]: consecutive
    // threads take consecutive i
    for (int e = tid; e < nr * t1; e += kThreads) {
      const int j = e / nr, i = e - j * nr;
      T v = repro::from_float<T>(0.0f);
      if (i0 + i < rows && j < cols) v = src[(i0 + i) + j * sk];
      s[i * ld + j] = v;
    }
    __syncthreads();
    for (int q = tid; q < nr * vpr; q += kThreads) {
      const int i = q / vpr, j = (q - i * vpr) * V;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(s + i * ld + j);
      reinterpret_cast<uint4*>(dst + (int64_t)(i0 + i) * t1 + j)[0] =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    const int n = t0 * t1;
    for (int e = tid; e < n; e += kThreads) {
      const int i = e / t1, j = e - i * t1;
      T v = repro::from_float<T>(0.0f);
      if (i < rows && j < cols) v = src[i * sm + j * sk];
      dst[e] = v;
    }
  }
}

template <typename T>
int launch(const void* a, void* out, int64_t B, int64_t M, int64_t K,
           int64_t sb, int64_t sm, int64_t sk, int t0, int t1,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t Mo = (M + t0 - 1) / t0, Ko = (K + t1 - 1) / t1;
  const int64_t tiles = B * Mo * Ko;
  if (tiles == 0) return 0;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const bool vec_out = t1 % V == 0 && ((uintptr_t)out & 15) == 0;
  const size_t stage = (size_t)kStageRows * (t1 + 4 / sizeof(T)) * sizeof(T);
  int mode = kScalar, parts = 1;
  if (vec_out && sk == 1 && K % V == 0 && sm % V == 0 && (B == 1 || sb % V == 0) &&
      ((uintptr_t)a & 15) == 0)
    mode = kVector;
  else if (vec_out && sm == 1 && stage <= kMaxStageBytes)
    mode = kTransposed, parts = (t0 + kStageRows - 1) / kStageRows;
  if (tiles * parts > INT32_MAX) return (int)cudaErrorInvalidValue;
  pack_kernel<T><<<(unsigned)(tiles * parts), kThreads,
                   mode == kTransposed ? stage : 0, stream>>>(
      (const T*)a, (T*)out, M, K, sb, sm, sk, t0, t1, Mo, Ko, mode, parts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int repro_pack(const void* a, void* out, int dtype, int64_t B,
                          int64_t M, int64_t K, int64_t sb, int64_t sm,
                          int64_t sk, int t0, int t1, void* stream) {
  REPRO_DISPATCH(dtype, T,
    return launch<T>(a, out, B, M, K, sb, sm, sk, t0, t1, (cudaStream_t)stream));
  return (int)cudaErrorInvalidValue;  // unreachable: every dtype returns
}
