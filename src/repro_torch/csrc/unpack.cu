// unpack: A_pack[B, Mo, Ko, t0, t1] (contiguous) -> A[B, m, k] (contiguous),
// the tile padding dropped.
//
// Replaces the Pallas kernel src/repro/kernels/unpack/kernel.py:31
// (unpack_kernel_call, body _kernel at :18).
//
// Bound: bytes, each input byte read once and each output byte written
// once, and at decode widths the launch: the final stream of a decode step
// is 18 KB, which the card moves in about 0.01 us, against a launch floor of
// about 2 us.  So the design keeps the kernel's own time near that floor
// and lets the launch overlap its producer:
//
// - 16-byte copies.  Thread (x, y) moves one 16-byte vector (8 bf16 or 4
//   float32) of output row y; where t1 and k are multiples of the vector
//   width the same 16 bytes are contiguous in the tile row, so every load
//   and store is one 128-bit access and a warp touches whole sectors.
// - 32-bit index arithmetic.  Rows (batch x m) run on y, column vectors on
//   x; each thread divides once for its tile column and twice per row
//   (none per element, none in 64 bits), before it waits on its producer.
// - Programmatic dependent launch, as mmt4d: the kernel may be scheduled
//   while the previous kernel on the stream drains, and waits on
//   griddepcontrol before its first read.
// - A scalar variant (one element per thread, same grid) where k, t1 or a
//   pointer breaks 16-byte alignment; kernels/unpack/ops.py picks it.
//
// Where its other uses went: a linear's result leaves the packed domain
// through mmt4d's unpacked store (csrc/mmt4d.cu, core/linear.py), so the
// Q/K/V exits and the tied-head logits, 91 of the 92 unpacks a SmolLM2
// flat step would otherwise launch, launch none.  What stays is the final
// stream before the logits row gather (models/transformer.py:lm_apply) and
// any other caller of core/packing.py:unpack_lhs / unpack_out.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// V is the unit a thread moves: uint4 (16 bytes) or T itself (the scalar
// variant).  Grid (ceil(k / EPV / tx), ceil(rows / ty)), block (tx, ty).
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const T* __restrict__ ap, T* __restrict__ out, int rows, int m,
              int k, int Mo, int Ko, int t0, int t1) {
  constexpr int EPV = sizeof(V) / sizeof(T);
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * EPV;
  const int ko = c / t1, ci = c - ko * t1;
  const int tile = t0 * t1;
  auto source = [&](int y) {            // output row y, column c
    const int b = y / m, r = y - b * m;
    const int mo = r / t0, mi = r - mo * t0;
    return ap + (((int64_t)b * Mo + mo) * Ko + ko) * tile + mi * t1 + ci;
  };
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  const T* src = source(y);             // reads no memory: done before the wait
  // launched as a programmatic dependent: wait here, before the first read,
  // until the previous kernel on the stream has finished and flushed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (c >= k) return;
  for (; y < rows; y += gridDim.y * blockDim.y, src = source(y))
    *reinterpret_cast<V*>(out + (int64_t)y * k + c) = *reinterpret_cast<const V*>(src);
}

template <typename T, typename V>
int launch(const void* ap, void* out, int rows, int m, int k, int Mo, int Ko,
           int t0, int t1, cudaStream_t stream) {
  constexpr int EPV = sizeof(V) / sizeof(T);
  const int vecs = k / EPV;
  const int tx = vecs >= kThreads ? kThreads : (vecs + 31) / 32 * 32;
  const int ty = kThreads / tx;
  const int gy = (rows + ty - 1) / ty;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((vecs + tx - 1) / tx), (unsigned)(gy < 65535 ? gy : 65535));
  cfg.blockDim = dim3((unsigned)tx, (unsigned)ty);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, unpack_kernel<T, V>, (const T*)ap,
                                     (T*)out, rows, m, k, Mo, Ko, t0, t1);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// wait != 0: does nothing but wait on griddepcontrol, as every kernel
// launched as a programmatic dependent must before its first read
__global__ void empty_kernel(int wait) {
  if (wait) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

}  // namespace

// vec = 1: 16-byte copies, which need k and t1 multiples of 16 bytes'
// worth of elements and both pointers on 16 bytes (else refused); vec = 0:
// the scalar variant.
extern "C" int repro_unpack(const void* ap, void* out, int dtype, int64_t B,
                            int64_t Mo, int64_t Ko, int t0, int t1, int64_t m,
                            int64_t k, int vec, void* stream) {
  if (B < 0 || m < 0 || k < 0 || t0 < 1 || t1 < 1 || m > Mo * t0 ||
      k > Ko * t1 || B * m > INT32_MAX || k > INT32_MAX ||
      B * Mo > INT32_MAX || (int64_t)t0 * t1 > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (B * m * k == 0) return 0;
  const int esize = dtype == repro::kBF16 ? 2 : 4;
  if (vec && ((k * esize) % 16 != 0 || (t1 * esize) % 16 != 0 ||
              (((uintptr_t)ap | (uintptr_t)out) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const int rows = (int)(B * m);
  REPRO_DISPATCH(dtype, T,
    return vec ? launch<T, uint4>(ap, out, rows, (int)m, (int)k, (int)Mo, (int)Ko,
                                  t0, t1, (cudaStream_t)stream)
               : launch<T, T>(ap, out, rows, (int)m, (int)k, (int)Mo, (int)Ko,
                              t0, t1, (cudaStream_t)stream));
}

// An empty kernel, launched as unpack launches: the floor that a call of
// a few kilobytes is held against (chip_smoke.py).
extern "C" int repro_empty_launch(int wait, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel, wait);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
