// selective_scan: mamba's selective SSM recurrence, token-serial, per
// (row, channel), from the state h0 in `state`:
//
//   a[d, n]    = -exp(a_log[d, n])
//   h_t[d, n]  = exp(delta_t[d] a[d, n]) h_{t-1}[d, n] + delta_t[d] B_t[n] x_t[d]
//   y_t[d]     = (sum_n h_t[d, n] C_t[n] + D[d] x_t[d]) silu(z_t[d])
//
// delta: [B, S, DI] float32, contiguous.  x, z: [B, S, DI] views in T
// (float32 or bfloat16) with unit channel stride (z is the second half of
// the in-projection's output, read in place); Bm and Cm: [B, S, N] views
// in T with unit stride (slices of the x-projection's output).  Their row
// and token strides are passed in elements.  a_log: [DI, N] float32, D:
// [DI] float32, state: [B, DI, N] float32, read as h0 and overwritten with
// the final state (the engine's per-slot state, updated in place).  y:
// [B, S, DI] in T, contiguous.  With h0 = 0 the first step is exactly
// delta B x (0 times anything adds 0), the train/prefill mode; with the
// cached state it is the decode step or a prefill from the cache.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as a
// lax.associative_scan over [B, S, DI, N] float32 tensors
// (src/repro/models/mamba.py:79, _ssm_scan), outside Pallas.  Without a
// kernel the port would build three such tensors a layer (exp(delta a),
// delta B x and every h_t; 268 MB each at jamba's widths for a 512-token
// prefill) and loop over the sequence in about two launches per token.
//
// Bound: bytes (delta, x, z and y per token and channel, B and C per
// token, the state read and written once); the ~8 operations per
// (token, channel, state) element are a few percent of the card's float32
// rate.  But a prefill is a chain of S dependent steps, so its time is the
// chain's latency.  The design keeps everything but that chain off the
// critical path:
//
// - One thread per (row, channel), 128 channels a block; the thread holds
//   its N state floats and its N values of a in registers for the whole
//   sequence, so the state is read from memory once and written once per
//   call, and channels need no exchange.
// - B_t and C_t, the same for every channel of the row, are staged for a
//   chunk of kChunk steps through shared memory in one coalesced pass and
//   read as broadcasts; delta, x and z are read coalesced along channels.
// - The products are rounded as the plain version rounds them (separate
//   multiplies and adds, __fmul_rn / __fadd_rn: no contraction into FMAs),
//   with the accurate expf, so the state matches the plain version on the
//   card bit for bit where expf does; only the sum over n (an FMA chain in
//   n order here, a batched product there) is taken in another order.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kChunk = 64;      // steps of B and C staged per pass

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ delta, const T* __restrict__ x,
                      int64_t xb, int64_t xt, const T* __restrict__ z,
                      int64_t zb, int64_t zt, const T* __restrict__ bm,
                      int64_t bb, int64_t bt, const T* __restrict__ cm,
                      int64_t cb, int64_t ct, const float* __restrict__ a_log,
                      const float* __restrict__ d_skip, float* state,
                      T* __restrict__ y, int S, int DI) {
  __shared__ float sb[kChunk][N], sc[kChunk][N];
  const int row = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < DI;
  float h[N], a[N], skip = 0.f;
  // the state is read whole before any of it is written, by its own thread
  float* sp = state + ((int64_t)row * DI + d) * N;
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = sp[n];
      a[n] = -expf(a_log[(int64_t)d * N + n]);
    }
    skip = d_skip[d];
  }
  const T* xr = x + row * xb + d;
  const T* zr = z + row * zb + d;
  const T* br = bm + row * bb;
  const T* cr = cm + row * cb;
  const float* dr = delta + (int64_t)row * S * DI + d;
  T* yr = y + (int64_t)row * S * DI + d;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int cnt = S - t0 < kChunk ? S - t0 : kChunk;
    __syncthreads();                       // the last chunk's reads are done
    for (int i = threadIdx.x; i < cnt * N; i += kThreads) {
      const int c = i / N, n = i - c * N;
      sb[c][n] = repro::to_float(br[(t0 + c) * bt + n]);
      sc[c][n] = repro::to_float(cr[(t0 + c) * ct + n]);
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < cnt; ++c) {
      const int t = t0 + c;
      const float dt = dr[(int64_t)t * DI];
      const float xv = repro::to_float(xr[t * xt]);
      const float zv = repro::to_float(zr[t * zt]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float da = expf(__fmul_rn(dt, a[n]));
        const float dbx = __fmul_rn(__fmul_rn(dt, sb[c][n]), xv);
        h[n] = __fadd_rn(__fmul_rn(da, h[n]), dbx);
        acc = fmaf(h[n], sc[c][n], acc);
      }
      const float out = __fadd_rn(acc, __fmul_rn(skip, xv));
      const float gate = zv / (1.f + expf(-zv));
      yr[(int64_t)t * DI] = repro::from_float<T>(__fmul_rn(out, gate));
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) sp[n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* delta, const void* x, int64_t xb, int64_t xt,
           const void* z, int64_t zb, int64_t zt, const void* bm, int64_t bb,
           int64_t bt, const void* cm, int64_t cb, int64_t ct,
           const void* a_log, const void* d_skip, void* state, void* y, int B,
           int S, int DI, cudaStream_t stream) {
  const dim3 grid((unsigned)((DI + kThreads - 1) / kThreads), (unsigned)B);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      (const float*)delta, (const T*)x, xb, xt, (const T*)z, zb, zt,
      (const T*)bm, bb, bt, (const T*)cm, cb, ct, (const float*)a_log,
      (const float*)d_skip, (float*)state, (T*)y, S, DI);
  return (int)cudaGetLastError();
}

template <int N>
int dispatch(int dtype, const void* delta, const void* x, int64_t xb,
             int64_t xt, const void* z, int64_t zb, int64_t zt,
             const void* bm, int64_t bb, int64_t bt, const void* cm,
             int64_t cb, int64_t ct, const void* a_log, const void* d_skip,
             void* state, void* y, int B, int S, int DI, cudaStream_t stream) {
  REPRO_DISPATCH(dtype, T,
                 return launch<T, N>(delta, x, xb, xt, z, zb, zt, bm, bb, bt,
                                     cm, cb, ct, a_log, d_skip, state, y, B, S,
                                     DI, stream));
  return (int)cudaErrorInvalidValue;  // unreachable: every dtype returns
}

}  // namespace

// The strides of x, z, B and C (row, then token) are in elements; N is
// one of the instances below (8: the reduced configs; 16: jamba's).
extern "C" int repro_selective_scan(
    const void* delta, const void* x, int64_t xb, int64_t xt, const void* z,
    int64_t zb, int64_t zt, const void* bm, int64_t bb, int64_t bt,
    const void* cm, int64_t cb, int64_t ct, const void* a_log,
    const void* d_skip, void* state, void* y, int B, int S, int DI, int N,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || DI <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (N) {
    case 8:
      return dispatch<8>(dtype, delta, x, xb, xt, z, zb, zt, bm, bb, bt, cm,
                         cb, ct, a_log, d_skip, state, y, B, S, DI, st);
    case 16:
      return dispatch<16>(dtype, delta, x, xb, xt, z, zb, zt, bm, bb, bt, cm,
                          cb, ct, a_log, d_skip, state, y, B, S, DI, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
