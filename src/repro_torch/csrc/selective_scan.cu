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
// [B, S, DI] in T, contiguous.  ckpt, when not null (a train step's
// forward; serving passes null): [B, ceil(S / kSteps) - 1, DI, N], the
// state before each staged chunk but the first, from which the backward
// (csrc/selective_scan_bwd.cu) recomputes each chunk's states.  With h0 = 0 the first step is exactly
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
// token, the state read and written once).  But the work is ~8 operations
// per (token, channel, state) element, one of them an accurate expf, so a
// prefill is bound by the issue rate of the SMs it fills, and a decode
// call (one step) by the state's bytes and the launch.  The design:
//
// - N split over lanes: N / 4 lanes per channel (4 at N = 16, 2 at N = 8),
//   each holding 4 state floats and 4 values of a in registers for the
//   whole sequence; 128 threads a block cover 128 / (N / 4) channels, so a
//   one-row prefill at di 8192 fills 256 blocks.  A lane reads its 4
//   state and 4 a_log floats as one 16-byte load (a warp reads 512
//   contiguous bytes) and writes the final state the same way.  y's sum
//   over n is each lane's partial, written to shared memory and added
//   over the lanes once per chunk (no shuffle in the step loop, whose
//   unrolled steps then overlap).
// - delta, x, z, B and C are staged per chunk of kSteps steps through
//   shared memory, double-buffered: the next chunk's cp.async copies are
//   in flight while this chunk's steps run, so the step loop reads only
//   shared memory and registers.  Each operand is copied in the widest
//   piece (16, 8 or 4 bytes, or a bfloat16 element) that its address and
//   strides allow, chosen on the host (copy_granule), so the unaligned
//   views of odd widths are taken, not refused.
// - The step loop only carries the recurrence and y's contraction; the
//   lanes' sum, the skip, the gate's silu and the cast run once per chunk
//   over all 128 threads, one (step, channel) each, with coalesced stores
//   of y.  A one-step call (the decode step) reads its operands straight
//   from memory instead, with the same arithmetic and no barrier.
// - The state's products are rounded as the plain version rounds them
//   (separate multiplies and adds, __fmul_rn / __fadd_rn: no contraction
//   into FMAs), with the accurate expf, so the state matches the plain
//   version on the card bit for bit where expf does; only the sum over n
//   (per-lane FMA chains, then the shuffles) is taken in another order.
#include "selective_scan.cuh"

namespace {

constexpr int kThreads = repro::kScanThreads;
using repro::ScanShape;
using repro::load4;

// The copy widths, in bytes, of delta, x, z, B and C (copy_granule), and
// whether the state and a_log are 16-byte aligned.
struct Granules {
  int d, x, z, b, c, vec;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ delta, const T* __restrict__ x,
                      int64_t xb, int64_t xt, const T* __restrict__ z,
                      int64_t zb, int64_t zt, const T* __restrict__ bm,
                      int64_t bb, int64_t bt, const T* __restrict__ cm,
                      int64_t cb, int64_t ct, const float* __restrict__ a_log,
                      const float* __restrict__ d_skip, float* state,
                      T* __restrict__ y, float* __restrict__ ckpt, int S, int DI,
                      Granules g) {
  using Shape = ScanShape<T, N>;
  constexpr int kLanes = Shape::kLanes, kCh = Shape::kCh, kSteps = Shape::kSteps;
  constexpr int es = sizeof(T);
  __shared__ __align__(16) float sd[2][kSteps][kCh];
  __shared__ __align__(16) T sx[2][kSteps][kCh], sz[2][kSteps][kCh];
  __shared__ __align__(16) T sb[2][kSteps][N], sc[2][kSteps][N];
  __shared__ __align__(16) float sy[kSteps][kThreads];   // lanes' partials
  __shared__ float sskip[kCh];
  const int row = blockIdx.y, c0 = blockIdx.x * kCh;
  const int ch = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = c0 + ch;
  const int valid = DI - c0 < kCh ? DI - c0 : kCh;   // channels of this block
  const bool live = ch < valid;

  const float* dr = delta + (int64_t)row * S * DI + c0;
  const T* xr = x + row * xb + c0;
  const T* zr = z + row * zb + c0;
  const T* br = bm + row * bb;
  const T* cr = cm + row * cb;
  auto stage = [&](int buf, int t0) {
    const int cnt = S - t0 < kSteps ? S - t0 : kSteps;
    repro::stage_rows(sd[buf], kCh * 4, dr + (int64_t)t0 * DI, (int64_t)DI * 4,
                      cnt, valid * 4, g.d, threadIdx.x, kThreads);
    repro::stage_rows(sx[buf], kCh * es, xr + t0 * xt, xt * es, cnt,
                      valid * es, g.x, threadIdx.x, kThreads);
    repro::stage_rows(sz[buf], kCh * es, zr + t0 * zt, zt * es, cnt,
                      valid * es, g.z, threadIdx.x, kThreads);
    repro::stage_rows(sb[buf], N * es, br + t0 * bt, bt * es, cnt, N * es, g.b,
                      threadIdx.x, kThreads);
    repro::stage_rows(sc[buf], N * es, cr + t0 * ct, ct * es, cnt, N * es, g.c,
                      threadIdx.x, kThreads);
    repro::cp_async_commit();
  };
  if (S > 1) stage(0, 0);

  // the state is read whole before any of it is written, by its own lane
  float h[4] = {0.f, 0.f, 0.f, 0.f}, a[4] = {0.f, 0.f, 0.f, 0.f};
  float* sp = state + ((int64_t)row * DI + d) * N + 4 * lane;
  const float* ap = a_log + (int64_t)d * N + 4 * lane;
  if (live) {
    if (g.vec) {
      const float4 hv = *(const float4*)sp, av = *(const float4*)ap;
      h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
      a[0] = av.x, a[1] = av.y, a[2] = av.z, a[3] = av.w;
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) h[n] = sp[n], a[n] = ap[n];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) a[n] = -expf(a[n]);
  }
  if (S == 1) {
    // one step (the decode step): its operands straight from memory, the
    // same arithmetic, no staging and no barrier
    float dt = 0.f, xv = 0.f, zv = 0.f, bn[4], cn[4];
    if (live) {
      dt = dr[ch];
      xv = repro::to_float(xr[ch]);
      zv = repro::to_float(zr[ch]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      bn[n] = repro::to_float(br[4 * lane + n]);
      cn[n] = repro::to_float(cr[4 * lane + n]);
    }
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float da = expf(__fmul_rn(dt, a[n]));
      const float dbx = __fmul_rn(__fmul_rn(dt, bn[n]), xv);
      h[n] = __fadd_rn(__fmul_rn(da, h[n]), dbx);
      acc = fmaf(h[n], cn[n], acc);
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (live && lane == 0) {
      const float out = __fadd_rn(acc, __fmul_rn(d_skip[d], xv));
      const float gate = zv / (1.f + expf(-zv));
      y[(int64_t)row * DI + d] = repro::from_float<T>(__fmul_rn(out, gate));
    }
  }
  if (threadIdx.x < valid) sskip[threadIdx.x] = d_skip[c0 + threadIdx.x];

  for (int t0 = 0, buf = 0; S > 1 && t0 < S; t0 += kSteps, buf ^= 1) {
    const int cnt = S - t0 < kSteps ? S - t0 : kSteps;
    if (ckpt != nullptr && t0 > 0 && live) {   // the state before this chunk
      float* cp = ckpt + (((int64_t)row * ((S - 1) / kSteps) + t0 / kSteps - 1) * DI + d) * N +
                  4 * lane;
#pragma unroll
      for (int n = 0; n < 4; ++n) cp[n] = h[n];
    }
    if (t0 + kSteps < S) {
      stage(buf ^ 1, t0 + kSteps);   // its buffer was last read before the
      repro::cp_async_wait<1>();     // previous chunk's closing barrier
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < cnt; ++c) {   // steps interleave: their expf and
      const float dt = sd[buf][c][ch];  // loads do not wait on h
      const float xv = repro::to_float(sx[buf][c][ch]);
      float bn[4], cn[4];
      load4(&sb[buf][c][4 * lane], bn);
      load4(&sc[buf][c][4 * lane], cn);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float da = expf(__fmul_rn(dt, a[n]));
        const float dbx = __fmul_rn(__fmul_rn(dt, bn[n]), xv);
        h[n] = __fadd_rn(__fmul_rn(da, h[n]), dbx);
        acc = fmaf(h[n], cn[n], acc);
      }
      // the lanes' partials are summed below: a shuffle here would keep
      // the steps from overlapping
      sy[c][threadIdx.x] = acc;
    }
    __syncthreads();
    // skip, gate and cast: one (step, channel) a thread, stores coalesced
    T* yr = y + ((int64_t)row * S + t0) * DI + c0;
    for (int i = threadIdx.x; i < cnt * kCh; i += kThreads) {
      const int c = i / kCh, j = i % kCh;
      if (j >= valid) continue;
      const float xv = repro::to_float(sx[buf][c][j]);
      const float zv = repro::to_float(sz[buf][c][j]);
      float acc;   // the lanes' partials, added as the xor shuffles add them
      if constexpr (kLanes == 4) {
        const float4 q = *(const float4*)&sy[c][4 * j];
        acc = (q.x + q.y) + (q.z + q.w);
      } else {
        const float2 q = *(const float2*)&sy[c][2 * j];
        acc = q.x + q.y;
      }
      const float out = __fadd_rn(acc, __fmul_rn(sskip[j], xv));
      const float gate = zv / (1.f + expf(-zv));
      yr[(int64_t)c * DI + j] = repro::from_float<T>(__fmul_rn(out, gate));
    }
    __syncthreads();   // this chunk's buffers are read: the next may refill them
  }
  if (live) {
    if (g.vec) {
      *(float4*)sp = make_float4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) sp[n] = h[n];
    }
  }
}

template <typename T, int N>
int launch(const void* delta, const void* x, int64_t xb, int64_t xt,
           const void* z, int64_t zb, int64_t zt, const void* bm, int64_t bb,
           int64_t bt, const void* cm, int64_t cb, int64_t ct,
           const void* a_log, const void* d_skip, void* state, void* y, void* ckpt,
           int B, int S, int DI, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  const Granules g{
      repro::copy_granule(delta, 4, (int64_t)S * DI, DI, DI),
      repro::copy_granule(x, es, xb, xt, DI),
      repro::copy_granule(z, es, zb, zt, DI),
      repro::copy_granule(bm, es, bb, bt, N),
      repro::copy_granule(cm, es, cb, ct, N),
      (uintptr_t)state % 16 == 0 && (uintptr_t)a_log % 16 == 0};
  constexpr int kCh = ScanShape<T, N>::kCh;
  const dim3 grid((unsigned)((DI + kCh - 1) / kCh), (unsigned)B);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      (const float*)delta, (const T*)x, xb, xt, (const T*)z, zb, zt,
      (const T*)bm, bb, bt, (const T*)cm, cb, ct, (const float*)a_log,
      (const float*)d_skip, (float*)state, (T*)y, (float*)ckpt, S, DI, g);
  return (int)cudaGetLastError();
}

template <int N>
int dispatch(int dtype, const void* delta, const void* x, int64_t xb,
             int64_t xt, const void* z, int64_t zb, int64_t zt,
             const void* bm, int64_t bb, int64_t bt, const void* cm,
             int64_t cb, int64_t ct, const void* a_log, const void* d_skip,
             void* state, void* y, void* ckpt, int B, int S, int DI,
             cudaStream_t stream) {
  REPRO_DISPATCH(dtype, T,
                 return launch<T, N>(delta, x, xb, xt, z, zb, zt, bm, bb, bt,
                                     cm, cb, ct, a_log, d_skip, state, y, ckpt,
                                     B, S, DI, stream));
  return (int)cudaErrorInvalidValue;  // unreachable: every dtype returns
}

}  // namespace

// The strides of x, z, B and C (row, then token) are in elements; N is
// one of the instances below (8: the reduced configs; 16: jamba's).  ckpt:
// null, or the state before each chunk of kSteps steps but the first.
extern "C" int repro_selective_scan(
    const void* delta, const void* x, int64_t xb, int64_t xt, const void* z,
    int64_t zb, int64_t zt, const void* bm, int64_t bb, int64_t bt,
    const void* cm, int64_t cb, int64_t ct, const void* a_log,
    const void* d_skip, void* state, void* y, void* ckpt, int B, int S, int DI,
    int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || DI <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  switch (N) {
    case 8:
      return dispatch<8>(dtype, delta, x, xb, xt, z, zb, zt, bm, bb, bt, cm,
                         cb, ct, a_log, d_skip, state, y, ckpt, B, S, DI, st);
    case 16:
      return dispatch<16>(dtype, delta, x, xb, xt, z, zb, zt, bm, bb, bt, cm,
                          cb, ct, a_log, d_skip, state, y, ckpt, B, S, DI, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
