// selective_scan_bwd: the backward of mamba's selective scan with its
// output contraction, skip and gate (csrc/selective_scan.cu), per (row,
// channel).  Forward, with a = -exp(a_log) and da_t = exp(delta_t a):
//
//   h_t    = da_t h_{t-1} + delta_t B_t x_t            (h_{-1} = h0)
//   y_t    = sum_n h_t C_t + D x_t,   out_t = y_t silu(z_t)
//
// Backward from dout, with G_t the gradient of h_t, walking the steps
// backwards:
//
//   dy_t  = dout_t silu(z_t),  dz_t = dout_t y_t silu'(z_t)
//   G_t   = dy_t C_t + da_{t+1} G_{t+1}
//   dC_t  = sum_d dy_t h_t,    dB_t = sum_d G_t delta_t x_t     (over channels)
//   dx_t  = dy_t D + sum_n G_t delta_t B_t
//   ddelta_t = sum_n G_t (B_t x_t + h_{t-1} da_t a)
//   da_log = a sum_t G_t h_{t-1} da_t delta_t,  dD = sum_t dy_t x_t  (then over rows)
//   dh0   = da_0 G_0
//
// Replaces no Pallas kernel: the JAX package differentiates its
// lax.associative_scan (src/repro/models/mamba.py:79, _ssm_scan) and the
// body around it (:114-132); kernels/selective_scan/ref.py:
// selective_scan_bwd_ref is this algorithm in PyTorch.
//
// The layout is the forward's: a block of 128 threads holds kCh channels
// of one row, N / 4 lanes a channel, each lane 4 states (and G, and the
// sums for da_log) in registers.  The forward writes the state before
// each of its staged chunks (ckpt); the backward walks the chunks in
// reverse, stages a chunk's delta, x, z, dout, B and C, recomputes the
// chunk's states from its checkpoint into shared memory (the forward's
// arithmetic and rounding), then runs the steps backwards.  The sums over
// n are xor shuffles among a channel's lanes; the sums over channels (dB,
// dC) xor shuffles among a warp's channels, then the 4 warps' partials in
// order, written per block; a second kernel (selective_scan_bwd_sum_kernel)
// adds the blocks' partials in block order, and the rows' partials of
// da_log and dD in row order.  No atomics: repeated calls are
// bit-identical.  Sums in float32; dx, dz, dB and dC stored in T.
//
// Bound: bytes (delta, x, z, dout, B and C read once, their gradients
// written once, the checkpoints read), but, as the forward, the ~20
// operations per (step, channel, state) element with two expf make it
// issue-bound on the SMs it fills.
#include "selective_scan.cuh"

namespace {

constexpr int kThreads = repro::kScanThreads;
constexpr int kWarps = kThreads / 32;
using repro::ScanShape;
using repro::load4;

// Shared memory, in bytes: the staged chunk (delta, x, z, dout [L][kCh],
// B, C [L][N]), the chunk's states [L][kThreads] float4, the per-channel
// outputs ddelta, dx, dz [L][kCh] float32, the warps' partials of dB and
// dC [L][kWarps][N] float32.
template <typename T, int N> struct BwdSmem {
  using S_ = ScanShape<T, N>;
  static constexpr int L = S_::kSteps, C = S_::kCh;
  static constexpr int kDelta = 0;
  static constexpr int kX = kDelta + L * C * 4;
  static constexpr int kZ = kX + L * C * (int)sizeof(T);
  static constexpr int kDo = kZ + L * C * (int)sizeof(T);
  static constexpr int kB = kDo + L * C * (int)sizeof(T);
  static constexpr int kC = kB + L * N * (int)sizeof(T);
  static constexpr int kH = (kC + L * N * (int)sizeof(T) + 15) / 16 * 16;
  static constexpr int kOut = kH + L * kThreads * 16;
  static constexpr int kPart = kOut + 3 * L * C * 4;
  static constexpr int kBytes = kPart + 2 * L * kWarps * N * 4;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ delta, const T* __restrict__ x,
                          int64_t xb, int64_t xt, const T* __restrict__ z, int64_t zb,
                          int64_t zt, const T* __restrict__ bm, int64_t bb, int64_t bt,
                          const T* __restrict__ cm, int64_t cb, int64_t ct,
                          const float* __restrict__ a_log, const float* __restrict__ d_skip,
                          const float* __restrict__ h0, const T* __restrict__ dout,
                          const float* __restrict__ ckpt, float* __restrict__ ddelta,
                          T* __restrict__ dx, T* __restrict__ dz, float* __restrict__ part_b,
                          float* __restrict__ part_c, float* __restrict__ part_a,
                          float* __restrict__ part_d, float* __restrict__ dh0, int S,
                          int DI) {
  using Shape = ScanShape<T, N>;
  using M = BwdSmem<T, N>;
  constexpr int kLanes = Shape::kLanes, kCh = Shape::kCh, L = Shape::kSteps;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sd = (float*)(smem + M::kDelta);     // [L][kCh]
  T* sx = (T*)(smem + M::kX);
  T* sz = (T*)(smem + M::kZ);
  T* sdo = (T*)(smem + M::kDo);
  T* sb = (T*)(smem + M::kB);                 // [L][N]
  T* sc = (T*)(smem + M::kC);
  float4* hs = (float4*)(smem + M::kH);       // [L][kThreads]
  float* od = (float*)(smem + M::kOut);       // [3][L][kCh]: ddelta, dx, dz
  float* wp = (float*)(smem + M::kPart);      // [2][L][kWarps][N]: dB, dC

  const int row = blockIdx.y, c0 = blockIdx.x * kCh;
  const int tid = threadIdx.x, ch = tid / kLanes, lane = tid % kLanes;
  const int warp = tid / 32, wl = tid % 32;
  const int d = c0 + ch;
  const int valid = DI - c0 < kCh ? DI - c0 : kCh;
  const bool live = ch < valid;
  const int chunks = (S + L - 1) / L;

  float a[4] = {0.f, 0.f, 0.f, 0.f}, dskip = 0.f;
  if (live) {
#pragma unroll
    for (int n = 0; n < 4; ++n) a[n] = -expf(a_log[(int64_t)d * N + 4 * lane + n]);
    dskip = d_skip[d];
  }
  float g[4] = {0.f, 0.f, 0.f, 0.f}, da_sum[4] = {0.f, 0.f, 0.f, 0.f}, dd_sum = 0.f;

  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * L, cnt = S - t0 < L ? S - t0 : L;
    __syncthreads();   // the previous chunk's staged rows and outputs are read
    for (int i = tid; i < L * kCh; i += kThreads) {
      const int t = i / kCh, j = i % kCh;
      const bool ok = t < cnt && j < valid;
      const int64_t tok = (int64_t)row * S + t0 + t;
      sd[i] = ok ? delta[tok * DI + c0 + j] : 0.f;
      sx[i] = ok ? x[row * xb + (int64_t)(t0 + t) * xt + c0 + j] : repro::from_float<T>(0.f);
      sz[i] = ok ? z[row * zb + (int64_t)(t0 + t) * zt + c0 + j] : repro::from_float<T>(0.f);
      sdo[i] = ok ? dout[tok * DI + c0 + j] : repro::from_float<T>(0.f);
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const bool ok = t < cnt;
      sb[i] = ok ? bm[row * bb + (int64_t)(t0 + t) * bt + n] : repro::from_float<T>(0.f);
      sc[i] = ok ? cm[row * cb + (int64_t)(t0 + t) * ct + n] : repro::from_float<T>(0.f);
    }
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float* cp = c == 0 ? h0 + ((int64_t)row * DI + d) * N
                               : ckpt + (((int64_t)row * (chunks - 1) + c - 1) * DI + d) * N;
#pragma unroll
      for (int n = 0; n < 4; ++n) h[n] = cp[4 * lane + n];
    }
    __syncthreads();
    // the chunk's states h_{t-1}, as the forward rounds them
    for (int t = 0; t < cnt; ++t) {
      hs[t * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
      const float dt = sd[t * kCh + ch], xv = repro::to_float(sx[t * kCh + ch]);
      float bn[4];
      load4(&sb[t * N + 4 * lane], bn);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float da = expf(__fmul_rn(dt, a[n]));
        h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(__fmul_rn(dt, bn[n]), xv));
      }
    }
    for (int t = cnt - 1; t >= 0; --t) {
      const float4 hv = hs[t * kThreads + tid];
      const float hp[4] = {hv.x, hv.y, hv.z, hv.w};
      const float dt = sd[t * kCh + ch];
      const float xv = repro::to_float(sx[t * kCh + ch]);
      const float zv = repro::to_float(sz[t * kCh + ch]);
      const float dov = repro::to_float(sdo[t * kCh + ch]);
      float bn[4], cn[4], da[4], ht[4];
      load4(&sb[t * N + 4 * lane], bn);
      load4(&sc[t * N + 4 * lane], cn);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        da[n] = expf(__fmul_rn(dt, a[n]));
        ht[n] = __fadd_rn(__fmul_rn(da[n], hp[n]), __fmul_rn(__fmul_rn(dt, bn[n]), xv));
        acc = fmaf(ht[n], cn[n], acc);
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const float y = acc + dskip * xv;
      const float sig = 1.f / (1.f + expf(-zv));
      const float dy = dov * zv * sig;
      float pb[4], pc[4], ddl = 0.f, dxs = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        pc[n] = dy * ht[n];
        g[n] = fmaf(dy, cn[n], g[n]);           // G_t
        pb[n] = g[n] * dt * xv;
        ddl = fmaf(g[n], fmaf(bn[n], xv, hp[n] * da[n] * a[n]), ddl);
        dxs = fmaf(g[n], bn[n], dxs);
        da_sum[n] = fmaf(g[n] * hp[n], da[n] * dt, da_sum[n]);
        g[n] *= da[n];                          // its share of G_{t-1}
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) {
        ddl += __shfl_xor_sync(0xffffffffu, ddl, o);
        dxs += __shfl_xor_sync(0xffffffffu, dxs, o);
      }
      // over the warp's channels: the lane bits above a channel's lanes
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          pb[n] += __shfl_xor_sync(0xffffffffu, pb[n], o);
          pc[n] += __shfl_xor_sync(0xffffffffu, pc[n], o);
        }
      if (wl < kLanes) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wp[(t * kWarps + warp) * N + 4 * lane + n] = pb[n];
          wp[((L + t) * kWarps + warp) * N + 4 * lane + n] = pc[n];
        }
      }
      if (lane == 0) {
        dd_sum = fmaf(dy, xv, dd_sum);
        od[t * kCh + ch] = ddl;
        od[(L + t) * kCh + ch] = fmaf(dy, dskip, dxs * dt);
        od[(2 * L + t) * kCh + ch] = dov * y * sig * (1.f + zv * (1.f - sig));
      }
    }
    __syncthreads();
    for (int i = tid; i < cnt * kCh; i += kThreads) {
      const int t = i / kCh, j = i % kCh;
      if (j >= valid) continue;
      const int64_t o = ((int64_t)row * S + t0 + t) * DI + c0 + j;
      ddelta[o] = od[i];
      dx[o] = repro::from_float<T>(od[L * kCh + i]);
      dz[o] = repro::from_float<T>(od[2 * L * kCh + i]);
    }
    for (int i = tid; i < cnt * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const float* pb = wp + t * kWarps * N + n;
      const float* pc = wp + (L + t) * kWarps * N + n;
      float vb = pb[0], vc = pc[0];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) vb += pb[q * N], vc += pc[q * N];
      const int64_t o = (((int64_t)row * gridDim.x + blockIdx.x) * S + t0 + t) * N + n;
      part_b[o] = vb;
      part_c[o] = vc;
    }
  }
  if (live) {   // the row's da_log and dD partials; dh0 = da_0 G_0, which g holds now
    const int64_t o = ((int64_t)row * DI + d) * N + 4 * lane;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      part_a[o + n] = da_sum[n] * a[n];
      dh0[o + n] = g[n];
    }
    if (lane == 0) part_d[(int64_t)row * DI + d] = dd_sum;
  }
}

__global__ void __launch_bounds__(256)
selective_scan_bwd_sum_kernel(repro::SumJob j0, repro::SumJob j1, repro::SumJob j2,
                              repro::SumJob j3) {
  repro::sum_partials(blockIdx.y == 0 ? j0 : blockIdx.y == 1 ? j1 : blockIdx.y == 2 ? j2 : j3);
}

template <typename T, int N>
int launch(const void* delta, const void* x, int64_t xb, int64_t xt, const void* z,
           int64_t zb, int64_t zt, const void* bm, int64_t bb, int64_t bt, const void* cm,
           int64_t cb, int64_t ct, const void* a_log, const void* d_skip, const void* h0,
           const void* dout, const void* ckpt, void* ddelta, void* dx, void* dz, void* db,
           void* dc, void* da_log, void* dd, void* dh0, void* part_b, void* part_c,
           void* part_a, void* part_d, int B, int S, int DI, cudaStream_t stream) {
  using Shape = ScanShape<T, N>;
  static bool configured[repro::kMaxDevices] = {};
  if (int rc = repro::opt_in_smem(selective_scan_bwd_kernel<T, N>, configured)) return rc;
  const unsigned blocks = (unsigned)((DI + Shape::kCh - 1) / Shape::kCh);
  selective_scan_bwd_kernel<T, N><<<dim3(blocks, (unsigned)B), kThreads,
                                    BwdSmem<T, N>::kBytes, stream>>>(
      (const float*)delta, (const T*)x, xb, xt, (const T*)z, zb, zt, (const T*)bm, bb, bt,
      (const T*)cm, cb, ct, (const float*)a_log, (const float*)d_skip, (const float*)h0,
      (const T*)dout, (const float*)ckpt, (float*)ddelta, (T*)dx, (T*)dz, (float*)part_b,
      (float*)part_c, (float*)part_a, (float*)part_d, (float*)dh0, S, DI);
  if (int rc = (int)cudaGetLastError()) return rc;
  const int bf = sizeof(T) == 2;
  const repro::SumJob jb{(const float*)part_b, db, B, (int64_t)S * N, (int)blocks, bf};
  const repro::SumJob jc{(const float*)part_c, dc, B, (int64_t)S * N, (int)blocks, bf};
  const repro::SumJob ja{(const float*)part_a, da_log, 1, (int64_t)DI * N, B, 0};
  const repro::SumJob jd{(const float*)part_d, dd, 1, DI, B, 0};
  const int64_t most = (int64_t)B * S * N > (int64_t)DI * N ? (int64_t)B * S * N : (int64_t)DI * N;
  selective_scan_bwd_sum_kernel<<<dim3(repro::sum_blocks(most), 4), 256, 0, stream>>>(
      jb, jc, ja, jd);
  return (int)cudaGetLastError();
}

}  // namespace

// As repro_selective_scan (strides in elements), with h0 [B, DI, N] the
// state the forward started from, dout [B, S, DI] in T (contiguous) and
// ckpt as the forward wrote it (null when S fits one chunk).  Out: ddelta
// [B, S, DI] float32, dx and dz [B, S, DI] and db and dc [B, S, N] in T,
// da_log [DI, N], dd [DI] and dh0 (the gradient of h0) [B, DI, N] float32.
// Caller's float32 buffers: part_b and part_c [B, DI / kCh blocks, S, N],
// part_a [B, DI, N] and part_d [B, DI] (the rows' da_log and dD partials).
extern "C" int repro_selective_scan_bwd(
    const void* delta, const void* x, int64_t xb, int64_t xt, const void* z, int64_t zb,
    int64_t zt, const void* bm, int64_t bb, int64_t bt, const void* cm, int64_t cb,
    int64_t ct, const void* a_log, const void* d_skip, const void* h0, const void* dout,
    const void* ckpt, void* ddelta, void* dx, void* dz, void* db, void* dc, void* da_log,
    void* dd, void* dh0, void* part_b, void* part_c, void* part_a, void* part_d, int B,
    int S, int DI, int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || DI <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
#define REPRO_SCAN_BWD(NN)                                                                  \
  REPRO_DISPATCH(dtype, T,                                                                  \
                 if ((S - 1) / ScanShape<T, NN>::kSteps > 0 && ckpt == nullptr) return      \
                     (int)cudaErrorInvalidValue;                                            \
                 return launch<T, NN>(delta, x, xb, xt, z, zb, zt, bm, bb, bt, cm, cb, ct,  \
                                      a_log, d_skip, h0, dout, ckpt, ddelta, dx, dz, db,    \
                                      dc, da_log, dd, dh0, part_b, part_c, part_a, part_d, \
                                      B, S, DI, st))
  switch (N) {
    case 8: REPRO_SCAN_BWD(8);
    case 16: REPRO_SCAN_BWD(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SCAN_BWD
}
