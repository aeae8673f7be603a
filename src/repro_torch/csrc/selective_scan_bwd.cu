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
// Bound: bytes (delta, x, z, dout, B and C read once, their gradients
// written once, the checkpoints read).  The work, about 25 operations
// per (step, channel, state) element with one accurate expf, is of the
// same order at jamba's widths, so the design spends as few instructions
// an element as it can:
//
// - The forward's layout: a block of 128 threads holds kCh channels of
//   one row, N / 4 lanes a channel, each lane 4 states (and G, and the
//   sums for da_log) in registers.  The forward writes the state before
//   each of its staged chunks (ckpt); the backward walks the chunks in
//   reverse, the next chunk's delta, x, z, dout, B and C staged by
//   cp.async while this one runs.
// - One expf an element.  A forward pass over the chunk computes each
//   da_t (the forward's arithmetic and rounding) and keeps it in shared
//   memory, with the state at every 8th step; the backward pass then
//   recomputes each window of 8 states from its start with the kept da_t
//   (two products and a sum an element, no expf: the states are the
//   forward's bit for bit) into registers and walks the window back.  Only
//   a window's 8 steps are unrolled (the code of a whole chunk's would
//   outgrow the instruction cache).  silu(z) and dy are computed once a
//   (step, channel).
// - No sum a step through shared memory and no barrier a step.  The sums
//   over a channel's lanes (y for dz, ddelta, dx) are a reduce-scatter of
//   three values (3 shuffles at N = 16); the sums of dB and dC over the
//   warp's channels a reduce-scatter of the lane's 8 values (7 shuffles;
//   the earlier kernel took 24); each warp leaves its values for the step
//   in its own part of the step's da_t, which it has read, after the next
//   step's loads (a shared-memory store before them would hold them back:
//   the compiler cannot tell the two apart).  Once a
//   chunk the block adds the warps' rows of dB and dC in warp order (a
//   tile sum), then the 4 blocks of a thread block cluster add their
//   tiles in rank order through distributed shared memory: the partials
//   in device memory are one per 4 blocks (B x DI / (4 kCh) x S x N each
//   for dB and dC), which a second kernel (selective_scan_bwd_sum_kernel)
//   adds in order, with the rows' partials of da_log and dD.
// - No atomics: repeated calls are bit-identical.  Sums in float32; dx,
//   dz, dB and dC stored in T.
#include <cooperative_groups.h>

#include "selective_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = repro::kScanThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kClu = 4;      // channel blocks a cluster
constexpr int kWin = 8;      // steps a window of recomputed states
using repro::ScanShape;
using repro::load4;

// The copy widths, in bytes, of delta, x, z, dout, B and C (copy_granule)
struct Granules {
  int d, x, z, o, b, c;
};

// Shared memory, in bytes: two staged chunks (delta [L][kCh] float32, x,
// z, dout [L][kCh] and B, C [L][N] in T); the chunk's da_t [L][kThreads]
// float4, each warp's 512 bytes of a step reused, once read, for its
// values of the step (dB and dC over its channels [2N], then y, ddelta
// and dx over its lanes [3][its channels]); silu(z) and dy [L][kCh]
// float32; two dB/dC tiles [L][2N] float32 for the cluster; the state at
// each window's start [L / kWin][kThreads] float4.
template <typename T, int N> struct BwdSmem {
  using S_ = ScanShape<T, N>;
  static constexpr int L = S_::kSteps, C = S_::kCh, es = (int)sizeof(T);
  static constexpr int kDelta = 0;
  static constexpr int kX = kDelta + L * C * 4;
  static constexpr int kZ = kX + L * C * es;
  static constexpr int kDo = kZ + L * C * es;
  static constexpr int kB = kDo + L * C * es;
  static constexpr int kC = kB + L * N * es;
  static constexpr int kStage = (kC + L * N * es + 15) / 16 * 16;
  static constexpr int kDa = 2 * kStage;
  static constexpr int kSig = kDa + L * kThreads * 16;
  static constexpr int kDy = kSig + L * C * 4;
  static constexpr int kTile = kDy + L * C * 4;
  static constexpr int kHb = kTile + 2 * L * 2 * N * 4;
  static constexpr int kBytes = kHb + L / kWin * kThreads * 16;
  static_assert(L % kWin == 0 && L % kClu == 0, "whole windows; a cluster's share of steps");
  static_assert(2 * N + 3 * C / kWarps <= 128, "a warp's values fit its part of a step");
};

// Stage chunk c into `buf`: one cp.async group over the block
template <typename T, int N>
__device__ __forceinline__ void stage_chunk(uint8_t* buf, const float* delta, const T* x,
                                            int64_t xb, int64_t xt, const T* z, int64_t zb,
                                            int64_t zt, const T* bm, int64_t bb, int64_t bt,
                                            const T* cm, int64_t cb, int64_t ct, const T* dout,
                                            int row, int c0, int valid, int S, int DI, int c,
                                            const Granules& gran) {
  using M = BwdSmem<T, N>;
  constexpr int L = M::L, C = M::C, es = M::es;
  const int t0 = c * L, cnt = S - t0 < L ? S - t0 : L, tid = threadIdx.x;
  const int64_t tok = (int64_t)row * S + t0;
  repro::stage_rows(buf + M::kDelta, C * 4, delta + tok * DI + c0, (int64_t)DI * 4, cnt,
                    valid * 4, gran.d, tid, kThreads);
  repro::stage_rows(buf + M::kX, C * es, x + row * xb + t0 * xt + c0, xt * es, cnt, valid * es,
                    gran.x, tid, kThreads);
  repro::stage_rows(buf + M::kZ, C * es, z + row * zb + t0 * zt + c0, zt * es, cnt, valid * es,
                    gran.z, tid, kThreads);
  repro::stage_rows(buf + M::kDo, C * es, dout + tok * DI + c0, (int64_t)DI * es, cnt,
                    valid * es, gran.o, tid, kThreads);
  repro::stage_rows(buf + M::kB, N * es, bm + row * bb + t0 * bt, bt * es, cnt, N * es, gran.b,
                    tid, kThreads);
  repro::stage_rows(buf + M::kC, N * es, cm + row * cb + t0 * ct, ct * es, cnt, N * es, gran.c,
                    tid, kThreads);
  repro::cp_async_commit();
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(const float* __restrict__ delta, const T* __restrict__ x,
                          int64_t xb, int64_t xt, const T* __restrict__ z, int64_t zb,
                          int64_t zt, const T* __restrict__ bm, int64_t bb, int64_t bt,
                          const T* __restrict__ cm, int64_t cb, int64_t ct,
                          const float* __restrict__ a_log, const float* __restrict__ d_skip,
                          const float* __restrict__ h0, const T* __restrict__ dout,
                          const float* __restrict__ ckpt, float* __restrict__ ddelta,
                          T* __restrict__ dx, T* __restrict__ dz, float* __restrict__ part_b,
                          float* __restrict__ part_c, float* __restrict__ part_a,
                          float* __restrict__ part_d, float* __restrict__ dh0, int S, int DI,
                          Granules gran) {
  using Shape = ScanShape<T, N>;
  using M = BwdSmem<T, N>;
  constexpr int kLanes = Shape::kLanes, kCh = Shape::kCh, L = Shape::kSteps;
  constexpr int kCpw = 32 / kLanes;          // channels a warp
  constexpr int kW = L / kWin;               // windows a chunk
  extern __shared__ __align__(16) uint8_t smem[];
  float4* sda = (float4*)(smem + M::kDa);    // [L][kThreads]
  float* ssg = (float*)(smem + M::kSig);     // [L][kCh]
  float* sdy = (float*)(smem + M::kDy);      // [L][kCh]
  float* tiles = (float*)(smem + M::kTile);  // [2][L][2N]
  float4* shb = (float4*)(smem + M::kHb);    // [L / kWin][kThreads]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.y, c0 = blockIdx.x * kCh, ncl = gridDim.x / kClu;
  const int tid = threadIdx.x, ch = tid / kLanes, lane = tid % kLanes;
  const int warp = tid / 32, wl = tid % 32;
  const int d = c0 + ch;
  const int valid = DI - c0 < kCh ? (DI - c0 > 0 ? DI - c0 : 0) : kCh;
  const bool live = ch < valid;
  const int chunks = (S + L - 1) / L;
  // where a lane's values of a step go in its warp's part (see BwdSmem):
  // its dB or dC value (value m of the reduce-scatter over the channel
  // bits), its lanes' sums (y, ddelta, dx: kind l at kLanes 4; kinds 2l and
  // 2l + 1 at kLanes 2)
  const bool c4 = wl & 16, c3 = wl & 8, c2 = wl & 4;
  const int vm = (c4 ? 4 : 0) + (c3 ? 2 : 0) + (c2 ? 1 : 0);
  const int v_at = vm / 4 * N + 4 * lane + vm % 4, cw = wl / kLanes;
  const bool v_writer = kLanes == 4 || (wl & 2) == 0;
  const int p0_at = kLanes == 4 ? (lane < 3 ? 2 * N + lane * kCpw + cw : -1)
                                : 2 * N + 2 * lane * kCpw + cw;

  // the channels past DI and the steps past S stay zero in both buffers:
  // cp.async never writes them (delta = 0 makes da = 1 and adds nothing)
  for (int i = tid; i < 2 * M::kStage / 16; i += kThreads)
    ((uint4*)smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  float a[4] = {0.f, 0.f, 0.f, 0.f}, dskip = 0.f;
  if (live) {
#pragma unroll
    for (int n = 0; n < 4; ++n) a[n] = -expf(a_log[(int64_t)d * N + 4 * lane + n]);
    dskip = d_skip[d];
  }
  auto start_state = [&](int c, float (&h)[4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) h[n] = 0.f;
    if (live) {
      const float* cp = c == 0 ? h0 + ((int64_t)row * DI + d) * N
                               : ckpt + (((int64_t)row * (chunks - 1) + c - 1) * DI + d) * N;
#pragma unroll
      for (int n = 0; n < 4; ++n) h[n] = cp[4 * lane + n];
    }
  };
  float g[4] = {0.f, 0.f, 0.f, 0.f}, da_sum[4] = {0.f, 0.f, 0.f, 0.f}, dd_sum = 0.f;
  float hnext[4];
  start_state(chunks - 1, hnext);
  stage_chunk<T, N>(smem + (chunks - 1) % 2 * M::kStage, delta, x, xb, xt, z, zb, zt, bm, bb,
                    bt, cm, cb, ct, dout, row, c0, valid, S, DI, chunks - 1, gran);

  for (int c = chunks - 1; c >= 0; --c) {
    const uint8_t* buf = smem + c % 2 * M::kStage;
    const float* sd = (const float*)(buf + M::kDelta);   // [L][kCh]
    const T* sx = (const T*)(buf + M::kX);
    const T* sz = (const T*)(buf + M::kZ);
    const T* sdo = (const T*)(buf + M::kDo);
    const T* sb = (const T*)(buf + M::kB);                // [L][N]
    const T* sc = (const T*)(buf + M::kC);
    float* tile = tiles + c % 2 * L * 2 * N;
    const int t0 = c * L, cnt = S - t0 < L ? S - t0 : L;
    float h[4] = {hnext[0], hnext[1], hnext[2], hnext[3]};
    repro::cp_async_wait<0>();
    __syncthreads();   // chunk c staged; chunk c + 1's values read
    if (c > 0) {
      start_state(c - 1, hnext);
      stage_chunk<T, N>(smem + (c - 1) % 2 * M::kStage, delta, x, xb, xt, z, zb, zt, bm, bb,
                        bt, cm, cb, ct, dout, row, c0, valid, S, DI, c - 1, gran);
    }
    // silu(z) and dy, once a (step, channel)
    for (int i = tid; i < L * kCh; i += kThreads) {
      const float zv = repro::to_float(sz[i]);
      const float sig = 1.f / (1.f + expf(-zv));
      ssg[i] = sig;
      sdy[i] = repro::to_float(sdo[i]) * zv * sig;
    }
    // forward over the chunk: da_t kept, the state at each window's start
#pragma unroll 1
    for (int wi = 0; wi < kW; ++wi) {
      shb[wi * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
      for (int s = 0; s < kWin; ++s) {
        const int t = wi * kWin + s;
        const float dt = sd[t * kCh + ch], xv = repro::to_float(sx[t * kCh + ch]);
        float bn[4], da[4];
        load4(&sb[t * N + 4 * lane], bn);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          da[n] = expf(__fmul_rn(dt, a[n]));
          h[n] = __fadd_rn(__fmul_rn(da[n], h[n]), __fmul_rn(__fmul_rn(dt, bn[n]), xv));
        }
        sda[t * kThreads + tid] = make_float4(da[0], da[1], da[2], da[3]);
      }
    }
    __syncthreads();   // silu(z) and dy
    // backward, a window at a time: its states recomputed from its start
#pragma unroll 1
    for (int wi = kW - 1; wi >= 0; --wi) {
      float hw[kWin + 1][4];
      {
        const float4 hv = shb[wi * kThreads + tid];
        hw[0][0] = hv.x, hw[0][1] = hv.y, hw[0][2] = hv.z, hw[0][3] = hv.w;
      }
#pragma unroll
      for (int s = 0; s < kWin; ++s) {
        const int t = wi * kWin + s;
        const float dt = sd[t * kCh + ch], xv = repro::to_float(sx[t * kCh + ch]);
        const float4 dv = sda[t * kThreads + tid];
        const float da[4] = {dv.x, dv.y, dv.z, dv.w};
        float bn[4];
        load4(&sb[t * N + 4 * lane], bn);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          hw[s + 1][n] =
              __fadd_rn(__fmul_rn(da[n], hw[s][n]), __fmul_rn(__fmul_rn(dt, bn[n]), xv));
      }
      // a step's values go to the warp's part of the step after the next
      // step's loads (a store ahead of them would hold them back)
      float out_v = 0.f, out_p0 = 0.f, out_p1 = 0.f;
      auto store = [&](int t) {
        __syncwarp();   // every lane has read its da_t
        float* wv = (float*)(sda + t * kThreads + warp * 32);
        if (v_writer) wv[v_at] = out_v;
        if (p0_at >= 0) wv[p0_at] = out_p0;
        if (kLanes == 2 && lane == 0) wv[2 * N + kCpw + cw] = out_p1;
      };
#pragma unroll
      for (int s = kWin - 1; s >= 0; --s) {
        const int t = wi * kWin + s;
        const float dt = sd[t * kCh + ch], xv = repro::to_float(sx[t * kCh + ch]);
        const float dy = sdy[t * kCh + ch];
        const float4 dv = sda[t * kThreads + tid];
        const float da[4] = {dv.x, dv.y, dv.z, dv.w};
        float bn[4], cn[4], v[8];
        load4(&sb[t * N + 4 * lane], bn);
        load4(&sc[t * N + 4 * lane], cn);
        if (s < kWin - 1) store(t + 1);
        const float dtx = dt * xv;
        float acc = 0.f, dxs = 0.f, qa = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float hp = hw[s][n], ht = hw[s + 1][n];
          acc = fmaf(ht, cn[n], acc);
          v[4 + n] = dy * ht;                      // dC's share
          g[n] = fmaf(dy, cn[n], g[n]);            // G_t
          v[n] = g[n] * dtx;                       // dB's share
          dxs = fmaf(g[n], bn[n], dxs);
          const float q = g[n] * hp * da[n];
          qa = fmaf(q, a[n], qa);
          da_sum[n] = fmaf(q, dt, da_sum[n]);
          g[n] *= da[n];                           // its share of G_{t-1}
        }
        // ddelta's share: sum_n G (B x + h da a) = x sum_n G B + sum_n G h da a
        const float ddl = fmaf(xv, dxs, qa);
        if (lane == 0) dd_sum = fmaf(dy, xv, dd_sum);
        // y, ddelta and dx over the channel's lanes: a reduce-scatter, lane
        // l ending with value l (kLanes 4) or values 2l, 2l + 1 (kLanes 2)
        float p[4] = {acc, ddl, dxs, 0.f};
        const bool l1 = lane & (kLanes / 2);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float send = l1 ? p[m] : p[m + 2], keep = l1 ? p[m + 2] : p[m];
          p[m] = keep + __shfl_xor_sync(0xffffffffu, send, kLanes / 2);
        }
        if constexpr (kLanes == 4) {
          const bool l0 = lane & 1;
          p[0] = (l0 ? p[1] : p[0]) + __shfl_xor_sync(0xffffffffu, l0 ? p[0] : p[1], 1);
        }
        // dB and dC over the warp's channels (lane bits 4, 3, 2; at kLanes
        // 2 also bit 1): value m = 4 b4 + 2 b3 + b2 of v
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float send = c4 ? v[m] : v[m + 4], keep = c4 ? v[m + 4] : v[m];
          v[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float send = c3 ? v[m] : v[m + 2], keep = c3 ? v[m + 2] : v[m];
          v[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        v[0] = (c2 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, c2 ? v[0] : v[1], 4);
        if constexpr (kLanes == 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
        out_v = v[0], out_p0 = p[0], out_p1 = p[1];
      }
      store(wi * kWin);
    }
    __syncthreads();   // every warp's values of the chunk
    {  // ddelta, dx and dz: a (step, channel) a thread, stores coalesced
      const int64_t o0 = ((int64_t)row * S + t0) * DI + c0;
      for (int i = tid; i < cnt * kCh; i += kThreads) {
        const int t = i / kCh, j = i % kCh;
        if (j >= valid) continue;
        const float* wv = (const float*)(sda + t * kThreads + j / kCpw * 32);
        const int cw = j % kCpw;
        const float acc = wv[2 * N + cw], ddl = wv[2 * N + kCpw + cw],
                    dxs = wv[2 * N + 2 * kCpw + cw];
        const float xv = repro::to_float(sx[i]), zv = repro::to_float(sz[i]);
        const float dov = repro::to_float(sdo[i]), sig = ssg[i], dt = sd[i];
        const float y = acc + d_skip[c0 + j] * xv;
        const int64_t o = o0 + (int64_t)t * DI + j;
        ddelta[o] = ddl;
        dx[o] = repro::from_float<T>(fmaf(sdy[i], d_skip[c0 + j], dxs * dt));
        dz[o] = repro::from_float<T>(dov * y * sig * (1.f + zv * (1.f - sig)));
      }
    }
    // the block's dB and dC: the warps' rows added in order
    for (int i = tid; i < cnt * 2 * N; i += kThreads) {
      const int t = i / (2 * N), e = i % (2 * N);
      const float* wv = (const float*)(sda + t * kThreads) + e;
      float sum = wv[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += wv[w * 128];
      tile[i] = sum;
    }
    cluster.sync();
    {  // this block's share of the steps: the cluster's tiles in rank order
      constexpr int kShare = L / kClu;
      const int64_t ob = (((int64_t)row * ncl + blockIdx.x / kClu) * S + t0) * N;
      for (int i = tid; i < kShare * 2 * N; i += kThreads) {
        const int t = rank * kShare + i / (2 * N), e = i % (2 * N);
        if (t >= cnt) continue;
        float sum = cluster.map_shared_rank(tile, 0)[t * 2 * N + e];
#pragma unroll
        for (int m = 1; m < kClu; ++m) sum += cluster.map_shared_rank(tile, m)[t * 2 * N + e];
        (e < N ? part_b : part_c)[ob + (int64_t)t * N + e % N] = sum;
      }
    }
  }
  cluster.sync();   // no block leaves while the cluster reads its tiles
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
  using M = BwdSmem<T, N>;
  constexpr int es = sizeof(T);
  static bool configured[repro::kMaxDevices] = {};
  if (int rc = repro::opt_in_smem(selective_scan_bwd_kernel<T, N>, configured)) return rc;
  const Granules gran{repro::copy_granule(delta, 4, (int64_t)S * DI, DI, DI),
                  repro::copy_granule(x, es, xb, xt, DI),
                  repro::copy_granule(z, es, zb, zt, DI),
                  repro::copy_granule(dout, es, (int64_t)S * DI, DI, DI),
                  repro::copy_granule(bm, es, bb, bt, N),
                  repro::copy_granule(cm, es, cb, ct, N)};
  const int ncl = (DI + kClu * Shape::kCh - 1) / (kClu * Shape::kCh);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ncl * kClu), (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = M::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClu;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, selective_scan_bwd_kernel<T, N>, (const float*)delta, (const T*)x, xb, xt,
      (const T*)z, zb, zt, (const T*)bm, bb, bt, (const T*)cm, cb, ct, (const float*)a_log,
      (const float*)d_skip, (const float*)h0, (const T*)dout, (const float*)ckpt,
      (float*)ddelta, (T*)dx, (T*)dz, (float*)part_b, (float*)part_c, (float*)part_a,
      (float*)part_d, (float*)dh0, S, DI, gran);
  if (e != cudaSuccess) return (int)e;
  if (int rc = (int)cudaGetLastError()) return rc;
  const int bf = sizeof(T) == 2;
  const repro::SumJob jb{(const float*)part_b, db, B, (int64_t)S * N, ncl, bf};
  const repro::SumJob jc{(const float*)part_c, dc, B, (int64_t)S * N, ncl, bf};
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
// Caller's float32 buffers: part_b and part_c [B, ceil(DI / (4 kCh)), S,
// N] (the clusters' dB and dC), part_a [B, DI, N] and part_d [B, DI] (the
// rows' da_log and dD partials).
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
