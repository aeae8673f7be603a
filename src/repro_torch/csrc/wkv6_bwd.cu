// wkv6_bwd: the backward of RWKV-6's time-mix recurrence (csrc/wkv6.cu),
// per (row, head).  Forward, per token t, with the state S [DH, DH]:
//
//   y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//   S_t    = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]
//
// Backward, with G_t the gradient of S_t (ds, the final state's gradient,
// after the last token; zero when null), vd_t = v_t . dy_t, walking the
// tokens backwards:
//
//   dr_t[i] = sum_j S_{t-1}[i, j] dy_t[j] + u[i] k_t[i] vd_t
//   dk_t[i] = sum_j G_t[i, j] v_t[j]      + u[i] r_t[i] vd_t
//   dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//   dv_t[j] = sum_i k_t[i] (G_t[i, j] + r_t[i] u[i] dy_t[j])
//   du[i]  += r_t[i] k_t[i] vd_t
//   G_{t-1} = w_t[i] G_t[i, j] + r_t[i] dy_t[j]      (ds0 = G_{-1})
//
// Replaces no Pallas kernel: the JAX package differentiates its lax.scan
// (src/repro/models/rwkv6.py:87, _wkv_scan), checkpointed per 128-token
// chunk; kernels/wkv6/ref.py:wkv6_bwd_ref is this algorithm in PyTorch.
//
// S_{t-1} is never recovered from S_t by dividing by w_t (a decay of 1e-30
// would lose it).  The forward writes the state before each chunk of kL =
// 16 tokens (ckpt); the backward walks the chunks in reverse and
// recomputes a chunk's states from its checkpoint.
//
// Bound: bytes.  The backward reads r, k, v, w, dy and the checkpoints and
// writes dr, dk, dv and dw once; its ~12 DH^2 operations a token and head
// (the state recomputed, G carried, four contractions) take about 0.1 ms
// of the float32 rate at RWKV-6's training shape, under the bytes' 0.13.
// What the design does about it:
//
// - Row slices.  Every row i of S and G evolves on its own (w_t[i] scales
//   a row), and dr, dk, dw and du are sums within a row: a block owns
//   kRows = 16 rows of one (row, head), DH / 16 blocks a head (512 at
//   RWKV-6's 4 x 32 heads of 64), and only dv, a sum over i, crosses the
//   blocks.  The DH / 16 blocks of a head form a thread block cluster and
//   add their dv partials through distributed shared memory in rank
//   order, once a chunk: no atomics, no second pass over dv.
// - Thread (row, 8 columns), 2 DH threads, a warp 16 rows x 2 column
//   groups.  G stays in registers for the whole sequence.  A chunk's
//   states stay in registers too, half a chunk at a time: the later 8
//   tokens' states are recomputed from the checkpoint (8 tokens advanced,
//   8 kept), walked backwards, then the earlier 8 tokens' from the
//   checkpoint again (1.5 recomputes a token; no state in device memory
//   or L2, 64 registers).
// - No barrier a token.  The sums over a thread's 8 columns run in
//   registers; dr, dk and dw add the warp's two column groups by one
//   shuffle each and leave the warps' partials in shared memory; dv's sum
//   over the slice's 16 rows is a reduce-scatter among the warp's lanes (8
//   shuffles for 8 columns), written to the slice's dv tile.  A token's
//   results are stored after the next token's loads (a shared-memory store
//   before them would hold them back).  Only a half chunk's 8 tokens are
//   unrolled.
// - A chunk costs one cluster barrier (the tiles and partials complete,
//   the next chunk staged) and one block barrier (the chunk's rows read,
//   before their buffer is refilled).  Between the two the block adds the
//   warps' partials in warp order (with u's terms and du's share), the
//   cluster's dv tiles in rank order, 4 rows or columns a thread, and
//   computes the next chunk's v . dy; the chunk after next is staged by
//   cp.async while the next one runs.
// - du goes out as per-row partials [B, H, DH], which a second kernel
//   (wkv6_bwd_sum_kernel) adds in row order.  Every sum runs in a fixed
//   order: repeated calls are bit-identical.  Float32 on the CUDA cores
//   throughout (TF32 would not hold the 1e-5 the reference needs).
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kL = 16;      // tokens per chunk: the forward's checkpoint interval
constexpr int kHalf = kL / 2;
constexpr int kRows = 16;   // rows of S a block owns
constexpr int kCW = 8;      // columns a thread owns

template <int DH> struct BwdShape {
  static constexpr int kGroups = DH / kCW;           // column groups
  static constexpr int kThreads = kRows * kGroups;   // 2 DH
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSlices = DH / kRows;         // blocks a head: the cluster
  // a staged chunk, in floats: r, k, w [kL][kRows] (the slice's rows);
  // v, dy [kL][DH]; the chunk's start state, the slice's rows [kRows][DH]
  static constexpr int kR = 0, kK = kL * kRows, kW = 2 * kL * kRows, kV = 3 * kL * kRows,
                       kDy = kV + kL * DH, kS0 = kDy + kL * DH, kStage = kS0 + kRows * DH;
  // after two staged chunks: u [kRows]; two chunks' vd [2][kL]; the warps'
  // partials of dr, dk, dw [kL][3][kWarps][kRows]; two dv tiles [kL][DH]
  static constexpr int kU = 2 * kStage, kVd = kU + kRows, kPart = kVd + 2 * kL,
                       kDv = kPart + kL * 3 * kWarps * kRows, kFloats = kDv + 2 * kL * DH;
  static_assert(kWarps >= 1 && kStage % 4 == 0 && kPart % 4 == 0 && kDv % 4 == 0,
                "whole warps; 16-byte aligned buffers");
};

__device__ __forceinline__ void load8(const float* p, float (&o)[kCW]) {
  const float4 a = *(const float4*)p, b = *(const float4*)(p + 4);
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

// Stage chunk c (its `cnt` tokens) into `buf`, one cp.async group over the
// block: r, k, w of the slice's rows, v and dy whole, and the state before
// the chunk (s0 for the first, else its checkpoint), the slice's rows.
template <int DH>
__device__ __forceinline__ void stage_chunk(float* buf, const float* r, const float* k,
                                            const float* w, const float* v, const float* dy,
                                            const float* s0, const float* ckpt, int64_t tok0,
                                            int64_t step, int64_t bh, int i0, int S, int c,
                                            int gran, int tid) {
  using Sh = BwdShape<DH>;
  constexpr int NT = Sh::kThreads;
  const int chunks = (S + kL - 1) / kL, t0 = c * kL, cnt = S - t0 < kL ? S - t0 : kL;
  const int64_t off = tok0 + (int64_t)t0 * step;
  repro::stage_rows(buf + Sh::kR, kRows * 4, r + off + i0, step * 4, cnt, kRows * 4, gran, tid, NT);
  repro::stage_rows(buf + Sh::kK, kRows * 4, k + off + i0, step * 4, cnt, kRows * 4, gran, tid, NT);
  repro::stage_rows(buf + Sh::kW, kRows * 4, w + off + i0, step * 4, cnt, kRows * 4, gran, tid, NT);
  repro::stage_rows(buf + Sh::kV, DH * 4, v + off, step * 4, cnt, DH * 4, gran, tid, NT);
  repro::stage_rows(buf + Sh::kDy, DH * 4, dy + off, step * 4, cnt, DH * 4, gran, tid, NT);
  const float* sp = c == 0 ? s0 + bh * DH * DH
                           : ckpt + (bh * (chunks - 1) + c - 1) * DH * DH;
  repro::stage_rows(buf + Sh::kS0, DH * 4, sp + (int64_t)i0 * DH, DH * 4, kRows, DH * 4, gran,
                    tid, NT);
  repro::cp_async_commit();
  // the rows past the sequence: r = k = v = dy = 0 and w = 1, which leave
  // S and G as they are (only the last chunk has them, and it is staged
  // first, into a buffer no earlier chunk wrote)
  for (int e = cnt * kRows + tid; e < kL * kRows; e += NT) {
    buf[Sh::kR + e] = 0.f;
    buf[Sh::kK + e] = 0.f;
    buf[Sh::kW + e] = 1.f;
  }
  for (int e = cnt * DH + tid; e < kL * DH; e += NT) {
    buf[Sh::kV + e] = 0.f;
    buf[Sh::kDy + e] = 0.f;
  }
}

// vd_t = v_t . dy_t of a staged chunk into vd [kL]: thread (t, group) 8
// columns, then the groups by shuffles
template <int DH>
__device__ __forceinline__ void dot_vd(const float* buf, float* vd, int tid) {
  using Sh = BwdShape<DH>;
  const int t = tid / Sh::kGroups, p = tid % Sh::kGroups;
  float vv[kCW], yy[kCW], a = 0.f;
  load8(buf + Sh::kV + t * DH + p * kCW, vv);
  load8(buf + Sh::kDy + t * DH + p * kCW, yy);
#pragma unroll
  for (int e = 0; e < kCW; ++e) a = fmaf(vv[e], yy[e], a);
#pragma unroll
  for (int o = 1; o < Sh::kGroups; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  if (p == 0) vd[t] = a;
}

// S <- w_t S + k_t v_t for the thread's row and columns
template <int DH>
__device__ __forceinline__ void advance(const float* buf, int t, int row, int c0,
                                        float (&st)[kCW]) {
  using Sh = BwdShape<DH>;
  const float wi = buf[Sh::kW + t * kRows + row], ki = buf[Sh::kK + t * kRows + row];
  float vv[kCW];
  load8(buf + Sh::kV + t * DH + c0, vv);
#pragma unroll
  for (int e = 0; e < kCW; ++e) st[e] = fmaf(wi, st[e], ki * vv[e]);
}

// Block (row b, head, slice q of kRows rows), a cluster of the head's
// DH / kRows slices; thread (warp, lane): row lane % 16 of the slice,
// columns (2 warp + lane / 16) kCW ...
template <int DH>
__global__ void __launch_bounds__(2 * DH, DH <= 64 ? 4 : 2)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ ds,
                const float* __restrict__ ckpt, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ ds0, float* __restrict__ du_rows, int S, int H,
                int gran) {
  using Sh = BwdShape<DH>;
  constexpr int NT = Sh::kThreads, NW = Sh::kWarps, NS = Sh::kSlices;
  extern __shared__ __align__(16) float sm[];
  float* su = sm + Sh::kU;
  float* svd = sm + Sh::kVd;
  float* part = sm + Sh::kPart;
  float* dvt = sm + Sh::kDv;

  cg::cluster_group cluster = cg::this_cluster();
  const int q = NS > 1 ? (int)cluster.block_rank() : 0;   // the slice
  const int64_t bh = blockIdx.x / NS;                       // row * H + head
  const int b = (int)(bh / H), hd = (int)(bh - (int64_t)b * H);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = lane % kRows, grp = 2 * warp + lane / kRows, c0 = grp * kCW;
  const int i0 = q * kRows;
  const int64_t step = (int64_t)H * DH;
  const int64_t tok0 = (int64_t)b * S * step + (int64_t)hd * DH;
  const int chunks = (S + kL - 1) / kL;
  auto sync = [&]() {
    if constexpr (NS > 1) cluster.sync(); else __syncthreads();
  };

  if (tid < kRows) su[tid] = u[hd * DH + i0 + tid];
  float g[kCW];
  {
    const int64_t gi = (bh * DH + i0 + row) * DH + c0;
#pragma unroll
    for (int e = 0; e < kCW; ++e) g[e] = ds != nullptr ? ds[gi + e] : 0.f;
  }
  // du's share of the thread's post-chunk items (rows 4 (tid % 4) ..)
  float du4[4] = {0.f, 0.f, 0.f, 0.f};
  stage_chunk<DH>(sm + (chunks - 1) % 2 * Sh::kStage, r, k, w, v, dy, s0, ckpt, tok0, step,
                  bh, i0, S, chunks - 1, gran, tid);
  repro::cp_async_wait<0>();
  __syncthreads();
  dot_vd<DH>(sm + (chunks - 1) % 2 * Sh::kStage, svd + (chunks - 1) % 2 * kL, tid);
  if (chunks > 1)
    stage_chunk<DH>(sm + (chunks - 2) % 2 * Sh::kStage, r, k, w, v, dy, s0, ckpt, tok0, step,
                    bh, i0, S, chunks - 2, gran, tid);

  // a chunk: its tokens walked back; then, once the cluster's tiles are
  // complete (and chunk c - 1 staged), its outputs, c - 1's vd, and the
  // staging of c - 2 into the buffer c leaves
  for (int c = chunks - 1; c >= 0; --c) {
    const float* buf = sm + c % 2 * Sh::kStage;
    float* tile = dvt + c % 2 * kL * DH;
    const int t0 = c * kL, cnt = S - t0 < kL ? S - t0 : kL;
    const float ui = su[row];
    // one token's results, stored after the next token's loads (a store
    // ahead of them in program order would hold them back)
    float out_r = 0.f, out_k = 0.f, out_w = 0.f, out_v = 0.f;
    auto store = [&](int t) {
      if (lane < kRows) {
        float* pp = part + (t * 3 * NW + warp) * kRows + row;
        pp[0] = out_r;
        pp[NW * kRows] = out_k;
        pp[2 * NW * kRows] = out_w;
      }
      if ((row & 1) == 0)
        tile[t * DH + c0 + (row & 8 ? 4 : 0) + (row & 4 ? 2 : 0) + (row & 2 ? 1 : 0)] = out_v;
    };
#pragma unroll 1
    for (int half = 1; half >= 0; --half) {
      float st[kCW], sv[kHalf][kCW];
      load8(buf + Sh::kS0 + row * DH + c0, st);
      if (half == 1) {
#pragma unroll
        for (int t = 0; t < kHalf; ++t) advance<DH>(buf, t, row, c0, st);
      }
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
#pragma unroll
        for (int e = 0; e < kCW; ++e) sv[s][e] = st[e];
        if (s + 1 < kHalf) advance<DH>(buf, half * kHalf + s, row, c0, st);
      }
#pragma unroll
      for (int s = kHalf - 1; s >= 0; --s) {
        const int t = half * kHalf + s;
        const float ri = buf[Sh::kR + t * kRows + row], ki = buf[Sh::kK + t * kRows + row];
        const float wi = buf[Sh::kW + t * kRows + row];
        float vv[kCW], yy[kCW], d[kCW];
        load8(buf + Sh::kV + t * DH + c0, vv);
        load8(buf + Sh::kDy + t * DH + c0, yy);
        if (half == 0 || s < kHalf - 1) store(t + 1);
        const float rui = ri * ui;
        float pr = 0.f, pk = 0.f, pw = 0.f, pr2 = 0.f, pk2 = 0.f, pw2 = 0.f;
#pragma unroll
        for (int e = 0; e < kCW; e += 2) {
          pr = fmaf(sv[s][e], yy[e], pr);
          pk = fmaf(g[e], vv[e], pk);
          pw = fmaf(g[e], sv[s][e], pw);
          pr2 = fmaf(sv[s][e + 1], yy[e + 1], pr2);
          pk2 = fmaf(g[e + 1], vv[e + 1], pk2);
          pw2 = fmaf(g[e + 1], sv[s][e + 1], pw2);
        }
#pragma unroll
        for (int e = 0; e < kCW; ++e) {
          d[e] = fmaf(rui, yy[e], g[e]) * ki;
          g[e] = fmaf(wi, g[e], ri * yy[e]);      // G_{t-1}
        }
        // dr, dk, dw: the warp's two column groups
        pr += pr2, pk += pk2, pw += pw2;
        out_r = pr + __shfl_xor_sync(0xffffffffu, pr, 16);
        out_k = pk + __shfl_xor_sync(0xffffffffu, pk, 16);
        out_w = pw + __shfl_xor_sync(0xffffffffu, pw, 16);
        // dv over the slice's 16 rows: a reduce-scatter among the lanes of
        // one column group (lane bits 3..0), 8 columns to one
        const bool b3 = row & 8, b2 = row & 4, b1 = row & 2;
        float e4[4], e2[2];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float send = b3 ? d[m] : d[m + 4], keep = b3 ? d[m + 4] : d[m];
          e4[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float send = b2 ? e4[m] : e4[m + 2], keep = b2 ? e4[m + 2] : e4[m];
          e2[m] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
        const float e1 = (b1 ? e2[1] : e2[0]) +
                         __shfl_xor_sync(0xffffffffu, b1 ? e2[0] : e2[1], 2);
        out_v = e1 + __shfl_xor_sync(0xffffffffu, e1, 1);
      }
    }
    store(0);
    repro::cp_async_wait<0>();   // chunk c - 1
    sync();   // the warps' partials and every slice's dv tile are complete
    const int64_t out0 = tok0 + (int64_t)t0 * step;
    const float* vd = svd + c % 2 * kL;
    // dr, dk, dw, 4 rows an item: the warps' partials in warp order; du's
    // share with dr's
    for (int e = tid; e < 3 * kL * 4; e += NT) {
      const int kind = e / (4 * kL), t = e / 4 % kL, q4 = e % 4 * 4;
      if (t >= cnt) continue;
      const float* pp = part + (t * 3 + kind) * NW * kRows + q4;
      float4 sum = *(const float4*)pp;
#pragma unroll
      for (int m = 1; m < NW; ++m) {
        const float4 x = *(const float4*)(pp + m * kRows);
        sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
      }
      float* out = kind == 0 ? dr : kind == 1 ? dk : dw;
      if (kind < 2) {
        const float4 uu = *(const float4*)(su + q4);
        const float4 rr = *(const float4*)(buf + Sh::kR + t * kRows + q4);
        const float4 kk = *(const float4*)(buf + Sh::kK + t * kRows + q4);
        const float4 x = kind == 0 ? kk : rr;
        sum.x = fmaf(uu.x * x.x, vd[t], sum.x);
        sum.y = fmaf(uu.y * x.y, vd[t], sum.y);
        sum.z = fmaf(uu.z * x.z, vd[t], sum.z);
        sum.w = fmaf(uu.w * x.w, vd[t], sum.w);
        if (kind == 0) {
          du4[0] = fmaf(rr.x * kk.x, vd[t], du4[0]);
          du4[1] = fmaf(rr.y * kk.y, vd[t], du4[1]);
          du4[2] = fmaf(rr.z * kk.z, vd[t], du4[2]);
          du4[3] = fmaf(rr.w * kk.w, vd[t], du4[3]);
        }
      }
      *(float4*)(out + out0 + (int64_t)t * step + i0 + q4) = sum;
    }
    // dv: this block's kRows columns, 4 an item, the slices' tiles added in
    // rank order
    for (int e = tid; e < cnt * 4; e += NT) {
      const int t = e / 4, x = i0 + e % 4 * 4;
      float4 sum;
      if constexpr (NS > 1) {
        sum = *(const float4*)(cluster.map_shared_rank(tile, 0) + t * DH + x);
#pragma unroll
        for (int m = 1; m < NS; ++m) {
          const float4 y = *(const float4*)(cluster.map_shared_rank(tile, m) + t * DH + x);
          sum.x += y.x, sum.y += y.y, sum.z += y.z, sum.w += y.w;
        }
      } else {
        sum = *(const float4*)(tile + t * DH + x);
      }
      *(float4*)(dv + out0 + (int64_t)t * step + x) = sum;
    }
    if (c > 0) dot_vd<DH>(sm + (c - 1) % 2 * Sh::kStage, svd + (c - 1) % 2 * kL, tid);
    __syncthreads();   // chunk c's rows and partials read
    if (c > 1)
      stage_chunk<DH>(sm + c % 2 * Sh::kStage, r, k, w, v, dy, s0, ckpt, tok0, step, bh, i0,
                      S, c - 2, gran, tid);
  }
  sync();   // no block leaves while the cluster reads its tiles
  {
    const int64_t gi = (bh * DH + i0 + row) * DH + c0;
#pragma unroll
    for (int e = 0; e < kCW; ++e) ds0[gi + e] = g[e];
  }
  // du: the threads' shares by row quad, added in thread order
  *(float4*)(part + tid * 4) = make_float4(du4[0], du4[1], du4[2], du4[3]);
  __syncthreads();
  if (tid < kRows) {
    float sum = part[tid / 4 * 4 + tid % 4];
    for (int m = tid / 4 + 4; m < NT; m += 4) sum += part[m * 4 + tid % 4];
    du_rows[bh * DH + i0 + tid] = sum;
  }
}

__global__ void __launch_bounds__(256) wkv6_bwd_sum_kernel(repro::SumJob j) {
  repro::sum_partials(j);
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, const float* dy, const float* ds,
           const float* ckpt, float* dr, float* dk, float* dv, float* dw,
           float* du, float* ds0, float* du_rows, int B, int S, int H,
           cudaStream_t stream) {
  using Sh = BwdShape<DH>;
  constexpr int bytes = 4 * Sh::kFloats;
  if (bytes > 48 * 1024) {
    static bool configured[repro::kMaxDevices] = {};
    if (int rc = repro::opt_in_smem(wkv6_bwd_kernel<DH>, configured)) return rc;
  }
  // 16-byte copies where every staged operand allows them, else narrower
  int gran = 16;
  for (const float* p : {r, k, v, w, dy})
    gran = std::min(gran, repro::copy_granule(p, 4, (int64_t)H * DH, DH, kRows));
  for (const float* p : {s0, ckpt})
    if (p != nullptr) gran = std::min(gran, repro::copy_granule(p, 4, DH, DH, DH));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)H * (unsigned)Sh::kSlices);
  cfg.blockDim = dim3(Sh::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)Sh::kSlices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Sh::kSlices > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<DH>, r, k, v, w, u, s0, dy, ds,
                                     ckpt, dr, dk, dv, dw, ds0, du_rows, S, H, gran);
  if (e != cudaSuccess) return (int)e;
  if (int rc = (int)cudaGetLastError()) return rc;
  const repro::SumJob job{du_rows, du, 1, (int64_t)H * DH, B, 0};
  wkv6_bwd_sum_kernel<<<repro::sum_blocks(job.inner), 256, 0, stream>>>(job);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy and the four gradients [B, S, H, DH]; u and du [H, DH];
// s0, ds (null: zero) and ds0 [B, H, DH, DH]; ckpt as csrc/wkv6.cu writes
// it (null when S <= 16); du_rows [B, H, DH], a float32 buffer of the
// caller.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dy, const void* ds, const void* ckpt,
                              void* dr, void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* du_rows, int B, int S, int H, int DH,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (S > kL && ckpt == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  auto o = [](void* p) { return (float*)p; };
#define REPRO_WKV6_BWD(D)                                                                 \
  return launch<D>(f(r), f(k), f(v), f(w), f(u), f(s0), f(dy), f(ds), f(ckpt), o(dr),    \
                   o(dk), o(dv), o(dw), o(du), o(ds0), o(du_rows), B, S, H, st)
  switch (DH) {
    case 16: REPRO_WKV6_BWD(16);
    case 32: REPRO_WKV6_BWD(32);
    case 64: REPRO_WKV6_BWD(64);
    case 128: REPRO_WKV6_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_WKV6_BWD
}
