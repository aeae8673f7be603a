// wkv6_bwd: the backward of RWKV-6's time-mix recurrence (csrc/wkv6.cu),
// per (row, head).  Forward, per token t, with the state S [DH, DH]:
//
//   y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//   S_t    = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]
//
// Backward, with G_t the gradient of S_t (ds, the final state's gradient,
// after the last token; zero when null), vd_t = v_t . dy_t and
// ruk_t = sum_i r_t[i] u[i] k_t[i], walking the tokens backwards:
//
//   dr_t[i] = sum_j S_{t-1}[i, j] dy_t[j] + u[i] k_t[i] vd_t
//   dk_t[i] = sum_j G_t[i, j] v_t[j]      + u[i] r_t[i] vd_t
//   dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//   dv_t[j] = sum_i G_t[i, j] k_t[i]      + dy_t[j] ruk_t
//   du[i]  += r_t[i] k_t[i] vd_t
//   G_{t-1} = w_t[i] G_t[i, j] + r_t[i] dy_t[j]      (ds0 = G_{-1})
//
// Replaces no Pallas kernel: the JAX package differentiates its lax.scan
// (src/repro/models/rwkv6.py:87, _wkv_scan), checkpointed per 128-token
// chunk; kernels/wkv6/ref.py:wkv6_bwd_ref is this algorithm in PyTorch.
//
// S_{t-1} is never recovered from S_t by dividing by w_t (a decay of 1e-30
// would lose it).  The forward writes the state before each chunk of kL =
// 16 tokens (ckpt); the backward walks the chunks in reverse, recomputes
// the chunk's 16 states from its checkpoint into a per-block scratch in
// device memory (32 KB at DH 64: it stays in L2), then runs the chunk's
// tokens backwards, carrying G in registers.
//
// Bound: the backward reads r, k, v, w and dy and writes dr, dk, dv and
// dw once (bytes), plus the checkpoints; its ~10 DH^2 operations a token
// and head are a few percent of the float32 rate.  A block holds one
// (row, head) with 4 DH threads: thread (row i, column group cg) owns
// G[i, cg DH/4 ..] (a chunk's states in the scratch, laid out so each
// thread's loads and stores coalesce); the sums over j (dr, dk, dw) are
// in-thread, then the 4 groups' partials added through shared memory;
// the sum over i (dv) goes through a transposed tile in shared memory,
// 4 threads a column, then two xor shuffles.  Two buffers by token parity,
// so one barrier a token.  Every sum runs in a fixed order and no atomic
// is used: repeated calls are bit-identical.  du is written as per-row
// partials [B, H, DH], which a second kernel (wkv6_bwd_sum_kernel) adds
// in row order.  Float32 on the CUDA cores throughout.
#include "common.cuh"

namespace {

constexpr int kL = 16;   // tokens per chunk: the forward's checkpoint interval

template <int DH> struct BwdShape {
  static constexpr int kThreads = 4 * DH;
  static constexpr int kCW = DH / 4;       // columns per thread
  static constexpr int kPitch = DH + 4;    // bank-conflict-free both ways
  // r, k, w, v, dy [kL][DH]; vd, ruk [kL]; u [DH]; the transposed tiles
  // [2][DH][kPitch]; the row-sum partials [2][3][4][DH]
  static constexpr int kFloats = 5 * kL * DH + 2 * kL + DH + 2 * DH * kPitch + 2 * 12 * DH;
};

template <int DH>
__global__ void __launch_bounds__(4 * DH)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ ds,
                const float* __restrict__ ckpt, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ ds0,
                float* __restrict__ scratch, float* __restrict__ du_rows, int S,
                int H) {
  using Sh = BwdShape<DH>;
  constexpr int NT = Sh::kThreads, CW = Sh::kCW, P = Sh::kPitch;
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;
  float* sk = sr + kL * DH;
  float* sw = sk + kL * DH;
  float* sv = sw + kL * DH;
  float* sdy = sv + kL * DH;
  float* svd = sdy + kL * DH;
  float* sruk = svd + kL;
  float* su = sruk + kL;
  float* red = su + DH;             // [2][DH][P]: G[i, j] k[i] at [j][i]
  float* rs = red + 2 * DH * P;     // [2][3][4][DH]: dr, dk, dw partials

  const int bh = blockIdx.x, b = bh / H, hd = bh - b * H;
  const int tid = threadIdx.x;
  const int i = tid % DH, cg = tid / DH;   // row i, columns cg CW ..
  const int jr = tid / 4, q = tid % 4;     // dv: column jr, rows q + 4 m
  const int64_t step = (int64_t)H * DH;
  const int64_t tok0 = (int64_t)b * S * step + (int64_t)hd * DH;
  const int chunks = (S + kL - 1) / kL;
  const int64_t sidx = (int64_t)bh * DH * DH + (int64_t)i * DH + cg * CW;
  float* scr = scratch + (int64_t)bh * kL * DH * DH;

  if (tid < DH) su[tid] = u[hd * DH + tid];
  float g[CW];
#pragma unroll
  for (int e = 0; e < CW; ++e) g[e] = ds != nullptr ? ds[sidx + e] : 0.0f;
  float du = 0.0f;

  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kL, cnt = S - t0 < kL ? S - t0 : kL;
    __syncthreads();   // the previous chunk's rows are read
    for (int e = tid; e < kL * DH; e += NT) {
      const int t = e / DH;
      const bool ok = t < cnt;
      const int64_t off = tok0 + (int64_t)(t0 + t) * step + e % DH;
      sr[e] = ok ? r[off] : 0.0f;
      sk[e] = ok ? k[off] : 0.0f;
      sw[e] = ok ? w[off] : 1.0f;
      sv[e] = ok ? v[off] : 0.0f;
      sdy[e] = ok ? dy[off] : 0.0f;
    }
    const float* cp = c == 0 ? s0 + sidx
                             : ckpt + ((int64_t)bh * (chunks - 1) + c - 1) * DH * DH +
                                   (int64_t)i * DH + cg * CW;
    float st[CW];
#pragma unroll
    for (int e = 0; e < CW; ++e) st[e] = cp[e];
    __syncthreads();
    {  // vd_t and ruk_t, a warp a token
      const int warp = tid / 32, lane = tid % 32;
      for (int t = warp; t < kL; t += NT / 32) {
        float a = 0.0f, bb = 0.0f;
        for (int x = lane; x < DH; x += 32) {
          a = fmaf(sv[t * DH + x], sdy[t * DH + x], a);
          bb = fmaf(sr[t * DH + x] * su[x], sk[t * DH + x], bb);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, o);
          bb += __shfl_xor_sync(0xffffffffu, bb, o);
        }
        if (lane == 0) {
          svd[t] = a;
          sruk[t] = bb;
        }
      }
    }
    // the chunk's states S_{t-1}, recomputed from the checkpoint: each
    // thread writes and later reads back only its own elements
    for (int t = 0; t < cnt; ++t) {
      float* sp = scr + (int64_t)t * DH * DH + tid;
      const float wi = sw[t * DH + i], ki = sk[t * DH + i];
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        sp[e * NT] = st[e];
        st[e] = fmaf(wi, st[e], ki * sv[t * DH + cg * CW + e]);
      }
    }
    __syncthreads();   // vd and ruk
    for (int t = cnt - 1; t >= 0; --t) {
      float* rd = red + (t & 1) * DH * P;
      float* rsp = rs + (t & 1) * 12 * DH;
      const float* sp = scr + (int64_t)t * DH * DH + tid;
      const float ri = sr[t * DH + i], ki = sk[t * DH + i], wi = sw[t * DH + i];
      const float* vrow = sv + t * DH + cg * CW;
      const float* dyrow = sdy + t * DH + cg * CW;
      float pr = 0.0f, pk = 0.0f, pw = 0.0f;
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const float s = sp[e * NT], vj = vrow[e], dyj = dyrow[e];
        pr = fmaf(s, dyj, pr);
        pk = fmaf(g[e], vj, pk);
        pw = fmaf(g[e], s, pw);
        rd[(cg * CW + e) * P + i] = g[e] * ki;
        g[e] = fmaf(wi, g[e], ri * dyj);     // G_{t-1}
      }
      rsp[cg * DH + i] = pr;
      rsp[(4 + cg) * DH + i] = pk;
      rsp[(8 + cg) * DH + i] = pw;
      if (cg == 0) du = fmaf(ri * ki, svd[t], du);
      __syncthreads();
      const int64_t out = tok0 + (int64_t)(t0 + t) * step;
      float a = 0.0f;
#pragma unroll
      for (int m = 0; m < DH / 4; ++m) a += rd[jr * P + q + 4 * m];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (q == 0) dv[out + jr] = fmaf(sdy[t * DH + jr], sruk[t], a);
      if (tid < 3 * DH) {
        const int kind = tid / DH, x = tid % DH;
        const float* p = rsp + kind * 4 * DH + x;
        const float sum = (p[0] + p[DH]) + (p[2 * DH] + p[3 * DH]);
        if (kind == 0)
          dr[out + x] = fmaf(su[x] * sk[t * DH + x], svd[t], sum);
        else if (kind == 1)
          dk[out + x] = fmaf(su[x] * sr[t * DH + x], svd[t], sum);
        else
          dw[out + x] = sum;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < CW; ++e) ds0[sidx + e] = g[e];
  if (cg == 0) du_rows[(int64_t)bh * DH + i] = du;
}

__global__ void __launch_bounds__(256) wkv6_bwd_sum_kernel(repro::SumJob j) {
  repro::sum_partials(j);
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, const float* dy, const float* ds,
           const float* ckpt, float* dr, float* dk, float* dv, float* dw,
           float* du, float* ds0, float* scratch, float* du_rows, int B, int S,
           int H, cudaStream_t stream) {
  static bool configured[repro::kMaxDevices] = {};
  if (int rc = repro::opt_in_smem(wkv6_bwd_kernel<DH>, configured)) return rc;
  constexpr int bytes = 4 * BwdShape<DH>::kFloats;
  wkv6_bwd_kernel<DH><<<(unsigned)B * (unsigned)H, 4 * DH, bytes, stream>>>(
      r, k, v, w, u, s0, dy, ds, ckpt, dr, dk, dv, dw, ds0, scratch, du_rows, S, H);
  if (int rc = (int)cudaGetLastError()) return rc;
  const repro::SumJob job{du_rows, du, 1, (int64_t)H * DH, B, 0};
  wkv6_bwd_sum_kernel<<<repro::sum_blocks(job.inner), 256, 0, stream>>>(job);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy and the four gradients [B, S, H, DH]; u and du [H, DH];
// s0, ds (null: zero) and ds0 [B, H, DH, DH]; ckpt as csrc/wkv6.cu writes
// it (null when S <= 16); scratch [B H, 16, DH, DH] and du_rows [B, H, DH]
// float32 buffers of the caller.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              const void* dy, const void* ds, const void* ckpt,
                              void* dr, void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* scratch, void* du_rows, int B,
                              int S, int H, int DH, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (S > kL && ckpt == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  auto o = [](void* p) { return (float*)p; };
#define REPRO_WKV6_BWD(D)                                                                 \
  return launch<D>(f(r), f(k), f(v), f(w), f(u), f(s0), f(dy), f(ds), f(ckpt), o(dr),    \
                   o(dk), o(dv), o(dw), o(du), o(ds0), o(scratch), o(du_rows), B, S, H, st)
  switch (DH) {
    case 16: REPRO_WKV6_BWD(16);
    case 32: REPRO_WKV6_BWD(32);
    case 64: REPRO_WKV6_BWD(64);
    case 128: REPRO_WKV6_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_WKV6_BWD
}
