// wkv6: RWKV-6's time-mix recurrence per (row, head):
//
//   y_t[j] = sum_i (S[i, j] + u[i] k_t[i] v_t[j]) r_t[i]
//   S[i, j] <- w_t[i] S[i, j] + k_t[i] v_t[j]
//
// r, k, v, w, y: [B, S, H, DH] float32, contiguous; u: [H, DH]; the state
// s0 and s_out: [B, H, DH, DH], row i, column j.  s_out may be s0 itself
// (the engine's per-slot state, updated in place).  ckpt, when not null
// (a train step's forward; serving passes null): [B, H, ceil(S / kL) - 1,
// DH, DH], the state before each chunk of kL tokens but the first, which
// the backward (csrc/wkv6_bwd.cu) recomputes each chunk's states from.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as a
// lax.scan, in checkpointed chunks of 128 tokens
// (src/repro/models/rwkv6.py:87, _wkv_scan), outside Pallas.  The port
// has a kernel for it because the plain version is a Python loop of about
// six small launches per token and layer: tens of thousands of nodes in
// every prefill graph.
//
// Bound: bytes for a decode step (the state, 16 KiB per row and head at
// DH 64, is read and written once; the token's r, k, v, w and y are 1 KiB);
// the 4 DH^2 operations per token and head are a few percent of the
// card's float32 rate.  Token by token, a prefill is a chain of S
// dependent steps on few blocks; the kernel takes the chunked form
// instead, which turns the chain into S / kL chunk steps, each done by a
// whole block, and spreads a head's columns over DH / kCols blocks.  Within
// a chunk of kL tokens, with the chunk's start state S0 and the decays
// written as products of w (each at most 1: no overflow and no division;
// a product over no tokens is 1):
//
//   G_i[t, s] = prod_{s < tau < t} w_tau[i]           (s < t)
//   A[t, s]   = sum_i r_t[i] k_s[i] G_i[t, s],  A[t, t] = sum_i r_t[i] u[i] k_t[i]
//   rd_t[i]   = r_t[i] prod_{tau < t} w_tau[i]
//   kd_s[i]   = k_s[i] prod_{s < tau < kL} w_tau[i],   P[i] = prod_tau w_tau[i]
//   y_t[j]    = sum_i rd_t[i] S0[i, j] + sum_{s <= t} A[t, s] v_s[j]
//   S[i, j]  <- P[i] S0[i, j] + sum_s kd_s[i] v_s[j]
//
// (kernels/wkv6/ref.py:wkv6_chunked_ref is this algebra in PyTorch.)  The
// rows of the last chunk past the sequence count as r = k = v = 0 and
// w = 1, which change nothing.
//
// - Two or more tokens (wkv6_kernel): one block per (row, head, slice of
//   kCols = 16 state columns), DH / 16 slices, so a one-row prefill at
//   RWKV-6's 32 heads of 64 fills 128 blocks.  Columns are independent;
//   A, rd, kd and P are the same for every slice of a head, and each
//   slice's block computes them itself.
// - The block's 512 threads take two roles.  256 consumers hold the
//   slice's state, thread (column jl, row group gl) DH / 16 rows of one
//   column in registers, and run chunk c: y's share of their rows, the
//   state update, then (column, token) threads add the 16 groups' shares
//   from shared memory (laid out so that neither side has bank
//   conflicts) and the chunk's own tokens (A v), and store y.  256
//   producers meanwhile stage chunk c + 2 (cp.async, 16-byte pieces) and
//   derive chunk c + 1: the decays as running products of w, and A, each
//   thread (s, row group) walking t upwards with G_i[t, s] k_s[i] for its
//   rows.  One barrier of the block a chunk; a role's own steps sync on
//   its named barrier.
// - One token (wkv6_decode_kernel): block per (row, head), thread (column
//   j, a quarter of the rows at DH 64), so the state moves in rows of DH
//   contiguous floats; each element as the token loop computes it (kd =
//   k, P = w: the decay is w itself); y's sum over the row groups through
//   shared memory.
// - Float32 on the CUDA cores throughout, as the reference (TF32 would
//   not hold 1e-5); the sums run in another order than the token loop's.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kL = 16;          // tokens per chunk
constexpr int kCols = 16;       // state columns per block
constexpr int kGroups = 16;     // row groups per column
constexpr int kRole = kCols * kGroups;   // threads of each role
static_assert(kL == kGroups && kL == kCols, "a role's thread is also (t, column)");
// partial sums over row groups, exchanged through shared memory as
// [t][group][kCols + 1]: 272 = 16 (kCols + 1) floats a token, so both the
// writes (lanes over groups) and the reads (lanes over columns and two
// tokens) fall in 32 distinct banks
constexpr int kRedT = kGroups * (kCols + 1);
constexpr int kRed = kL * kRedT;

// n consecutive floats from shared memory (n = 1, 2, 4 or 8; aligned)
template <int n>
__device__ __forceinline__ void loadv(const float* p, float (&o)[n]) {
  if constexpr (n == 1) {
    o[0] = p[0];
  } else if constexpr (n == 2) {
    const float2 a = *(const float2*)p;
    o[0] = a.x, o[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < n; q += 4) {
      const float4 a = *(const float4*)(p + q);
      o[q] = a.x, o[q + 1] = a.y, o[q + 2] = a.z, o[q + 3] = a.w;
    }
  }
}

// A barrier of one role's kRole threads (barrier 0 is __syncthreads')
__device__ __forceinline__ void role_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kRole) : "memory");
}

// Shared memory of the chunked kernel, in floats: two buffers of a
// chunk's rows as staged (r, k, w [kL][DH], v [kL][kCols]); two of what
// the producers derive from them (rd, kd [kL][DH], P [DH], A [kL][kL + 1],
// v [kL][kCols], the rows past the sequence zeroed); u [DH]; the
// producers' and the consumers' partial sums ([kRed] each); the state
// slice [DH][kCols + 1].
template <int DH> struct Layout {
  static constexpr int kRaw = 3 * kL * DH + kL * kCols;
  static constexpr int kDer = 2 * kL * DH + DH + kL * (kL + 1) + kL * kCols;
  static constexpr int kFloats = 2 * kRaw + 2 * kDer + DH + 2 * kRed + DH * (kCols + 1);
  static_assert(kRaw % 4 == 0 && kDer % 4 == 0 && kRed % 4 == 0,
                "16-byte aligned buffers");
};

// Stage chunk c's rows of r, k and w and the slice's v into `raw`, as one
// cp.async group over the producers' threads (this one is `tid`): 16-byte
// pieces at compile-time offsets where `gran` is 16, else stage_rows.
template <int DH>
__device__ __forceinline__ void stage_chunk(
    float* raw, const float* r, const float* k, const float* w, const float* v,
    int64_t tok0, int64_t step, int col0, int S, int c, int gran, int tid) {
  const int t0 = c * kL, cnt = S - t0 < kL ? S - t0 : kL;
  const int64_t off = tok0 + t0 * step;
  if (gran == 16) {
    constexpr int G = DH / 4;                 // pieces a row
#pragma unroll
    for (int e = tid; e < kL * G; e += kRole) {
      const int t = e / G, q = e % G * 4;
      if (t < cnt) {
        const int64_t src = off + t * step + q;
        repro::cp_async(raw + t * DH + q, r + src, 16);
        repro::cp_async(raw + (kL + t) * DH + q, k + src, 16);
        repro::cp_async(raw + (2 * kL + t) * DH + q, w + src, 16);
      }
    }
    if (tid < kL * kCols / 4) {
      const int t = tid / (kCols / 4), q = tid % (kCols / 4) * 4;
      if (t < cnt)
        repro::cp_async(raw + 3 * kL * DH + t * kCols + q, v + off + t * step + col0 + q, 16);
    }
  } else {
    repro::stage_rows(raw, DH * 4, r + off, step * 4, cnt, DH * 4, gran, tid, kRole);
    repro::stage_rows(raw + kL * DH, DH * 4, k + off, step * 4, cnt, DH * 4, gran,
                      tid, kRole);
    repro::stage_rows(raw + 2 * kL * DH, DH * 4, w + off, step * 4, cnt, DH * 4,
                      gran, tid, kRole);
    repro::stage_rows(raw + 3 * kL * DH, kCols * 4, v + off + col0, step * 4, cnt,
                      kCols * 4, gran, tid, kRole);
  }
  repro::cp_async_commit();
}

// The producers' part of a chunk of `cnt` tokens, from the staged rows
// (those past `cnt` taken as r = k = v = 0 and w = 1): rd, kd and P as
// running products of w, and v, by the first 2 DH threads; then A, each
// thread (s = jl, row group gl) carrying G_i[t, s] k_s[i] up t for its
// rows into partial sums of A[t, s] (A[t, t] = D_t, zero for t < s),
// which thread (s = tid % 16, t = tid / 16) adds over the groups.
template <int DH>
__device__ __forceinline__ void derive(const float* raw, float* der,
                                       const float* su, float* red, int cnt,
                                       int tid) {
  constexpr int GW = DH / kGroups;
  const float* cr = raw;
  const float* ck = raw + kL * DH;
  const float* cw = raw + 2 * kL * DH;
  const float* cv = raw + 3 * kL * DH;
  float* rd = der;
  float* kd = der + kL * DH;
  float* P = der + 2 * kL * DH;
  float* A = P + DH;
  float* dv = A + kL * (kL + 1);
  if (tid < 2 * DH) {
    const int i = tid % DH;
    const float* src = tid < DH ? cr : ck;
    float x[kL], wt[kL];   // read first: the stores below may not pass them
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      const float xv = src[t * DH + i], wv = cw[t * DH + i];
      x[t] = t < cnt ? xv : 0.f;
      wt[t] = t < cnt ? wv : 1.f;
    }
    float q = 1.f;
    if (tid < DH) {
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        rd[t * DH + i] = x[t] * q;
        q *= wt[t];
      }
    } else {
#pragma unroll
      for (int t = kL - 1; t >= 0; --t) {
        kd[t * DH + i] = x[t] * q;
        q *= wt[t];
      }
      P[i] = q;
    }
  }
  {
    const float vv = cv[tid];
    dv[tid] = tid / kCols < cnt ? vv : 0.f;
  }
  const int s = tid / 32 * 2 + tid % 32 / kGroups, gl = tid % kGroups;
  const int i0 = gl * GW;
  float hk[GW], uu[GW];
  loadv<GW>(ck + s * DH + i0, hk);
  loadv<GW>(su + i0, uu);
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    float rt[GW], wt[GW];
    loadv<GW>(cr + t * DH + i0, rt);
    if (t > 0) {
      loadv<GW>(cw + (t - 1) * DH + i0, wt);
#pragma unroll
      for (int m = 0; m < GW; ++m) hk[m] = t > s + 1 ? hk[m] * wt[m] : hk[m];
    }
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < GW; ++m) acc = fmaf(t == s ? rt[m] * uu[m] : rt[m], hk[m], acc);
    red[t * kRedT + gl * (kCols + 1) + s] = t >= s ? acc : 0.f;
  }
  role_sync(1);
  const int c = tid % kCols, t = tid / kCols;
  float a = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) a += red[t * kRedT + g * (kCols + 1) + c];
  A[t * (kL + 1) + c] = a;
}

// The consumers' part of a chunk: thread (column jl, rows gl * GW ..)
// holds st; it adds its rows' share of y_t = rd_t S0 into `red` and
// updates st; then thread (column c = tid % 16, token t = tid / 16) adds
// the groups' shares and the chunk's own tokens (A v) and stores y_t.
template <int DH>
__device__ __forceinline__ void consume(const float* der, float (&st)[DH / kGroups],
                                        float* red, float* y, int cnt,
                                        int tid, int jl, int gl) {
  constexpr int GW = DH / kGroups;
  const float* rd = der;
  const float* kd = der + kL * DH;
  const float* P = der + 2 * kL * DH;
  const float* A = P + DH;
  const float* dv = A + kL * (kL + 1);
  const int i0 = gl * GW;
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    float r4[GW];
    loadv<GW>(rd + t * DH + i0, r4);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < GW; ++m) acc = fmaf(r4[m], st[m], acc);
    red[t * kRedT + gl * (kCols + 1) + jl] = acc;
  }
  float pd[GW];
  loadv<GW>(P + i0, pd);
#pragma unroll
  for (int m = 0; m < GW; ++m) st[m] *= pd[m];
#pragma unroll
  for (int s = 0; s < kL; ++s) {
    float k4[GW];
    loadv<GW>(kd + s * DH + i0, k4);
    const float vs = dv[s * kCols + jl];
#pragma unroll
    for (int m = 0; m < GW; ++m) st[m] = fmaf(k4[m], vs, st[m]);
  }
  role_sync(2);
  const int c = tid % kCols, t = tid / kCols;
  float out = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) out += red[t * kRedT + g * (kCols + 1) + c];
#pragma unroll
  for (int s = 0; s < kL; ++s)   // A[t, s] is 0 for s > t
    out = fmaf(A[t * (kL + 1) + s], dv[s * kCols + c], out);
  if (t < cnt) y[c] = out;
}

// Two or more tokens: block = (row, head, slice); threads [0, kRole) are
// consumers, [kRole, 2 kRole) producers.  In the loop over chunks the
// producers stage chunk c + 2 and derive chunk c + 1 while the consumers
// run chunk c, so the two overlap; one barrier of the block a chunk.
template <int DH>
__global__ void __launch_bounds__(2 * kRole, DH <= 64 ? 2 : 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* __restrict__ y,
            float* s_out, float* __restrict__ ckpt, int S, int H, int gran) {
  using L = Layout<DH>;
  constexpr int GW = DH / kGroups;          // rows per consumer thread
  constexpr int kSlices = DH / kCols;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                        // [2][L::kRaw]
  float* der = raw + 2 * L::kRaw;           // [2][L::kDer]
  float* su = der + 2 * L::kDer;            // [DH]
  float* red = su + DH;                     // [2][kRed]: producers', consumers'
  float* sS = red + 2 * kRed;               // [DH][kCols + 1]

  const int bh = blockIdx.x / kSlices;      // row * H + head
  const int col0 = (blockIdx.x - bh * kSlices) * kCols;
  const int b = bh / H, hd = bh - b * H;
  const bool producer = threadIdx.x >= kRole;
  const int tid = threadIdx.x % kRole;                  // within its role
  const int jl = tid / 32 * 2 + tid % 32 / kGroups;     // column
  const int gl = tid % kGroups;                         // row group
  const int64_t step = (int64_t)H * DH;     // elements between two tokens
  const int64_t tok0 = (int64_t)b * S * step + (int64_t)hd * DH;
  const int chunks = (S + kL - 1) / kL;
  auto count = [S](int c) { return S - c * kL < kL ? S - c * kL : kL; };

  float st[GW];
  if (producer) {
    if (tid < DH) su[tid] = u[hd * DH + tid];
    stage_chunk<DH>(raw, r, k, w, v, tok0, step, col0, S, 0, gran, tid);
    if (chunks > 1) {
      stage_chunk<DH>(raw + L::kRaw, r, k, w, v, tok0, step, col0, S, 1, gran, tid);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    role_sync(1);
    derive<DH>(raw, der, su, red, count(0), tid);
  } else {
    // s0 and s_out may be one tensor: the block reads its whole slice
    // before it writes any of it, and touches no other block's slice
    const float* sp = s0 + (int64_t)bh * DH * DH + col0;
    for (int e = tid; e < DH * kCols; e += kRole)
      sS[e / kCols * (kCols + 1) + e % kCols] = sp[(int64_t)(e / kCols) * DH + e % kCols];
    role_sync(2);
#pragma unroll
    for (int m = 0; m < GW; ++m) st[m] = sS[(gl * GW + m) * (kCols + 1) + jl];
  }
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    if (producer) {
      if (c + 1 < chunks) {
        // chunk c + 2 goes where chunk c was, which was derived last round
        if (c + 2 < chunks) {
          stage_chunk<DH>(raw + c % 2 * L::kRaw, r, k, w, v, tok0, step, col0, S,
                          c + 2, gran, tid);
          repro::cp_async_wait<1>();
        } else {
          repro::cp_async_wait<0>();
        }
        role_sync(1);
        derive<DH>(raw + (c + 1) % 2 * L::kRaw, der + (c + 1) % 2 * L::kDer, su,
                   red, count(c + 1), tid);
      }
    } else {
      if (ckpt != nullptr && c > 0) {   // the state before chunk c
        float* cp = ckpt + ((int64_t)bh * (chunks - 1) + c - 1) * DH * DH + col0 + jl;
#pragma unroll
        for (int m = 0; m < GW; ++m) cp[(int64_t)(gl * GW + m) * DH] = st[m];
      }
      consume<DH>(der + c % 2 * L::kDer, st, red + kRed,
                  y + tok0 + (c * kL + tid / kCols) * step + col0, count(c), tid,
                  jl, gl);
    }
    __syncthreads();
  }

  if (!producer) {
#pragma unroll
    for (int m = 0; m < GW; ++m) sS[(gl * GW + m) * (kCols + 1) + jl] = st[m];
    role_sync(2);
    float* op = s_out + (int64_t)bh * DH * DH + col0;
    for (int e = tid; e < DH * kCols; e += kRole)
      op[(int64_t)(e / kCols) * DH + e % kCols] = sS[e / kCols * (kCols + 1) + e % kCols];
  }
}

// One token (the decode step, a chunk of one): block = (row, head), thread
// (column j, rows q RQ ..), so the state is read and written in rows of
// DH contiguous floats; each element as the token loop computes it (kd =
// k, P = w), y's sum over i over the row groups through shared memory.
template <int DH>
__global__ void __launch_bounds__(kRole)
wkv6_decode_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* s0,
                   float* __restrict__ y, float* s_out, int H) {
  constexpr int NQ = kRole / DH, RQ = DH / NQ;   // row groups, rows each
  __shared__ __align__(16) float tok_rkwu[4][DH];
  __shared__ float part[NQ][DH];
  const int bh = blockIdx.x, hd = bh % H;        // row * H + head
  const int j = threadIdx.x % DH, q = threadIdx.x / DH;
  const int64_t tok = (int64_t)bh * DH;          // [B, 1, H, DH]
  if (threadIdx.x < DH) {
    tok_rkwu[0][j] = r[tok + j];
    tok_rkwu[1][j] = k[tok + j];
    tok_rkwu[2][j] = w[tok + j];
    tok_rkwu[3][j] = u[hd * DH + j];
  }
  const float vj = v[tok + j];
  // s0 and s_out may be one tensor: each thread reads its elements before
  // it writes them, and touches no other thread's
  const float* sp = s0 + (int64_t)bh * DH * DH + (int64_t)q * RQ * DH + j;
  float st[RQ];
#pragma unroll
  for (int m = 0; m < RQ; ++m) st[m] = sp[m * DH];
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < RQ; ++m) {
    const int i = q * RQ + m;
    const float kv = tok_rkwu[1][i] * vj;
    acc = fmaf(fmaf(tok_rkwu[3][i], kv, st[m]), tok_rkwu[0][i], acc);
    st[m] = fmaf(tok_rkwu[2][i], st[m], kv);
  }
  part[q][j] = acc;
  float* op = s_out + (int64_t)bh * DH * DH + (int64_t)q * RQ * DH + j;
#pragma unroll
  for (int m = 0; m < RQ; ++m) op[m * DH] = st[m];
  __syncthreads();
  if (q == 0) {
    float yv = part[0][j];
#pragma unroll
    for (int g = 1; g < NQ; ++g) yv += part[g][j];
    y[tok + j] = yv;
  }
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, float* ckpt,
           int B, int S, int H, cudaStream_t stream) {
  if (S == 1) {
    wkv6_decode_kernel<DH><<<(unsigned)B * (unsigned)H, kRole, 0, stream>>>(
        r, k, v, w, u, s0, y, s_out, H);
    return (int)cudaGetLastError();
  }
  // 16-byte copies where every staged operand allows them (rows are DH
  // floats, the slice's v 16, so the base addresses decide), else 4
  int gran = 16;
  for (const float* p : {r, k, v, w})
    gran = std::min(gran, repro::copy_granule(p, 4, (int64_t)H * DH, DH, kCols));
  const unsigned blocks = (unsigned)B * (unsigned)H * (unsigned)(DH / kCols);
  constexpr int bytes = 4 * Layout<DH>::kFloats;
  if (bytes > 48 * 1024) {
    static bool configured[repro::kMaxDevices] = {};
    const int rc = repro::opt_in_smem(wkv6_kernel<DH>, configured);
    if (rc) return rc;
  }
  wkv6_kernel<DH><<<blocks, 2 * kRole, bytes, stream>>>(r, k, v, w, u, s0, y,
                                                        s_out, ckpt, S, H, gran);
  return (int)cudaGetLastError();
}

}  // namespace

// ckpt: null, or the state before each chunk of 16 tokens but the first
// (a one-token call has no such chunk and writes none).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, void* ckpt, int B, int S, int H,
                          int DH, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  auto o = [](void* p) { return (float*)p; };
  switch (DH) {
    case 16: return launch<16>(f(r), f(k), f(v), f(w), f(u), f(s0), o(y), o(s_out), o(ckpt), B, S, H, st);
    case 32: return launch<32>(f(r), f(k), f(v), f(w), f(u), f(s0), o(y), o(s_out), o(ckpt), B, S, H, st);
    case 64: return launch<64>(f(r), f(k), f(v), f(w), f(u), f(s0), o(y), o(s_out), o(ckpt), B, S, H, st);
    case 128: return launch<128>(f(r), f(k), f(v), f(w), f(u), f(s0), o(y), o(s_out), o(ckpt), B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
