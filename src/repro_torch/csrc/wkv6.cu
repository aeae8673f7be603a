// wkv6: RWKV-6's time-mix recurrence, token-serial, per (row, head):
//
//   y_t[j] = sum_i (S[i, j] + u[i] k_t[i] v_t[j]) r_t[i]
//   S[i, j] <- w_t[i] S[i, j] + k_t[i] v_t[j]
//
// r, k, v, w, y: [B, S, H, DH] float32, contiguous; u: [H, DH]; the state
// s0 and s_out: [B, H, DH, DH], row i, column j.  s_out may be s0 itself
// (the engine's per-slot state, updated in place).
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
// card's float32 rate.  But a prefill is a chain of S dependent steps, so
// its time is the chain's latency, not either bound.  The design keeps
// that chain short and everything else off it:
//
// - One block per (row, head), DH threads; thread j owns column j of the
//   state, held in DH registers for the whole sequence.  Columns are
//   independent, so a step needs no exchange between threads: the state
//   is read from memory once and written once per call.
// - r, k, v and w of C = 2048 / DH steps are staged through shared memory in one
//   coalesced pass (thread j loads element j of each row), so a chunk
//   waits on memory once, not every step.  In the step loop every thread
//   reads the same r_t[i], k_t[i], w_t[i] (a broadcast) and its own v_t[j].
// - Float32 throughout, as the reference; the products are the
//   reference's (k v, u (k v), S + u k v, times r; w S + k v), summed over
//   i in order and contracted into FMAs.
#include "common.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(DH)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0, float* __restrict__ y,
            float* s_out, int S, int H) {
  constexpr int C = 2048 / DH;     // steps staged per pass: 32 KiB of smem
  __shared__ float sr[C][DH], sk[C][DH], sv[C][DH], sw[C][DH];
  __shared__ float su[DH];
  const int bh = blockIdx.x;                 // row * H + head
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;
  // s0 and s_out may be one tensor: each thread reads its whole column
  // before it writes any of it, and touches no other column
  const float* sp = s0 + (int64_t)bh * DH * DH + j;
  float st[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) st[i] = sp[i * DH];
  su[j] = u[h * DH + j];
  const int64_t step = (int64_t)H * DH;      // elements between two tokens
  const int64_t base = (int64_t)b * S * step + (int64_t)h * DH + j;
  for (int t0 = 0; t0 < S; t0 += C) {
    const int n = S - t0 < C ? S - t0 : C;
    __syncthreads();                         // the last chunk's reads are done
    for (int c = 0; c < n; ++c) {
      const int64_t off = base + (t0 + c) * step;
      sr[c][j] = r[off];
      sk[c][j] = k[off];
      sv[c][j] = v[off];
      sw[c][j] = w[off];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float kv = sk[c][i] * vj;
        acc += (st[i] + su[i] * kv) * sr[c][i];
        st[i] = sw[c][i] * st[i] + kv;
      }
      y[base + (t0 + c) * step] = acc;
    }
  }
  float* op = s_out + (int64_t)bh * DH * DH + j;
#pragma unroll
  for (int i = 0; i < DH; ++i) op[i * DH] = st[i];
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int S, int H, cudaStream_t stream) {
  wkv6_kernel<DH><<<dim3((unsigned)(B * H)), dim3(DH), 0, stream>>>(
      r, k, v, w, u, s0, y, s_out, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int B, int S, int H, int DH,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto f = [](const void* p) { return (const float*)p; };
  switch (DH) {
    case 16: return launch<16>(f(r), f(k), f(v), f(w), f(u), f(s0), (float*)y, (float*)s_out, B, S, H, st);
    case 32: return launch<32>(f(r), f(k), f(v), f(w), f(u), f(s0), (float*)y, (float*)s_out, B, S, H, st);
    case 64: return launch<64>(f(r), f(k), f(v), f(w), f(u), f(s0), (float*)y, (float*)s_out, B, S, H, st);
    case 128: return launch<128>(f(r), f(k), f(v), f(w), f(u), f(s0), (float*)y, (float*)s_out, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
