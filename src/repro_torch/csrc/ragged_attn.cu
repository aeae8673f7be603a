// Segment-masked ragged paged attention for the flat [1, W] serving step.
//   q [W, Hq, dh]; k_pages, v_pages [P, T, Hkv, dh]; block_tables [B, MP];
//   row_ids [W] (-1 = padding, clamped to row 0; its output is garbage the
//   caller discards); q_pos [W].  out [W, Hq, dh].
// Query i reads its own row's pages bt[row_ids[i], p] for p <= q_pos[i] / T
// (never past MP - 1), masks kv_pos <= q_pos[i], scales scores by dh^-0.5,
// and runs an online softmax in float32 with l floored at 1e-30.
//
// Replaces the Pallas kernel src/repro/kernels/ragged_attn/kernel.py:109
// (ragged_attention_kernel_call at :75, body _kernel at :34).  The TPU grid
// is (W, MP) with the page id prefetched as a scalar and one page loaded per
// grid step for each query position.  Here one block serves one (flat
// position, KV head): the g = Hq / Hkv query heads of that KV head share
// every K/V page load, the block reads its block-table entries itself, and
// the page loop stops at the query's own last page instead of walking all MP.
// K and V rows are padded by one float in shared memory so the per-key dot
// products of a warp fall in different banks.
//
// Bound: bytes (each page of K and V is read once per query position and KV
// head; the arithmetic is g * T * dh multiply-adds per page).  Consecutive
// positions of one prefill segment read the same pages again; a later PR
// should give one block a whole segment (or a tile of its positions) so a
// page is loaded once for all of them, and load pages with cp.async / TMA
// ahead of use.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ row_ids, const int* __restrict__ q_pos,
                   T* __restrict__ out, int Hq, int Hkv, int dh, int Tp, int MP) {
  extern __shared__ float smem[];
  const int g = Hq / Hkv, pitch = dh + 1;
  float* qs = smem;                  // [g][dh]
  float* ks = qs + g * dh;           // [T][dh + 1]
  float* vs = ks + Tp * pitch;       // [T][dh + 1]
  float* ss = vs + Tp * pitch;       // [g][T] scores, then probabilities
  float* acc = ss + g * Tp;          // [g][dh]
  float* ms = acc + g * dh;          // [g] running max
  float* ls = ms + g;                // [g] running denominator
  float* al = ls + g;                // [g] rescale factor of this page

  const int i = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int row = max(row_ids[i], 0);
  const int qp = q_pos[i];
  const float scale = rsqrtf((float)dh);

  for (int x = tid; x < g * dh; x += kThreads) {
    qs[x] = repro::to_float(q[((int64_t)i * Hq + h * g) * dh + x]);
    acc[x] = 0.0f;
  }
  if (tid < g) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }
  const int last = qp < 0 ? -1 : min(qp / Tp, MP - 1);
  for (int p = 0; p <= last; ++p) {
    const int64_t page = bt[(int64_t)row * MP + p];
    __syncthreads();  // the previous page's readers are done with ks/vs/ss
    for (int x = tid; x < Tp * dh; x += kThreads) {
      const int t = x / dh, d = x % dh;
      const int64_t src = ((page * Tp + t) * Hkv + h) * dh + d;
      ks[t * pitch + d] = repro::to_float(kp[src]);
      vs[t * pitch + d] = repro::to_float(vp[src]);
    }
    __syncthreads();
    for (int x = tid; x < g * Tp; x += kThreads) {
      const int gi = x / Tp, t = x % Tp;
      float s = -INFINITY;
      if (p * Tp + t <= qp) {
        const float* qr = qs + gi * dh;
        const float* kr = ks + t * pitch;
        float dot = 0.0f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      ss[x] = s;
    }
    __syncthreads();
    if (tid < g) {
      float* sr = ss + tid * Tp;
      const float m_prev = ms[tid];
      float m_new = m_prev;
      for (int t = 0; t < Tp; ++t) m_new = fmaxf(m_new, sr[t]);
      const float alpha = isfinite(m_new) ? expf(m_prev - m_new) : 0.0f;
      float sum = 0.0f;
      for (int t = 0; t < Tp; ++t) {
        const float e = (p * Tp + t <= qp) ? expf(sr[t] - m_new) : 0.0f;
        sr[t] = e;
        sum += e;
      }
      ms[tid] = m_new;
      ls[tid] = ls[tid] * alpha + sum;
      al[tid] = alpha;
    }
    __syncthreads();
    for (int x = tid; x < g * dh; x += kThreads) {
      const int gi = x / dh, d = x % dh;
      const float* pr = ss + gi * Tp;
      float v = acc[x] * al[gi];
      for (int t = 0; t < Tp; ++t) v = fmaf(pr[t], vs[t * pitch + d], v);
      acc[x] = v;
    }
  }
  __syncthreads();
  for (int x = tid; x < g * dh; x += kThreads) {
    const float l = fmaxf(ls[x / dh], 1e-30f);
    out[((int64_t)i * Hq + h * g) * dh + x] = repro::from_float<T>(acc[x] / l);
  }
}

}  // namespace

extern "C" int repro_ragged_attn(const void* q, const void* k_pages,
                                 const void* v_pages, const void* block_tables,
                                 const void* row_ids, const void* q_pos,
                                 void* out, int dtype, int W, int Hq, int Hkv,
                                 int dh, int Tp, int MP, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int g = Hq / Hkv;
  size_t smem = sizeof(float) *
      ((size_t)2 * g * dh + (size_t)2 * Tp * (dh + 1) + (size_t)g * Tp + 3 * g);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (W == 0) return 0;
  dim3 grid(W, Hkv);
  REPRO_DISPATCH(dtype, T,
    ragged_attn_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages,
        (const int*)block_tables, (const int*)row_ids, (const int*)q_pos,
        (T*)out, Hq, Hkv, dh, Tp, MP));
  return (int)cudaGetLastError();
}
