// Segment-masked ragged paged attention for the flat [1, W] serving step.
//   q [W, Hq, dh]; k_pages, v_pages [P, T, Hkv, dh]; block_tables [B, MP];
//   dh is 64 or 128, each its own instance of the kernel (DH below).
//   out [W, Hq, dh].  Query i of row r at position q_pos[i] reads its row's
// pages bt[r, p] for p <= q_pos[i] / T (never past MP - 1), masks
// kv_pos <= q_pos[i], scales scores by dh^-0.5 and takes a softmax in
// float32 with l floored at 1e-30.  Padding positions are written as zeros.
//
// Replaces the Pallas kernel src/repro/kernels/ragged_attn/kernel.py:109
// (ragged_attention_kernel_call at :75, body _kernel at :34), whose grid
// (W, MP) walks one query position's pages in order, one page per step.
//
// Bound: bytes.  Each K/V page is needed once per (row, KV head); a full
// tile does about 48 operations per byte of K and V (a decode tile 3), far
// below the card's ridge of about 295.  At decode a call moves well under a
// megabyte, so what the bound leaves is latency: of the block-table read,
// the page loads and the merges.
// The design (kernels/ragged_attn/ops.py builds its plan on the host):
//
// - Tiles.  A tile is up to 16 consecutive flat positions of one row with
//   consecutive q_pos; its 16 x g query rows (g = Hq / Hkv) share every K/V
//   page load of one KV head.  Decode positions of different rows are
//   different tiles, so they run in parallel, never one after another.
// - Splits (flash-decoding).  Each tile's pages are cut into at most 8
//   ranges, one block each per KV head; the blocks of one tile form a
//   thread-block cluster.  Inside a block the 8 warps take one m16 fragment
//   of query rows each and the pages are dealt round robin to the groups of
//   warps that cover the tile's rows, so a decode block walks 8 pages at
//   once.  Every warp keeps an online softmax (m, l, acc) in registers;
//   the block merges its warps' partials in shared memory, then the cluster
//   merges its blocks' through distributed shared memory, in a fixed order
//   (no atomics: repeated calls are bit-identical).  A partial whose keys
//   were all masked carries m = -inf, l = 0 and weighs 0 in every merge.
// - Loads.  Each key and value row of one head is 2 dh contiguous bytes; a
//   warp loads a page's K and V straight into MMA fragments as 16-byte
//   vectors, ahead of use in registers (three pages at dh 64; one at 128,
//   where a page's K and V take 64 registers a thread and the output
//   fragment another 64), with no shared-memory staging or barrier on the
//   way.  Programmatic dependent launch: the
//   kernel waits on griddepcontrol before its first read.
// - bfloat16 on the tensor cores (mma.sync.m16n8k16): Q K^T with d permuted
//   the same way in both operands, so one 16-byte load gives two k16 steps;
//   P V with the scores' accumulators reused as the A fragment (rounded to
//   bfloat16) and the output's d permuted so that each thread's V fragment
//   is one 16-byte load per key.  Scores and softmax stay float32.
// - float32 on the CUDA cores in IEEE arithmetic (TF32 would change the
//   float32 drain's tokens), with the same tiles, splits and merges: two
//   lanes per query row, each a half of the page's keys, then of d.
// - The partial form (lse != nullptr), one rank's share of a flash-decode
//   across ranks whose pool is split by pages (models/attention.py): the
//   rank holds global pages [page_lo, page_lo + page_count) as its local
//   pages 0 .. page_count - 1.  Each block keeps, of its range of a row's
//   block table, the pages the rank holds (warp 0 compacts the list with
//   a ballot, beside each page's index in the table, which the causal mask
//   reads), so a rank reads only its own pages; the rest is the whole
//   form's arithmetic.  Each query row's float32 log-sum-exp m + log l is
//   written beside its output, which the ranks' combine weighs by; a row
//   with no key on the rank gives o = 0 and lse = -inf.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 16;            // page tokens: one k16 step of P V
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsMax = kWarps * 16;   // query rows per tile
constexpr int kMaxCluster = 8;    // portable cluster size: splits per tile
// pages in flight per warp (bfloat16): K and V of a page take DH / 2
// registers a thread, the output fragment DH / 2, the query DH / 4
template <int DH> constexpr int kAhead = DH == 64 ? 3 : 1;
constexpr int kItem = 6;          // ints per plan item (ops.py:RaggedPlan.items)

// Shared memory: each warp's partial (m, l, acc) for its 16 rows, then the
// block's (m, l) per row (its acc is merged into the slots of the first
// warps), then the page ids of the block's range, each one's index in the
// row's block table, and (the partial form) how many the rank holds.
template <int DH>
struct Smem {
  float acc[kWarps][16][DH];
  float m[kWarps][16];
  float l[kWarps][16];
  float bm[kRowsMax];
  float bl[kRowsMax];
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Where a warp's work lies: its slot's rows, the tile's query positions and
// the pages it walks (pages[it], it = first, first + stride, ... < count).
struct WarpJob {
  const int* pages;       // page ids of the block's range (shared memory)
  const int* pidx;        // each one's index in the row's block table
  int count, first, stride;
  int start, rows, g, q0; // tile: first flat position, query rows, group, q_pos
  int Hq, Hkv, h, f;      // f: the warp's m16 fragment of the tile's rows
};

// ------------------------------------------------------------ bfloat16

// Thread (g8, t4) = (lane / 4, lane % 4).  Q K^T: within each of the
// DH / 32 d chunks c, logical k 2t+e / 2t+8+e of k16 step s is physical d
// 32c + 8t + 4s + e / 32c + 8t + 4s + 2 + e in both operands, so a
// thread's 16-byte load at d = 32c + 8t of a query or key row feeds both
// steps.  P V: logical column g8 of output n8 tile j (NT = DH / 8 tiles)
// is physical d NT g8 + j, so a thread's B fragments for all the tiles
// come from NT / 8 16-byte loads at d = NT g8 of each of its keys 2t,
// 2t+1, 2t+8, 2t+9.
template <int DH>
__device__ void warp_partial(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                             const bf16* __restrict__ vp, const WarpJob& j,
                             Smem<DH>& sm, int slot) {
  constexpr int NC = DH / 32, NT = DH / 8, VU = NT / 8, A = kAhead<DH>;
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const float scale = rsqrtf((float)DH);
  const int64_t row_stride = (int64_t)j.Hkv * DH;     // one token of a page

  int qp[2];              // q_pos of query rows g8 and g8 + 8; -1: none
  uint4 qa[2][NC];        // [row half][d chunk]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = j.f * 16 + g8 + 8 * hh;
    qp[hh] = -1;
#pragma unroll
    for (int c = 0; c < NC; ++c) qa[hh][c] = make_uint4(0u, 0u, 0u, 0u);
    if (r < j.rows) {
      qp[hh] = j.q0 + r / j.g;
      const bf16* src = q + ((int64_t)(j.start + r / j.g) * j.Hq + j.h * j.g + r % j.g) * DH;
#pragma unroll
      for (int c = 0; c < NC; ++c) qa[hh][c] = ldg16(src + 32 * c + 8 * t4);
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;

  const int n_mine = j.count > j.first ? (j.count - j.first + j.stride - 1) / j.stride : 0;
  uint4 kb[A][2][NC], vb[A][4][VU];   // [key half][d chunk]; [key][d vector]
  auto load = [&](uint4 (&kx)[2][NC], uint4 (&vx)[4][VU], int n) {
    const int64_t page = j.pages[j.first + n * j.stride];
    const int64_t base = (page * kT * j.Hkv + j.h) * DH;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kx[kh][c] = ldg16(kp + base + (g8 + 8 * kh) * row_stride + 32 * c + 8 * t4);
    const int keys[4] = {2 * t4, 2 * t4 + 1, 2 * t4 + 8, 2 * t4 + 9};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < VU; ++u)
        vx[i][u] = ldg16(vp + base + keys[i] * row_stride + NT * g8 + 8 * u);
  };
  auto compute = [&](const uint4 (&kx)[2][NC], const uint4 (&vx)[4][VU], int n) {
    const int p = j.pidx[j.first + n * j.stride];
    float s[2][4];        // [key n8 tile][C fragment]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t a0[4] = {qa[0][c].x, qa[1][c].x, qa[0][c].y, qa[1][c].y};
      const uint32_t a1[4] = {qa[0][c].z, qa[1][c].z, qa[0][c].w, qa[1][c].w};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        repro::mma_16816(s[nt], a0, kx[nt][c].x, kx[nt][c].y);
        repro::mma_16816(s[nt], a1, kx[nt][c].z, kx[nt][c].w);
      }
    }
    // s[nt][e]: query row g8 + 8 (e / 2), key nt * 8 + 2 t4 + e % 2
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kv = p * kT + nt * 8 + 2 * t4 + e;
          float& x = s[nt][2 * hh + e];
          x = kv <= qp[hh] ? x * scale : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const bool dead = m_new == -INFINITY;    // every key so far masked
      alpha[hh] = dead ? 1.0f : expf(m[hh] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * hh + e];
          x = dead ? 0.0f : expf(x - m_new);
          sum += x;
        }
      l[hh] = l[hh] * alpha[hh] + sum;     // this thread's keys; summed at the end
      m[hh] = m_new;
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
      const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
      const int u = i >> 3, w = (i >> 1) & 3;   // d NT g8 + i: vector u, word w
      const uint32_t b0 = __byte_perm(word(vx[0][u], w), word(vx[1][u], w), sel);
      const uint32_t b1 = __byte_perm(word(vx[2][u], w), word(vx[3][u], w), sel);
      repro::mma_16816(o[i], pa, b0, b1);
    }
  };

#pragma unroll
  for (int b = 0; b < A; ++b)
    if (b < n_mine) load(kb[b], vb[b], b);
  for (int n0 = 0; n0 < n_mine; n0 += A) {
#pragma unroll
    for (int b = 0; b < A; ++b) {
      if (n0 + b < n_mine) {
        compute(kb[b], vb[b], n0 + b);
        if (n0 + b + A < n_mine) load(kb[b], vb[b], n0 + b + A);
      }
    }
  }

  // the slot: o[i][e] is row g8 + 8 (e / 2), d = NT (2 t4 + e % 2) + i, so
  // a thread holds d 2 NT t4 .. 2 NT t4 + 2 NT - 1 of its two rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int rr = g8 + 8 * hh;
    if (t4 == 0) {
      sm.m[slot][rr] = m[hh];
      sm.l[slot][rr] = lt;
    }
    float* dst = sm.acc[slot][rr] + 2 * NT * t4;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < NT; i += 4)
        *reinterpret_cast<float4*>(dst + NT * e + i) =
            make_float4(o[i][2 * hh + e], o[i + 1][2 * hh + e], o[i + 2][2 * hh + e],
                        o[i + 3][2 * hh + e]);
  }
}

// ------------------------------------------------------------ float32

// Lane (rr, kh) = (lane / 2, lane % 2): query row rr of the warp's 16, keys
// 8 kh .. 8 kh + 7 of each page for the scores, d (DH / 2) kh ..
// (DH / 2) kh + DH / 2 - 1 of the output.
template <int DH>
__device__ void warp_partial(const float* __restrict__ q, const float* __restrict__ kp,
                             const float* __restrict__ vp, const WarpJob& j,
                             Smem<DH>& sm, int slot) {
  constexpr int H = DH / 2;
  const int lane = threadIdx.x & 31, rr = lane >> 1, kh = lane & 1;
  const float scale = rsqrtf((float)DH);
  const int64_t row_stride = (int64_t)j.Hkv * DH;
  const int r = j.f * 16 + rr;
  int qp = -1;
  float qv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qv[d] = 0.0f;
  if (r < j.rows) {
    qp = j.q0 + r / j.g;
    const float* src = q + ((int64_t)(j.start + r / j.g) * j.Hq + j.h * j.g + r % j.g) * DH;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + d));
      qv[d] = v.x; qv[d + 1] = v.y; qv[d + 2] = v.z; qv[d + 3] = v.w;
    }
  }
  float m = -INFINITY, l = 0.0f, acc[H];
#pragma unroll
  for (int d = 0; d < H; ++d) acc[d] = 0.0f;

  for (int it = j.first; it < j.count; it += j.stride) {
    const int p = j.pidx[it];
    const int64_t base = ((int64_t)j.pages[it] * kT * j.Hkv + j.h) * DH;
    float s[8];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = 8 * kh + i;
      const float* kr = kp + base + key * row_stride;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(kr + d));
        dot = fmaf(qv[d], v.x, dot);
        dot = fmaf(qv[d + 1], v.y, dot);
        dot = fmaf(qv[d + 2], v.z, dot);
        dot = fmaf(qv[d + 3], v.w, dot);
      }
      s[i] = p * kT + key <= qp ? dot * scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const bool dead = m_new == -INFINITY;
    const float alpha = dead ? 1.0f : expf(m - m_new);
    float sum = 0.0f, other[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = dead ? 0.0f : expf(s[i] - m_new);
      sum += s[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) other[i] = __shfl_xor_sync(0xffffffffu, s[i], 1);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < H; ++d) acc[d] *= alpha;
#pragma unroll
    for (int key = 0; key < kT; ++key) {
      const float pk = (key >> 3) == kh ? s[key & 7] : other[key & 7];
      const float* vr = vp + base + key * row_stride + H * kh;
#pragma unroll
      for (int d = 0; d < H; d += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(vr + d));
        acc[d] = fmaf(pk, v.x, acc[d]);
        acc[d + 1] = fmaf(pk, v.y, acc[d + 1]);
        acc[d + 2] = fmaf(pk, v.z, acc[d + 2]);
        acc[d + 3] = fmaf(pk, v.w, acc[d + 3]);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  if (kh == 0) {
    sm.m[slot][rr] = m;
    sm.l[slot][rr] = l;
  }
  float* dst = sm.acc[slot][rr] + H * kh;
#pragma unroll
  for (int d = 0; d < H; d += 4)
    *reinterpret_cast<float4*>(dst + d) = make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
}

// ------------------------------------------------------------ the frame

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 u;
  u.x = pack_bf16(v.x, v.y);
  u.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// Merge n <= N partial softmaxes in order: top = max m, lsum = sum w l,
// a = sum w acc with w = exp(m - top), and w = 0 for a partial whose keys
// were all masked (m = -inf).  Every load is issued before the first sum,
// so the partials' latencies (distributed shared memory for a cluster)
// overlap.
template <int N, typename Load>
__device__ __forceinline__ void merge(int n, Load load, float& top, float& lsum,
                                      float4& a) {
  float ms[N], ls[N];
  float4 vs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ms[i] = -INFINITY;
    ls[i] = 0.0f;
    vs[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < n) load(i, ms[i], ls[i], vs[i]);
  }
  top = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) top = fmaxf(top, ms[i]);
  lsum = 0.0f;
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= n) break;
    const float w = ms[i] == -INFINITY ? 0.0f : expf(ms[i] - top);
    lsum += w * ls[i];
    a.x += w * vs[i].x; a.y += w * vs[i].y; a.z += w * vs[i].z; a.w += w * vs[i].w;
  }
}

// Grid (tiles * splits, Hkv), cluster (splits, 1, 1) if splits > 1, 8 warps.
// Block (x, h) takes plan item x (ops.py:plan_ragged): tile x / splits,
// pages [p_lo, p_hi) of its row, KV head h.  Warp w takes the tile's m16
// fragment w % frags and every groups-th page of the range from w / frags
// on (groups = 8 / frags); warps past groups * frags idle.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
ragged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ items, T* __restrict__ out,
                   float* __restrict__ lse, int splits, int Hq, int Hkv, int MP,
                   int page_lo, int page_count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  int* pages = reinterpret_cast<int*>(smem_raw + sizeof(Smem<DH>));
  int* pidx = pages + MP;
  int& kept = pidx[MP];   // the partial form: pages of the range the rank holds
  // launched as a programmatic dependent: wait here, before the first read,
  // until the previous kernel on the stream has finished and flushed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int* it = items + (int64_t)blockIdx.x * kItem;
  const int start = it[0], n = it[1], row = it[2], q0 = it[3];
  const int p_lo = it[4], p_hi = it[5];
  const int h = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int g = Hq / Hkv;
  const int rank = (int)(blockIdx.x % splits);   // the block's rank in its cluster

  if (row < 0) {          // padding: zeros (every block of the cluster returns here)
    const int vec = 16 / (int)sizeof(T), per_pos = g * DH / vec;
    for (int x = tid; x < n * per_pos; x += kThreads) {
      const int pos = x / per_pos;
      if (pos % splits != rank) continue;
      T* dst = out + ((int64_t)(start + pos) * Hq + h * g) * DH + (x % per_pos) * vec;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (lse != nullptr)
      for (int x = tid; x < n * g; x += kThreads)
        if ((x / g) % splits == rank)
          lse[(int64_t)(start + x / g) * Hq + h * g + x % g] = -INFINITY;
    return;
  }

  const int rows = n * g, frags = (rows + 15) / 16, groups = kWarps / frags;
  if (rows > kRowsMax) __trap();   // plan_ragged cuts tiles to kRowsMax rows
  int count = p_hi - p_lo;
  if (lse == nullptr) {
    for (int x = tid; x < count; x += kThreads) {
      pages[x] = bt[(int64_t)row * MP + p_lo + x];
      pidx[x] = p_lo + x;
    }
  } else if (warp == 0) {
    // the partial form: the range's pages the rank holds, in table order,
    // as local page ids (a ballot a 32-page chunk)
    const int lane = tid & 31;
    int kept_n = 0;
    for (int c0 = 0; c0 < count; c0 += 32) {
      const int x = c0 + lane;
      int id = -1;
      if (x < count) {
        id = bt[(int64_t)row * MP + p_lo + x] - page_lo;
        if (id < 0 || id >= page_count) id = -1;
      }
      const unsigned held = __ballot_sync(0xffffffffu, id >= 0);
      if (id >= 0) {
        const int at = kept_n + __popc(held & ((1u << lane) - 1u));
        pages[at] = id;
        pidx[at] = p_lo + x;
      }
      kept_n += __popc(held);
    }
    if (lane == 0) kept = kept_n;
  }
  __syncthreads();
  if (lse != nullptr) count = kept;
  if (warp < groups * frags) {
    const WarpJob job{pages, pidx, count, warp / frags, groups, start, rows, g, q0,
                      Hq, Hkv, h, warp % frags};
    warp_partial(q, kp, vp, job, sm, warp);
  }
  __syncthreads();

  // merge the warps of each fragment in page-group order: (m, l) per row
  // into bm/bl, acc into the slot of group 0 (slot f); with one split, finish
  const int elems = rows * (DH / 4);
  for (int x = tid; x < elems; x += kThreads) {
    const int r = x / (DH / 4), d = (x % (DH / 4)) * 4;
    const int f = r / 16, rr = r % 16;
    float top, lsum;
    float4 a;
    merge<kWarps>(groups, [&](int gr, float& m, float& l, float4& v) {
      const int slot = gr * frags + f;
      m = sm.m[slot][rr];
      l = sm.l[slot][rr];
      v = *reinterpret_cast<const float4*>(sm.acc[slot][rr] + d);
    }, top, lsum, a);
    if (splits == 1) {
      const float inv = 1.0f / fmaxf(lsum, 1e-30f);
      const int64_t o = (int64_t)(start + r / g) * Hq + h * g + r % g;
      store4(out + o * DH + d, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
      if (lse != nullptr && d == 0) lse[o] = lsum > 0.0f ? top + logf(lsum) : -INFINITY;
    } else {
      *reinterpret_cast<float4*>(sm.acc[f][rr] + d) = a;
      if (d == 0) {
        sm.bm[r] = top;
        sm.bl[r] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // merge the cluster's blocks in rank (page) order through distributed
  // shared memory; each block finishes a share of the tile's rows
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int lo = (int)((int64_t)rank * elems / splits);
  const int hi = (int)((int64_t)(rank + 1) * elems / splits);
  for (int x = lo + tid; x < hi; x += kThreads) {
    const int r = x / (DH / 4), d = (x % (DH / 4)) * 4;
    const int f = r / 16, rr = r % 16;
    float top, lsum;
    float4 a;
    merge<kMaxCluster>(splits, [&](int s, float& m, float& l, float4& v) {
      const Smem<DH>* o = cluster.map_shared_rank(&sm, s);
      m = o->bm[r];
      l = o->bl[r];
      v = *reinterpret_cast<const float4*>(o->acc[f][rr] + d);
    }, top, lsum, a);
    const float inv = 1.0f / fmaxf(lsum, 1e-30f);
    const int64_t o = (int64_t)(start + r / g) * Hq + h * g + r % g;
    store4(out + o * DH + d, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    if (lse != nullptr && d == 0) lse[o] = lsum > 0.0f ? top + logf(lsum) : -INFINITY;
  }
  cluster.sync();         // keep every partial until the cluster has read it
}

template <typename T, int DH>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* items, void* out, float* lse, int n_items, int splits,
           int Hq, int Hkv, int MP, int page_lo, int page_count,
           cudaStream_t stream) {
  static bool configured[repro::kMaxDevices] = {};
  const size_t smem = sizeof(Smem<DH>) + (2 * (size_t)MP + 1) * sizeof(int);
  if (smem > (size_t)repro::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n_items == 0) return 0;
  if (smem > 48 * 1024)
    if (int e = repro::opt_in_smem(ragged_attn_kernel<T, DH>, configured)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_items, (unsigned)Hkv, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // may start while the previous kernel on the stream drains (the kernel
  // waits on griddepcontrol before it reads); a cluster only to split pages
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = (unsigned)splits;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ragged_attn_kernel<T, DH>, (const T*)q,
                                     (const T*)kp, (const T*)vp, (const int*)bt,
                                     (const int*)items, (T*)out, lse, splits, Hq,
                                     Hkv, MP, page_lo, page_count);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch(const void* q, const void* kp, const void* vp, const void* bt,
             const void* items, void* out, float* lse, int dtype, int n_items,
             int splits, int Hq, int Hkv, int MP, int page_lo, int page_count,
             cudaStream_t stream) {
  REPRO_DISPATCH(dtype, T,
                 return launch<T, DH>(q, kp, vp, bt, items, out, lse, n_items,
                                      splits, Hq, Hkv, MP, page_lo, page_count,
                                      stream));
  return (int)cudaErrorInvalidValue;  // unreachable: every dtype returns
}

}  // namespace

// items [n_items, 6] int32 and splits: the plan of kernels/ragged_attn/ops.py
// (n_items = tiles * splits); pages of kT tokens and heads of dh (64 or 128).
// lse [W, Hq] float32, or null: the partial form over the global pages
// [page_lo, page_lo + page_count), which the pools hold as pages 0 ..
// page_count - 1 (the whole form ignores both).
extern "C" int repro_ragged_attn(const void* q, const void* k_pages,
                                 const void* v_pages, const void* block_tables,
                                 const void* items, void* out, void* lse,
                                 int dtype, int dh, int n_items, int splits,
                                 int Hq, int Hkv, int MP, int page_lo,
                                 int page_count, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || splits < 1 || splits > kMaxCluster ||
      n_items % splits != 0 || MP < 1 || (lse != nullptr && page_count < 0) ||
      (((uintptr_t)q | (uintptr_t)k_pages | (uintptr_t)v_pages | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (Hq / Hkv > kRowsMax) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dh == 64)
    return dispatch<64>(q, k_pages, v_pages, block_tables, items, out, l, dtype,
                        n_items, splits, Hq, Hkv, MP, page_lo, page_count, s);
  if (dh == 128)
    return dispatch<128>(q, k_pages, v_pages, block_tables, items, out, l, dtype,
                         n_items, splits, Hq, Hkv, MP, page_lo, page_count, s);
  return (int)cudaErrorInvalidValue;
}
