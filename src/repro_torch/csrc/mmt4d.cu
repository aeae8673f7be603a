// mmt4d: packed matmul with a fused epilogue,
//   C_pack[mo, no, :, :] = act(sum_ko A_pack[mo, ko] @ B_pack[no, ko]^T + bias[no])
// A_pack [Mo, Ko, m_r, k_r], B_pack [No, Ko, n_r, k_r], bias [No, n_r] (optional),
// C_pack [Mo, No, m_r, n_r]; float32 accumulation, bias and activation applied
// in float32, then one cast to the element type (as the TPU kernel does).
//
// Replaces the Pallas kernel src/repro/kernels/mmt4d/kernel.py:113
// (mmt4d_kernel_call at :68, body _kernel at :43).  The TPU grid walks K_o
// sequentially and carries the sum in a VMEM scratch tile; GPU blocks run in
// no order, so each block loops over its own range of K_o.
//
// Bound: bytes at every width of the serving path.  A decode linear reads
// each weight once per step (M_o = 1); even the widest flat step (W = 512)
// does about 225 flop per byte for the gate linear, below the H100's ridge
// of about 295.  At decode sizes (0.1-2 MB a call) what the bound leaves is
// the latency of a few dependent loads and MMAs, so the design keeps every
// chain short, with the tensor cores keeping the arithmetic off it:
//
// - Swap-AB.  Each block computes C_tile^T[n, m] = B_tile[n, k] A_tile[m, k]^T:
//   `rows` (16..64) weight rows fill the MMA's M, the activation tile's
//   tm * m_r rows fill its N (8..32).  Both packed tiles are K-major with
//   k_r contiguous, so both feed mma.sync.m16n8k16 without a transpose.
//   mma.sync and not wgmma: every call is bound by bytes and the activation
//   operand is 8-32 wide, so wgmma's higher rate (it needs 64-row M tiles,
//   operands in shared memory and a warpgroup per tile) buys nothing until M
//   is in the thousands.  Eight warps per block split the K chunks among
//   themselves: a decode block has only a few MMAs to do, and what costs is
//   the latency of each dependent load and MMA.
// - Split-K in a cluster, only where it pays.  A decode linear has 2-12
//   weight tiles; kernels/mmt4d/ops.py:pick_split gives it blocks of 16
//   rows over the whole K range (16-96 blocks, no cluster), and splits K
//   only where a warp would otherwise walk more than 4 K chunks (the down
//   projection, K_o = 12: 2 splits).  The blocks of one split output slice
//   form a thread-block cluster; each leaves its float32 partials (one per
//   K-warp) in its own shared memory, and after cluster.sync() every block
//   sums a share of the slice over the cluster's partials, read through
//   distributed shared memory in (split, K-warp) order.  No atomics:
//   repeated calls are bit-identical.  On the H100 a cluster's launch and
//   barriers cost more than the extra blocks gain at the other decode
//   shapes (PERF.md).
// - Launch.  Programmatic dependent launch: the kernel may be scheduled
//   while the previous kernel on the stream drains and waits on
//   griddepcontrol before its first read.
// - Copies.  Each warp loads its MMA fragments straight from global memory
//   in 16-byte vectors, a few 32-wide K chunks ahead of its MMAs, with no
//   shared-memory staging, barrier or ldmatrix on the way: every packed tile
//   is one contiguous run of memory (which is what packing buys), so a
//   warp's load covers 8 rows x 64 contiguous bytes.  A first version staged
//   the tiles through a cp.async ring in shared memory and read them with
//   ldmatrix; on the H100 it was bound by the latency of that chain, not by
//   bytes (PERF.md).
// - Epilogue.  Bias and activation in float32 on the summed partials, one
//   cast, and a store along n_r (the partials are kept transposed, [m][n],
//   in shared memory, so the store is coalesced).
// - Unpacked store.  Where a linear's result leaves the packed domain
//   (core/linear.py), the same epilogue writes C[.., m, n] row-major with
//   the tile padding dropped instead of C_pack, so no unpack kernel
//   follows.  Only the address and a mask change (the bf16 kernel's note
//   below), so the values are the packed store's, bit for bit.
//
// float32 stays on the CUDA cores in IEEE arithmetic (TF32 tensor cores
// would change the float32 results): one block per output tile loops over
// K_o, staging the A and B tiles in shared memory, as the first port did.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

enum Act : int { kNone = 0, kGelu = 1, kSilu = 2, kRelu = 3, kTanh = 4 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kGelu: {  // tanh approximation, as jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kSilu: return x / (1.0f + expf(-x));
    case kRelu: return fmaxf(x, 0.0f);
    case kTanh: return tanhf(x);
    default: return x;
  }
}

// ---------------------------------------------------------------- float32

constexpr int kF32Threads = 256;
constexpr int kMaxPerThread = 16;   // m_r * n_r <= 4096

// out_cols > 0: C written unpacked, with the bf16 kernel's index map
__global__ void __launch_bounds__(kF32Threads)
mmt4d_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ bias, float* __restrict__ c,
                 int64_t No, int64_t Ko, int m_r, int n_r, int k_r, int act,
                 int64_t out_rows, int64_t out_cols, int64_t mo_per_batch) {
  extern __shared__ float smem[];
  float* As = smem;                    // [m_r][k_r]
  float* Bs = smem + m_r * k_r;        // [n_r][k_r + 1]
  const int bp = k_r + 1;
  const int64_t mo = blockIdx.x / No, no = blockIdx.x % No;
  const int tid = threadIdx.x;
  const int outs = m_r * n_r;

  float acc[kMaxPerThread];
#pragma unroll
  for (int q = 0; q < kMaxPerThread; ++q) acc[q] = 0.0f;

  const int a_tile = m_r * k_r, b_tile = n_r * k_r;
  for (int64_t ko = 0; ko < Ko; ++ko) {
    const float* at = a + (mo * Ko + ko) * a_tile;
    const float* bt = b + (no * Ko + ko) * b_tile;
    for (int i = tid; i < a_tile; i += kF32Threads) As[i] = at[i];
    for (int i = tid; i < b_tile; i += kF32Threads)
      Bs[(i / k_r) * bp + i % k_r] = bt[i];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxPerThread; ++q) {
      const int o = tid + q * kF32Threads;
      if (o < outs) {
        const float* ar = As + (o / n_r) * k_r;
        const float* br = Bs + (o % n_r) * bp;
        float s = acc[q];
        for (int kk = 0; kk < k_r; ++kk) s = fmaf(ar[kk], br[kk], s);
        acc[q] = s;
      }
    }
    __syncthreads();
  }

  // output (mi, n) of the tile goes to dst[mi * pitch + n] where mi <
  // rows_left and n < cols_left: C_pack's tile, or the tile's place in the
  // unpacked C (one form for both, so the loop below has no branch on it)
  float* dst = c + (mo * No + no) * outs;
  int64_t pitch = n_r, rows_left = m_r, cols_left = n_r;
  if (out_cols > 0) {
    const int64_t bb = mo / mo_per_batch, r0 = (mo - bb * mo_per_batch) * m_r;
    dst = c + (bb * out_rows + r0) * out_cols + no * n_r;
    pitch = out_cols;
    rows_left = out_rows - r0;
    cols_left = out_cols - no * n_r;
  }
#pragma unroll
  for (int q = 0; q < kMaxPerThread; ++q) {
    const int o = tid + q * kF32Threads;
    const int mi = o / n_r, n = o - mi * n_r;
    if (o < outs && mi < rows_left && n < cols_left) {
      float v = acc[q];
      if (bias != nullptr) v += bias[no * n_r + n];
      dst[mi * pitch + n] = activate(v, act);
    }
  }
}

int launch_f32(const void* a, const void* b, const void* bias, void* c,
               int64_t Mo, int64_t No, int64_t Ko, int m_r, int n_r, int k_r,
               int act, int64_t out_rows, int64_t out_cols, int64_t mo_per_batch,
               cudaStream_t stream) {
  if ((int64_t)m_r * n_r > (int64_t)kF32Threads * kMaxPerThread)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)m_r * k_r + (size_t)n_r * (k_r + 1));
  if (smem > (size_t)repro::kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured[repro::kMaxDevices] = {};
  if (int e = repro::opt_in_smem(mmt4d_f32_kernel, configured)) return e;
  if (Mo * No == 0) return 0;
  mmt4d_f32_kernel<<<(unsigned)(Mo * No), kF32Threads, smem, stream>>>(
      (const float*)a, (const float*)b, (const float*)bias, (float*)c, No, Ko,
      m_r, n_r, k_r, act, out_rows, out_cols, mo_per_batch);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 32;     // tm * m_r: the MMA's N per block
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr int kPadP = 4;         // float padding per partial row

// Grid (No * n_r / rows, ceil(Mo / tm), splits), cluster (1, 1, splits) if splits > 1, 8
// warps.  Block (x, y, z) computes weight rows [r0, r0 + rows) of output
// tile `no`, for mo tiles [mo0, mo0 + tm), over K tiles [z * Ko / splits,
// (z + 1) * Ko / splits); kernels/mmt4d/ops.py:Split mirrors this
// arithmetic.  Warp w takes the 16 rows (w % (rows / 16)) and every KW-th
// 32-wide K chunk of the block's range from chunk w / (rows / 16) on, KW =
// 8 / (rows / 16).  NT (a power of two) is the 8-wide MMA tiles per warp;
// tiles past the block's tm * m_r activation rows are fed zeros and dropped.
//
// Operands go from global memory straight into MMA fragments.  Within a
// 32-wide chunk, k is permuted the same way for both operands: thread
// (g, t) = (lane / 4, lane % 4) loads 8 contiguous k (16 bytes) at 8 t of
// weight rows g and g + 8 and of activation row g of each 8-wide tile, and
// logical k 2t+e, 2t+8+e of MMA step s in {0, 1} is physical k 8t+4s+e,
// 8t+4s+2+e.  A warp's load touches 8 rows x 64 contiguous bytes: whole
// 32-byte sectors.  Loads run P chunks ahead of the MMAs in registers.
//
// UNPACKED (out_cols > 0; a template parameter, so the packed store compiles
// as it would alone): the 4 outputs of a thread at activation row m,
// weight row n of tile (mo, no) go to C[b, mo_b * m_r + m % m_r, no * n_r +
// n], b = mo / mo_per_batch, mo_b = mo % mo_per_batch, and only where that
// row is below out_rows and that column below out_cols (a partial last
// tile: Q's N = 576 leaves 64 of tile 4's 128 columns); as one 8-byte
// store where out_cols % 4 == 0 and C is 8-byte aligned, else one element
// at a time.  kernels/mmt4d/ops.py:Split.stores mirrors this map.
template <int NT, bool UNPACKED>
__global__ void __launch_bounds__(kThreads)
mmt4d_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                  const bf16* __restrict__ bias, bf16* __restrict__ c,
                  int Mo, int No, int Ko, int m_r, int n_r, int k_r, int act,
                  int rows, int tm, int splits, int out_rows, int out_cols,
                  int mo_per_batch) {
  constexpr int P = NT <= 2 ? 4 : 2;   // chunks in flight (ops.py CHUNKS_IN_FLIGHT)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // launched as a programmatic dependent: wait here, before the first read,
  // until the previous kernel on the stream has finished and flushed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();   // one block if splits == 1
  const int split = splits > 1 ? (int)cluster.block_rank() : 0;
  const int per_tile = n_r / rows;
  const int no = blockIdx.x / per_tile;
  const int r0 = (blockIdx.x % per_tile) * rows;
  const int mo0 = blockIdx.y * tm;
  const int tmv = min(tm, Mo - mo0);    // the last group may hold fewer tiles
  const int cols = tmv * m_r;           // this block's valid MMA N
  const int kb = (int)((int64_t)split * Ko / splits);
  const int nk = (int)((int64_t)(split + 1) * Ko / splits) - kb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int groups = rows / 16, kw_n = kWarps / groups;
  const int wr = warp % groups, kw = warp / groups;
  const int cpt = (k_r + 31) / 32;      // chunks per K tile
  const int nq_all = nk * cpt;
  const int nq = nq_all > kw ? (nq_all - kw + kw_n - 1) / kw_n : 0;

  // weight rows g and g + 8 of this warp, at tile (no, kb), k = 8 t
  const bf16* wsrc = b + (((int64_t)no * Ko + kb) * n_r + r0 + wr * 16 + g) * k_r + 8 * t4;
  const int64_t w_tile = (int64_t)n_r * k_r;
  const int64_t x_tile = (int64_t)m_r * k_r;

  uint4 wv[P][2], xv[P][NT];
  // chunk q of this warp -> registers
  auto load = [&](uint4 (&w)[2], uint4 (&x)[NT], int q) {
    const int qq = kw + q * kw_n;
    const int ti = qq / cpt, ch = qq - ti * cpt;
    const int k0 = ch * 32;
    const bool full = k0 + 32 <= k_r;   // else a 16-wide tail: zeros past it
    const bf16* wp = wsrc + ti * w_tile + k0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* p = wp + h * 8 * k_r;
      if (full) {
        w[h] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p - 4 * t4));
        w[h] = make_uint4(v.x, v.y, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = j * 8 + g;          // activation row in the block
      x[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m < cols) {
        const int tj = (j * 8) / m_r, mi = m - tj * m_r;
        const bf16* p = a + ((int64_t)(mo0 + tj) * Ko + kb + ti) * x_tile +
                        (int64_t)mi * k_r + k0;
        if (full) {
          x[j] = __ldg(reinterpret_cast<const uint4*>(p + 8 * t4));
        } else {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + 4 * t4));
          x[j] = make_uint4(v.x, v.y, 0u, 0u);
        }
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  auto mmas = [&](const uint4 (&w)[2], const uint4 (&x)[NT]) {
    const uint32_t a0[4] = {w[0].x, w[1].x, w[0].y, w[1].y};   // step s = 0
    const uint32_t a1[4] = {w[0].z, w[1].z, w[0].w, w[1].w};   // step s = 1
#pragma unroll
    for (int j = 0; j < NT; ++j) repro::mma_16816(acc[j], a0, x[j].x, x[j].y);
#pragma unroll
    for (int j = 0; j < NT; ++j) repro::mma_16816(acc[j], a1, x[j].z, x[j].w);
  };

#pragma unroll
  for (int p = 0; p < P; ++p)
    if (p < nq) load(wv[p], xv[p], p);
  for (int q0 = 0; q0 < nq; q0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (q0 + p < nq) {
        mmas(wv[p], xv[p]);
        if (q0 + p + P < nq) load(wv[p], xv[p], q0 + p + P);
      }
    }
  }

  // each warp's float32 partial, transposed to [m][n], in region kw (row
  // stride rows + 4: the fragment writes hit 32 different banks)
  float* part = reinterpret_cast<float*>(smem_raw);
  const int ps = rows + kPadP;
  const int region = NT * 8 * ps;
  {
    float* pw = part + kw * region;
    const int n = wr * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = j * 8 + 2 * t4;
      if (m < cols) {
        pw[m * ps + n] = acc[j][0];
        pw[(m + 1) * ps + n] = acc[j][1];
        pw[m * ps + n + 8] = acc[j][2];
        pw[(m + 1) * ps + n + 8] = acc[j][3];
      }
    }
  }
  if (splits > 1) cluster.sync(); else __syncthreads();

  // each block of the cluster finishes a share of the slice: sum the
  // partials in (split, k-warp) order, bias and activation in float32, one
  // cast, 4 outputs per thread along n_r
  const int vpr = rows / 4;
  const int items = cols * vpr;
  const int lo = (int)((int64_t)split * items / splits);
  const int hi = (int)((int64_t)(split + 1) * items / splits);
  for (int it = lo + tid; it < hi; it += kThreads) {
    const int m = it / vpr, q = it - m * vpr;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < splits; ++s) {
      const float* ps_s = (splits > 1 ? cluster.map_shared_rank(part, s) : part) +
                          m * ps + q * 4;
      for (int g = 0; g < kw_n; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(ps_s + g * region);
        v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
      }
    }
    const int n = r0 + q * 4;
    float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (bias != nullptr) o[e] += __bfloat162float(bias[(int64_t)no * n_r + n + e]);
      o[e] = activate(o[e], act);
    }
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 o23 = __floats2bfloat162_rn(o[2], o[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&o01);
    packed.y = *reinterpret_cast<const uint32_t*>(&o23);
    const int mo = mo0 + m / m_r, mi = m % m_r;
    if constexpr (UNPACKED) {
      const int bb = mo / mo_per_batch;
      const int r = (mo - bb * mo_per_batch) * m_r + mi, col = no * n_r + n;
      if (r < out_rows && col < out_cols) {             // else tile padding
        bf16* dst = c + ((int64_t)bb * out_rows + r) * out_cols + col;
        if (out_cols % 4 == 0 && ((uintptr_t)c & 7) == 0) {
          *reinterpret_cast<uint2*>(dst) = packed;
        } else {
          const bf16 e4[4] = {o01.x, o01.y, o23.x, o23.y};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < out_cols) dst[e] = e4[e];
        }
      }
    } else {
      *reinterpret_cast<uint2*>(c + (((int64_t)mo * No + no) * m_r + mi) * n_r + n) = packed;
    }
  }
  if (splits > 1) cluster.sync();       // keep every partial until all are read
}

// the NT of a block with `cols` activation rows: the power of two >= cols / 8
int nt_of(int cols) {
  int nt = 1;
  while (nt * 8 < cols) nt *= 2;
  return nt;
}

// shared memory of a block: the float32 partial of each K-warp
size_t smem_bf16(int rows, int cols) {
  return (size_t)(kWarps / (rows / 16)) * nt_of(cols) * 8 * (rows + kPadP) * sizeof(float);
}

template <int NT, bool UNPACKED>
int launch_nt(const void* a, const void* b, const void* bias, void* c,
              int64_t Mo, int64_t No, int64_t Ko, int m_r, int n_r, int k_r,
              int act, int rows, int tm, int splits, int64_t out_rows,
              int64_t out_cols, int64_t mo_per_batch, size_t smem,
              cudaStream_t stream) {
  static bool configured[repro::kMaxDevices] = {};
  if (int e = repro::opt_in_smem(mmt4d_bf16_kernel<NT, UNPACKED>, configured)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(No * (n_r / rows)), (unsigned)((Mo + tm - 1) / tm),
                     (unsigned)splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // may start while the previous kernel on the stream drains (the kernel
  // waits on griddepcontrol before it reads); a cluster only to split K
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = (unsigned)splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, mmt4d_bf16_kernel<NT, UNPACKED>, (const bf16*)a, (const bf16*)b,
      (const bf16*)bias, (bf16*)c, (int)Mo, (int)No, (int)Ko, m_r, n_r, k_r, act,
      rows, tm, splits, (int)out_rows, (int)out_cols, (int)mo_per_batch);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_bf16(const void* a, const void* b, const void* bias, void* c,
                int64_t Mo, int64_t No, int64_t Ko, int m_r, int n_r, int k_r,
                int act, int rows, int tm, int splits, int64_t out_rows,
                int64_t out_cols, int64_t mo_per_batch, cudaStream_t stream) {
  const bool unpacked = out_cols > 0;
  if (m_r % 8 != 0 || k_r % 16 != 0 || n_r % 64 != 0 ||
      (rows != 16 && rows != 32 && rows != 64) || n_r % rows != 0 ||
      tm < 1 || (int64_t)tm * m_r > kMaxCols || splits < 1 ||
      splits > kMaxCluster || splits > Ko ||
      Mo > INT32_MAX || Ko > INT32_MAX || No * (n_r / rows) > INT32_MAX ||
      (Mo + tm - 1) / tm > 65535 ||
      (((uintptr_t)a | (uintptr_t)b | (unpacked ? 0 : (uintptr_t)c)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bf16(rows, tm * m_r);
  if (smem > (size_t)repro::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (Mo * No == 0) return 0;
  switch (nt_of(tm * m_r)) {
#define REPRO_NT(N)                                                          \
    case N:                                                                  \
      return (unpacked ? launch_nt<N, true> : launch_nt<N, false>)(          \
          a, b, bias, c, Mo, No, Ko, m_r, n_r, k_r, act, rows, tm, splits,     \
          out_rows, out_cols, mo_per_batch, smem, stream);
    REPRO_NT(1) REPRO_NT(2) REPRO_NT(4)
#undef REPRO_NT
    default: return (int)cudaErrorInvalidValue;
  }
}

// The unpacked extent, when C is written unpacked: out_cols > 0 columns
// (N), out_rows rows (m) per batch element, and the M_o of one batch
// element; the folded Mo holds Mo / mo_per_batch batch elements.
bool unpacked_extent_ok(int64_t Mo, int64_t No, int m_r, int n_r,
                        int64_t out_rows, int64_t out_cols, int64_t mo_per_batch) {
  if (out_cols == 0) return out_rows == 0 && mo_per_batch == 0;
  return out_cols > 0 && out_cols <= No * n_r && mo_per_batch > 0 &&
         Mo % mo_per_batch == 0 && out_rows >= 0 &&
         out_rows <= mo_per_batch * m_r && (Mo / mo_per_batch) * out_rows <= INT32_MAX &&
         out_cols <= INT32_MAX;
}

}  // namespace

// rows, tm, splits: the bfloat16 decomposition picked by
// kernels/mmt4d/ops.py:pick_split (ignored for float32).  out_rows,
// out_cols, mo_per_batch: the unpacked store (all 0: C is C_pack).
extern "C" int repro_mmt4d(const void* a, const void* b, const void* bias,
                           void* c, int dtype, int64_t Mo, int64_t No,
                           int64_t Ko, int m_r, int n_r, int k_r, int act,
                           int rows, int tm, int splits, int64_t out_rows,
                           int64_t out_cols, int64_t mo_per_batch, void* stream) {
  if (!unpacked_extent_ok(Mo, No, m_r, n_r, out_rows, out_cols, mo_per_batch))
    return (int)cudaErrorInvalidValue;
  if (dtype == repro::kF32)
    return launch_f32(a, b, bias, c, Mo, No, Ko, m_r, n_r, k_r, act, out_rows,
                      out_cols, mo_per_batch, (cudaStream_t)stream);
  if (dtype == repro::kBF16)
    return launch_bf16(a, b, bias, c, Mo, No, Ko, m_r, n_r, k_r, act, rows,
                       tm, splits, out_rows, out_cols, mo_per_batch,
                       (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
