// mmt4d's two gradient products, on packed operands:
//
//   dgrad  dA_pack[mo, ko, i, k] = sum_{no, j} dZ[mo, no, i, j] B_pack[no, ko, j, k]
//   wgrad  dB_pack[no, ko, j, k] = sum_{mo, i} dZ[mo, no, i, j] A_pack[mo, ko, i, k]
//          (and, fused, the bias gradient dbias[no, j] = sum_{mo, i} dZ[mo, no, i, j])
//
// A_pack [Mo, Ko, m_r, k_r], B_pack [No, Ko, n_r, k_r], dZ [Mo, No, m_r, n_r]
// (mmt4d's output layout).  With an activation, dZ = dY * act'(Z) is formed
// as each element of dZ is loaded (Z: the pre-activation, packed like dY),
// rounded to the element type as a stored dZ would be, then used in float32.
//
// The gradient of the Pallas kernel src/repro/kernels/mmt4d/kernel.py:113
// (mmt4d_kernel_call): the JAX package differentiates the jnp mmt4d
// (src/repro/core/mmt4d.py:64), whose transposes are these two products; the
// port's mmt4d autograd Function (core/mmt4d.py) launches them.
//
// One kernel computes both: C[p, q] = sum_r X(p, r) Y(r, q) over logical
// matrices whose elements lie in packed tiles.  In a packed tensor the
// address of element (i, j) splits as row_off(i) + col_off(j) (tile and
// in-tile parts of each index), so a thread computes the row part of its
// loads once and only the reduction index's part per chunk.  The operand
// descriptors (kernels/mmt4d/ops.py:gemm_operands) say how each logical
// matrix sits in its packed tensor:
//   dgrad: X = dZ (p = m, r = n), Y = B_pack (r = n, q = k), C = dA_pack;
//   wgrad: X = dZ^T (p = n, r = m), Y = A_pack (r = m, q = k), C = dB_pack.
// Tile padding needs no mask of its own: padding rows and columns of the
// packed operands are zero, so the padding of dA_pack and dB_pack comes out
// zero and every output element is written.
//
// Bound: at training widths both products are bound by operations (the
// tied head's dgrad does 2 * 4096 * 49152 * 640 flops on 0.5 GB in bf16).
// Both dtypes stage tiles of X and Y through shared memory, the next
// chunk's loads issued into registers before the current chunk's products:
//
// - bfloat16 runs on the tensor cores (mma.sync m16n8k16, float32 sums):
//   128 x 128 output tile per block of 8 warps (2 x 4, 64 x 32 each),
//   32-deep reduction chunks.  Every operand moves in 16-byte vectors along
//   its contiguous dimension (8 elements of one packed tile row: n_r and
//   k_r are 128) into shared memory laid out as in device memory, and
//   ldmatrix (.trans where the reduction index runs down the rows) turns it
//   into MMA fragments; rows are padded so that 8 rows' 16-byte pieces hit
//   32 different banks.  A first version that loaded single elements and
//   transposed them into K-major shared memory was several times slower.
// - float32 stays IEEE on the CUDA cores (TF32 would change the float32
//   results the CPU parity holds to): 64 x 64 output tile per block of 256
//   threads, 4 x 4 outputs per thread, 16-deep chunks.
//
// Each output element is summed in a fixed order (one thread, or one MMA
// lane, in ascending r): no atomics, repeated calls are bit-identical (the
// trainer's crash/resume check needs that).  wgmma with TMA is later work
// (ROADMAP B).
#include "common.cuh"

namespace {

enum Act : int { kNone = 0, kGelu = 1, kSilu = 2, kRelu = 3, kTanh = 4 };

// d act(z) / dz, in float32, for the activations csrc/mmt4d.cu applies
__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case kGelu: {  // tanh approximation
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      const float t = tanhf(c * (z + 0.044715f * z * z * z));
      return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * z * z);
    }
    case kSilu: {
      const float s = 1.0f / (1.0f + expf(-z));
      return s * (1.0f + z * (1.0f - s));
    }
    case kRelu: return z > 0.0f ? 1.0f : 0.0f;
    case kTanh: {
      const float t = tanhf(z);
      return 1.0f - t * t;
    }
    default: return 1.0f;
  }
}

// element (i, j) of a logical matrix at row_off(i) + col_off(j) in its
// packed tensor: tiles of ti x tj, tile strides rs / cs, in-tile strides ii / ij
struct Desc {
  int64_t rs, ii, cs, ij;
  int ti, tj;
};

__device__ __forceinline__ int64_t row_off(const Desc& d, int i) {
  const int t = i / d.ti;
  return (int64_t)t * d.rs + (int64_t)(i - t * d.ti) * d.ii;
}
__device__ __forceinline__ int64_t col_off(const Desc& d, int j) {
  const int t = j / d.tj;
  return (int64_t)t * d.cs + (int64_t)(j - t * d.tj) * d.ij;
}

constexpr int kThreads = 256;
constexpr int BP = 64, BQ = 64, BR = 16;
constexpr int kXPitch = BP + 4;   // row-wise X stores hit 2-way at most; rows stay 16-byte aligned
constexpr int kPer = BR * BP / kThreads;   // elements of each operand a thread loads per chunk (4)

// float32.  XP: X is contiguous along p (wgrad's dZ^T) rather than along r
// (dgrad's dZ); consecutive threads load consecutive addresses either way.
template <bool XP>
__global__ void __launch_bounds__(kThreads)
packed_gemm_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ y, float* __restrict__ c,
                   float* __restrict__ dbias, Desc dx, Desc dy, Desc dc, int P, int Q,
                   int R, int act) {
  __shared__ __align__(16) float Xs[BR][kXPitch];
  __shared__ __align__(16) float Ys[BR][BQ];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.y * BP, q0 = blockIdx.x * BQ;

  // this thread's loads: X elements (xp[s], xr[s]) and Y elements (yr[s], yq)
  // of each chunk, relative to (p0, r0) and (r0, q0)
  int xp[kPer], xr[kPer], yr[kPer];
  int64_t xrow[kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int e = tid + s * kThreads;
    xp[s] = XP ? e % BP : e / BR;
    xr[s] = XP ? e / BP : e % BR;
    yr[s] = e / BQ;
    xrow[s] = p0 + xp[s] < P ? row_off(dx, p0 + xp[s]) : -1;
  }
  const int yq = tid % BQ;
  const int64_t ycol = q0 + yq < Q ? col_off(dy, q0 + yq) : -1;

  float xv[kPer], yv[kPer];
  auto load = [&](int r0) {
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = r0 + xr[s];
      float v = 0.0f;
      if (xrow[s] >= 0 && r < R) {
        const int64_t o = xrow[s] + col_off(dx, r);
        v = x[o];
        if (act != kNone) v *= act_grad(z[o], act);   // dZ = dY * act'(Z)
      }
      xv[s] = v;
    }
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int r = r0 + yr[s];
      yv[s] = (ycol >= 0 && r < R) ? y[row_off(dy, r) + ycol] : 0.0f;
    }
  };

  const int tx = tid % 16, ty = tid / 16;
  const bool bias_thread = dbias != nullptr && blockIdx.x == 0 && tx == 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float bsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  load(0);
  for (int r0 = 0; r0 < R; r0 += BR) {
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      Xs[xr[s]][xp[s]] = xv[s];
      Ys[yr[s]][yq] = yv[s];
    }
    __syncthreads();
    if (r0 + BR < R) load(r0 + BR);    // in flight while this chunk is summed
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ys[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (bias_thread) {
#pragma unroll
        for (int i = 0; i < 4; ++i) bsum[i] += av[i];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
    const int64_t ro = row_off(dc, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + tx * 4 + j;
      if (q < Q) c[ro + col_off(dc, q)] = acc[i][j];
    }
    if (bias_thread) dbias[p] = bsum[i];
  }
}


// ---------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int TP = 128, TQ = 128, TR = 32;   // block tile and reduction chunk
constexpr int kVec = 8;                      // bf16 per 16-byte vector
constexpr int kKPitch = TR + 8;              // [p][r] rows: 80 bytes
constexpr int kNPitch = TP + 8;              // [r][p] and [r][q] rows: 272 bytes

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// dY * act'(Z) for 8 bf16 of dY and Z, rounded to bf16
__device__ __forceinline__ uint4 dz_vec(uint4 dy, uint4 z, int act) {
  const __nv_bfloat162* d = reinterpret_cast<const __nv_bfloat162*>(&dy);
  const __nv_bfloat162* zz = reinterpret_cast<const __nv_bfloat162*>(&z);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 dv = __bfloat1622float2(d[i]), zv = __bfloat1622float2(zz[i]);
    o[i] = __floats2bfloat162_rn(dv.x * act_grad(zv.x, act), dv.y * act_grad(zv.y, act));
  }
  return out;
}

// C[P, Q] = X . Y on the tensor cores, every operand kept in shared memory
// as it lies in device memory (its contiguous dimension along the shared
// rows, so a 16-byte load is a 16-byte store) and turned into MMA fragments
// by ldmatrix (.trans where the reduction index runs down the rows):
//   X, !XP (dgrad's dZ, r contiguous): Xs[p][r], A fragments by ldmatrix;
//   X, XP (wgrad's dZ^T, p contiguous): Xs[r][p], A fragments by .trans;
//   Y (q contiguous): Ys[r][q], B fragments by .trans.
// Needs each operand's contiguous dimension in runs of 8 (in-tile stride 1,
// tile extent and P, Q, R multiples of 8), which repro_packed_gemm checks.
// dbias (XP only): each thread sums its 8 p over its r class (r % 16) in
// ascending r; the 16 classes are added in order at the end.
template <bool XP>
__global__ void __launch_bounds__(kThreads)
packed_gemm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ z,
                      const bf16* __restrict__ y, bf16* __restrict__ c,
                      bf16* __restrict__ dbias, Desc dx, Desc dy, Desc dc, int P,
                      int Q, int R, int act) {
  __shared__ __align__(16) bf16 Xs[XP ? TR : TP][XP ? kNPitch : kKPitch];
  __shared__ __align__(16) bf16 Ys[TR][kNPitch];
  __shared__ float bpart[XP ? 16 : 1][TP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.y * TP, q0 = blockIdx.x * TQ;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // vector s (0, 1) of this thread in each chunk:
  //   Y and XP's X: row r0 + tid / 16 + 16 s, columns (tid % 16) * 8 .. + 7;
  //   !XP's X: row p0 + tid / 4 + 64 s, r r0 + (tid % 4) * 8 .. + 7
  const int vr = tid >> 4, vc = (tid & 15) * kVec;
  const bool yok = q0 + vc < Q;
  const int64_t ycol = yok ? col_off(dy, q0 + vc) : 0;
  int64_t xrow[2];
  bool xok[2];
  if constexpr (XP) {
    xok[0] = xok[1] = p0 + vc < P;
    xrow[0] = xrow[1] = xok[0] ? row_off(dx, p0 + vc) : 0;
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = p0 + (tid >> 2) + 64 * s;
      xok[s] = p < P;
      xrow[s] = xok[s] ? row_off(dx, p) : 0;
    }
  }

  uint4 xv[2], yv[2];
  float bs[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) bs[i] = 0.0f;
  const bool bias_on = XP && dbias != nullptr && blockIdx.x == 0;
  auto xload = [&](int64_t o) {
    uint4 v = *reinterpret_cast<const uint4*>(x + o);
    if (act != kNone) v = dz_vec(v, *reinterpret_cast<const uint4*>(z + o), act);
    return v;
  };
  auto load = [&](int r0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = r0 + vr + 16 * s;
      yv[s] = (yok && r < R) ? *reinterpret_cast<const uint4*>(y + row_off(dy, r) + ycol)
                             : zero;
      if constexpr (XP) {
        xv[s] = (xok[0] && r < R) ? xload(xrow[0] + col_off(dx, r)) : zero;
        if (bias_on) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&xv[s]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            bs[2 * i] += f.x;
            bs[2 * i + 1] += f.y;
          }
        }
      }
    }
    if constexpr (!XP) {
      const int r = r0 + (tid & 3) * kVec;
      const int64_t co = r < R ? col_off(dx, r) : 0;
#pragma unroll
      for (int s = 0; s < 2; ++s) xv[s] = (xok[s] && r < R) ? xload(xrow[s] + co) : zero;
    }
  };

  // this warp's 64 x 32 of the block tile: 4 m16 tiles x 4 n8 tiles
  const int wp = (warp % 2) * 64, wq = (warp / 2) * 32;
  const int l8 = lane & 7, l3 = (lane >> 3) & 1, l4 = lane >> 4;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load(0);
  for (int r0 = 0; r0 < R; r0 += TR) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      *reinterpret_cast<uint4*>(&Ys[vr + 16 * s][vc]) = yv[s];
      if constexpr (XP)
        *reinterpret_cast<uint4*>(&Xs[vr + 16 * s][vc]) = xv[s];
      else
        *reinterpret_cast<uint4*>(&Xs[(tid >> 2) + 64 * s][(tid & 3) * kVec]) = xv[s];
    }
    __syncthreads();
    if (r0 + TR < R) load(r0 + TR);    // in flight while this chunk is summed
#pragma unroll
    for (int kk = 0; kk < TR; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mr = wp + i * 16;
        if constexpr (XP)
          ldsm_x4_t(a[i], &Xs[kk + l8 + l4 * 8][mr + l3 * 8]);
        else
          ldsm_x4(a[i], &Xs[mr + l8 + l3 * 8][kk + l4 * 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t t[4];
        ldsm_x4_t(t, &Ys[kk + l8 + l3 * 8][wq + j * 8 + l4 * 8]);
        b[j][0] = t[0];
        b[j][1] = t[1];
        b[j + 1][0] = t[2];
        b[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) repro::mma_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();
  }

  // c0, c1 at (row g, cols 2 t4, 2 t4 + 1); c2, c3 at row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wp + i * 16 + g + 8 * h;
      if (p >= P) continue;
      const int64_t ro = row_off(dc, p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + wq + j * 8 + 2 * t4 + e;
          if (q < Q) c[ro + col_off(dc, q)] = repro::from_float<bf16>(acc[i][j][2 * h + e]);
        }
      }
    }
  }
  if (bias_on) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) bpart[vr][vc + i] = bs[i];
    __syncthreads();
    if (tid < TP && p0 + tid < P) {
      float v = 0.0f;
      for (int k = 0; k < 16; ++k) v += bpart[k][tid];
      dbias[p0 + tid] = repro::from_float<bf16>(v);
    }
  }
}

Desc desc_of(const int64_t* v) {
  Desc d;
  d.rs = v[0];
  d.ti = (int)v[1];
  d.ii = v[2];
  d.cs = v[3];
  d.tj = (int)v[4];
  d.ij = v[5];
  return d;
}

int launch_tc(const void* x, const void* z, const void* y, void* c, void* dbias,
              int64_t P, int64_t Q, int64_t R, const int64_t* desc, int x_contig_p,
              int act, cudaStream_t stream) {
  const Desc dx = desc_of(desc), dy = desc_of(desc + 6), dc = desc_of(desc + 12);
  // 16-byte runs along each operand's contiguous dimension: X's along p
  // (XP) or r, Y's along q; the tensors themselves 16-byte aligned
  const bool runs =
      (x_contig_p ? (dx.ii == 1 && dx.ti % kVec == 0) : (dx.ij == 1 && dx.tj % kVec == 0)) &&
      dy.ij == 1 && dy.tj % kVec == 0 && P % kVec == 0 && Q % kVec == 0 &&
      R % kVec == 0 &&
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)(z ? z : x)) & 15) == 0;
  if (!runs || (dbias != nullptr && !x_contig_p)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Q + TQ - 1) / TQ), (unsigned)((P + TP - 1) / TP));
  if (x_contig_p)
    packed_gemm_tc_kernel<true><<<grid, kThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)z, (const bf16*)y, (bf16*)c, (bf16*)dbias, dx,
        dy, dc, (int)P, (int)Q, (int)R, act);
  else
    packed_gemm_tc_kernel<false><<<grid, kThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)z, (const bf16*)y, (bf16*)c, (bf16*)dbias, dx,
        dy, dc, (int)P, (int)Q, (int)R, act);
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const void* z, const void* y, void* c, void* dbias,
               int64_t P, int64_t Q, int64_t R, const int64_t* desc, int x_contig_p,
               int act, cudaStream_t stream) {
  const Desc dx = desc_of(desc), dy = desc_of(desc + 6), dc = desc_of(desc + 12);
  const dim3 grid((unsigned)((Q + BQ - 1) / BQ), (unsigned)((P + BP - 1) / BP));
  if (x_contig_p)
    packed_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(
        (const float*)x, (const float*)z, (const float*)y, (float*)c, (float*)dbias,
        dx, dy, dc, (int)P, (int)Q, (int)R, act);
  else
    packed_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(
        (const float*)x, (const float*)z, (const float*)y, (float*)c, (float*)dbias,
        dx, dy, dc, (int)P, (int)Q, (int)R, act);
  return (int)cudaGetLastError();
}

}  // namespace

// C[P, Q] = sum_r X(p, r) Y(r, q), X formed as dY * act'(Z) when act != 0
// (z then packed like x), and with dbias != nullptr also dbias[p] = sum_r
// X(p, r).  desc: three descriptors of six int64 each, X then Y then C:
// (rs, ti, ii, cs, tj, ij), as kernels/mmt4d/ops.py:gemm_operands gives them.
extern "C" int repro_packed_gemm(const void* x, const void* z, const void* y,
                                 void* c, void* dbias, int dtype, int64_t P,
                                 int64_t Q, int64_t R, const int64_t* desc,
                                 int x_contig_p, int act, void* stream) {
  if (P < 0 || Q < 0 || R < 0 || P > INT32_MAX || Q > INT32_MAX || R > INT32_MAX ||
      (P + BP - 1) / BP > 65535 || act < kNone || act > kTanh ||
      (act != kNone && z == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < 3; ++d)
    if (desc[6 * d + 1] < 1 || desc[6 * d + 4] < 1) return (int)cudaErrorInvalidValue;
  if (P == 0 || Q == 0) return 0;
  if (dtype == repro::kF32)
    return launch_f32(x, z, y, c, dbias, P, Q, R, desc, x_contig_p, act,
                      (cudaStream_t)stream);
  if (dtype == repro::kBF16)
    return launch_tc(x, z, y, c, dbias, P, Q, R, desc, x_contig_p, act,
                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
