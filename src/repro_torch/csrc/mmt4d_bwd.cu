// mmt4d's two gradient products, on packed operands:
//
//   dgrad  dA_pack[mo, ko, i, k] = sum_{no, j} dZ[mo, no, i, j] B_pack[no, ko, j, k]
//   wgrad  dB_pack[no, ko, j, k] = sum_{mo, i} dZ[mo, no, i, j] A_pack[mo, ko, i, k]
//          (and, fused, the bias gradient dbias[no, j] = sum_{mo, i} dZ[mo, no, i, j])
//
// A_pack [Mo, Ko, m_r, k_r], B_pack [No, Ko, n_r, k_r], dZ [Mo, No, m_r, n_r]
// (mmt4d's output layout).  With an activation, dZ = dY * act'(Z) is formed
// from each loaded element of dY and Z (Z: the pre-activation, packed like
// dY), rounded to the element type as a stored dZ would be, then used.
//
// The gradient of the Pallas kernel src/repro/kernels/mmt4d/kernel.py:113
// (mmt4d_kernel_call): the JAX package differentiates the jnp mmt4d
// (src/repro/core/mmt4d.py:64), whose transposes are these two products; the
// port's mmt4d autograd Function (core/mmt4d.py) launches them.
//
// Both are C[p, q] = sum_r X(p, r) Y(r, q) over logical matrices whose
// elements lie in packed tiles.  The operand descriptors
// (kernels/mmt4d/ops.py:gemm_operands) say how each sits in its tensor:
//   dgrad: X = dZ (p = m, r = n), Y = B_pack (r = n, q = k), C = dA_pack;
//   wgrad: X = dZ^T (p = n, r = m), Y = A_pack (r = m, q = k), C = dB_pack.
// Tile padding needs no mask of its own: padding rows and columns of the
// packed operands are zero, so the padding of dA_pack and dB_pack comes out
// zero and every output element is written.
//
// Bound on the H100, at 4,096 tokens: operations at the tied head (2 *
// 4096 * 49152 * 576 flops on 0.47 GB) and the down projection, bytes at
// the gate (it reads dY and Z) and the narrow K and V projections.  Either
// way the tensor cores have to be fed at Hopper's rate: warpgroup MMAs
// (wgmma) whose operands TMA brings into a ring of shared-memory stages,
// and enough blocks to cover the SMs:
//
// - TMA.  In the packed layouts every operand tile is a contiguous run, so
//   each operand is one tensor map over its packed tensor [O0, O1, t0, t1]
//   (encoded on the host) with 128-byte swizzle, and one copy per operand
//   and chunk: dgrad's K-major X a 4-D box of 64 elements of r by 256 rows
//   of p; each MN-major operand a 5-D box of 64-wide pieces of its
//   contiguous dimension, each 64 rows of r.  Out-of-bounds boxes (a
//   ragged M, the last reduction chunk) are zero-filled by the copy
//   engine, which takes the place of masks.  kernels/mmt4d/ops.py:grad_tma
//   mirrors the maps and box origins in Python (tested on the CPU).
// - wgmma.  A block computes a 256 x 128 tile of C with two consumer
//   warpgroups (128 rows of p each: two m64n128k16 per 16-deep slice,
//   float32 sums in registers) over 64-deep chunks of r; one producer warp
//   keeps a ring of chunks of X and Y in flight (4 stages of 48 KB; with
//   an activation 3, beside a 2-stage ring of Z), each stage's arrival and
//   release counted by mbarriers.  The wide
//   tile halves the bytes each MMA pulls through L2 against 128 x 128,
//   which capped a first version near 340 TFLOP/s at the tied head.  Every operand is read straight from the swizzled stage:
//   dgrad's X is K-major, wgrad's X and both Y are MN-major (the transpose
//   flags of wgmma), so nothing is transposed by hand.
// - The activation.  A consumer forms dZ = dY * act'(Z) in place in its own
//   128 rows of the stage (silu through the fast exponential; Z comes
//   through its own ring, in the same swizzled order as dY, so the
//   elementwise product needs no index), fences the async proxy, and its
//   wgmmas read the result: dZ is never written to device memory.
//   wgrad's bias gradient sums the same values (each thread 8 columns of p
//   over its rows, in ascending r; the 16 row classes added in order).
// - Split-K in a cluster.  Where the output tiles cannot keep 132 SMs busy
//   (wgrad at every layer linear: 5-36 tiles; dgrad at the tied head: 80
//   tiles over a 49,152-deep reduction), the reduction is cut into
//   `splits` contiguous ranges of chunks, one block each, the blocks of one
//   tile forming a thread-block cluster (kernels/mmt4d/ops.py:
//   pick_grad_split chooses the count).  Each block leaves its float32 tile
//   in its own shared memory; after cluster.sync() each block sums a share
//   of the rows over the cluster's tiles through distributed shared memory
//   in split order and stores them.  No atomics: every output element is
//   summed in a fixed order and repeated calls are bit-identical (the
//   trainer's crash/resume identity and remat = no remat rest on it).
//
// - The expert dim (the moe family's expert-batched linears: dZ [E, M_o,
//   N_o, m_r, n_r], A_pack and B_pack [E, ...], one product each).  The
//   experts run in one launch, grid y = E times the p tiles of one
//   expert.  TMA takes at most five dimensions and the MN-major maps use
//   all five, so the expert is not a sixth: each map folds the experts
//   into its outer tile dimension (the experts' packed slices follow one
//   another), and a block offsets its box origins by its expert's tiles.
//   A box at an expert's edge then reads the next expert's tiles, which
//   the copy engine's zero fill no longer masks: dgrad's extra p rows are
//   never stored (the epilogue stores p < P only), and wgrad's reduction
//   over m (M_o m_r per expert, a multiple of 16 but not always of 64)
//   zeroes the next expert's rows of X in its last chunk before the MMAs
//   read them.  An expert product has no bias; the launch refuses one.
//
// float32 stays IEEE on the CUDA cores (TF32 tensor cores would change the
// float32 results the CPU parity holds to; the f32 path runs only in the
// f32 parity step): 64 x 64 output tile per block of 256 threads, 4 x 4
// outputs per thread, 16-deep chunks staged through shared memory, the
// expert in grid z.
#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
  {  // expert blockIdx.z: its own dense packed X, Z, Y, C and dbias
    const int64_t e = blockIdx.z;
    x += e * P * R;
    if (z != nullptr) z += e * P * R;
    y += e * R * Q;
    c += e * P * Q;
    if (dbias != nullptr) dbias += e * P;
  }
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

constexpr int kBM = 256, kBN = 128, kBK = 64;   // block tile (p x q), reduction chunk
constexpr int kConsumers = 2;                   // warpgroups, 128 rows of p each
constexpr int kSub = kBM / kConsumers / 64;     // m64 MMA tiles per warpgroup
constexpr int kTcThreads = kConsumers * 128 + 32;   // and one producer warp
constexpr int kHalf = 64 * 64 * 2;              // 8 KB: 64 rows of 64 bf16 (128 bytes)
constexpr int kXTile = kBM * kBK * 2;           // X (or Z) of one stage: 32 KB
constexpr int kYTile = kBN * kBK * 2;           // Y of one stage: 16 KB
constexpr int kStages = 4;                      // ring of 48 KB stages of X and Y
constexpr int kZStages = 2;                     // with Z: 3 of X and Y, 2 of Z (32 KB)
constexpr int kPitch = kBN + 4;                 // row pitch of the float32 tile
constexpr int kMaxSplits = 8;                   // portable cluster size
constexpr int kPartBytes = (kBM * kPitch + 16 * kBM + kBM) * 4;
// the epilogue reuses the ring (and the ring of Z, which follows it)
static_assert(kPartBytes <= (kStages - 1) * (kXTile + kYTile) + kZStages * kXTile &&
                  kPartBytes <= kStages * (kXTile + kYTile),
              "the epilogue's tile does not fit the rings");

// The product's geometry: extents (tile padding included), the in-tile
// extents of p, r and q, C's q tiles, and the reduction ranges per tile.
struct Geom {
  int P, Q, R;
  int p_t, r_t, q_t;
  int Qo;
  int splits;   // reduction ranges per output tile: the cluster
  int pt;       // output tiles of p per expert (grid y = E * pt)
  int E;        // experts: the product repeated over E dense packed slices
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// one box of a 5-D tensor map (an MN-major operand's 64-wide pieces)
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (for an MN-major operand: between 64-wide MN
// atoms and between 8-deep K groups; K-major: the 8-row groups' stride)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// keeps the compiler from moving accumulator reads across wgmma's async window
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128]; A K-major (TA = 0) or MN-major
// (TA = 1), B MN-major; both from shared memory
template <int TA>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// act'(z) for the bf16 path: silu's sigmoid from the fast exponential and
// reciprocal (relative error near 1e-6, far below the bf16 rounding of dZ
// that follows; expf and an IEEE division take several times as many
// instructions); the others as act_grad
__device__ __forceinline__ float act_grad_bf16(float z, int act) {
  if (act == kSilu) {
    const float s = __fdividef(1.0f, 1.0f + __expf(-z));
    return s * (1.0f + z * (1.0f - s));
  }
  return act_grad(z, act);
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
    o[i] = __floats2bfloat162_rn(dv.x * act_grad_bf16(zv.x, act),
                                 dv.y * act_grad_bf16(zv.y, act));
  }
  return out;
}

// C[P, Q] = X . Y on the tensor cores.  Grid (ceil(Q / 128), ceil(P / 256),
// splits), cluster (1, 1, splits).  A stage holds X (256 p x 64 r: dgrad
// [p][r], wgrad four [r][64 p] quarters) and Y (two [r][64 q] halves); with
// an activation a stage of the Z ring holds Z shaped as X.  X's 8 KB
// pieces are the m64 tiles: warpgroup w multiplies pieces 2 w and 2 w + 1
// (p rows 128 w .. 128 w + 127) by all of Y.  C is [Po, Qo, p_t, q_t] (q
// contiguous); dbias (WGRAD) [P].  BIAS (WGRAD only): dbias is summed, in a
// variant of its own, so that the bias-free products do not spend 16
// registers on it (the kernel sits at its 168, and spilling slowed the
// gate's wgrad by a third).  EXPERTS: the expert-batched variant (grid y
// = E x its p tiles), in its own instance so that the single product's
// code and registers stay as they were (the offsets and the edge's zeroing
// cost its wgrad 16 bytes of spills and a fifth of the gate's time).
template <bool WGRAD, bool BIAS, bool EXPERTS>
__global__ void __launch_bounds__(kTcThreads, 1)
packed_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tz,
                         const __grid_constant__ CUtensorMap ty, bf16* __restrict__ c,
                         bf16* __restrict__ dbias, const Geom g, const int act) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled boxes want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const bool with_z = act != kNone;
  constexpr int stage_bytes = kXTile + kYTile;
  const int stages = with_z ? kStages - 1 : kStages;   // with Z: 3 of X and Y, 2 of Z
  uint8_t* zring = smem + stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(zring + (with_z ? kZStages * kXTile : 0));
  uint64_t* empty = full + kStages;
  uint64_t* full_z = empty + kStages;
  uint64_t* empty_z = full_z + kZStages;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, lane = tid % 32;
  // expert e's operands are the e-th dense packed slices of X, Z, Y and C:
  // in the tensor maps, whose outer tile dimension folds the experts in,
  // its tiles start at e Po (dgrad's X) or e Ro (r tiles: wgrad's X, Y)
  const int e = EXPERTS ? blockIdx.y / g.pt : 0;
  const int p0 = (blockIdx.y - e * g.pt) * kBM, q0 = blockIdx.x * kBN;
  const int xo = e * (WGRAD ? g.R / g.r_t : g.P / g.p_t), yo = e * (g.R / g.r_t);
  if (EXPERTS) c += (int64_t)e * g.P * g.Q;
  const int split = blockIdx.z;   // the block's rank in its cluster
  const int nch = (g.R + kBK - 1) / kBK;
  const int c_lo = (int)((int64_t)split * nch / g.splits);
  const int c_hi = (int)((int64_t)(split + 1) * nch / g.splits);
  const bool bias_on = BIAS && blockIdx.x == 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);   // lane 0 of every consumer warp
    }
    for (int s = 0; s < kZStages; ++s) {
      mbar_init(&full_z[s], 1);
      mbar_init(&empty_z[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // launched early behind the previous kernel on the stream: nothing read
  // or written in device memory before it has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  float acc[kSub][64];
#pragma unroll
  for (int j = 0; j < kSub; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.0f;
  float bs[kSub][8];
#pragma unroll
  for (int j = 0; j < kSub; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) bs[j][e] = 0.0f;

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    if (tid == kConsumers * 128) {
      int stage = 0, zstage = 0;
      uint32_t parity = 1, zparity = 1;   // the rings start empty
      for (int it = c_lo; it < c_hi; ++it) {
        mbar_wait(&empty[stage], parity);
        uint8_t* st = smem + stage * stage_bytes;
        uint64_t* bar = &full[stage];
        mbar_expect_tx(bar, stage_bytes);
        const int r0 = it * kBK, ri = r0 % g.r_t, ro = r0 / g.r_t;
        if (!WGRAD) {   // X = dZ [Po, Ro, p_t, r_t]: 256 p rows of 64 r
          tma_load(st, &tx, bar, ri, 0, ro, xo + p0 / g.p_t);
        } else {        // X = dZ^T, dZ [Ro, Po, r_t, p_t]: 4 pieces of 64 r rows by 64 p
          tma_load5(st, &tx, bar, 0, ri, xo + ro, (p0 % g.p_t) / 64, p0 / g.p_t);
        }
        // Y [Ro, Qo, r_t, q_t]: 2 pieces of 64 r rows by 64 q
        tma_load5(st + kXTile, &ty, bar, 0, ri, yo + ro, (q0 % g.q_t) / 64, q0 / g.q_t);
        if (++stage == stages) {
          stage = 0;
          parity ^= 1;
        }
        if (with_z) {   // Z shaped as X, into its own ring
          mbar_wait(&empty_z[zstage], zparity);
          uint8_t* zs = zring + zstage * kXTile;
          uint64_t* zbar = &full_z[zstage];
          mbar_expect_tx(zbar, kXTile);
          if (!WGRAD) {
            tma_load(zs, &tz, zbar, ri, 0, ro, xo + p0 / g.p_t);
          } else {
            tma_load5(zs, &tz, zbar, 0, ri, xo + ro, (p0 % g.p_t) / 64, p0 / g.p_t);
          }
          if (++zstage == kZStages) {
            zstage = 0;
            zparity ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns p rows 128 wg .. 128 wg + 127
    int stage = 0, prev = -1, zstage = 0;
    uint32_t parity = 0, zparity = 0;
    const int v = t % 8;
    for (int it = c_lo; it < c_hi; ++it) {
      mbar_wait(&full[stage], parity);
      uint8_t* st = smem + stage * stage_bytes;
      uint8_t* xa = st + wg * kSub * kHalf;
      if (with_z || bias_on) {
        // kSub pieces of 64 rows of 128 bytes, 16-byte chunks swizzled as
        // chunk ^ (row % 8): thread t takes logical chunk v = t % 8 of rows
        // t / 8 + 16 k (wgrad: p = 128 wg + 64 j + 8 v + e in piece j)
        const uint8_t* za = zring + zstage * kXTile + wg * kSub * kHalf;
        if (with_z) mbar_wait(&full_z[zstage], zparity);
#pragma unroll
        for (int j = 0; j < kSub; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int row = t / 8 + 16 * k;
            const int off = j * kHalf + row * 128 + ((v ^ (row & 7)) << 4);
            uint4 x = *reinterpret_cast<const uint4*>(xa + off);
            if (with_z) {
              x = dz_vec(x, *reinterpret_cast<const uint4*>(za + off), act);
              *reinterpret_cast<uint4*>(xa + off) = x;
            }
            if (bias_on) {
              const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h2[e]);
                bs[j][2 * e] += f.x;
                bs[j][2 * e + 1] += f.y;
              }
            }
          }
        if (with_z) {   // the generic-proxy writes, seen by wgmma's async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
          if (lane == 0) mbar_arrive(&empty_z[zstage]);   // Z read: release it
          if (++zstage == kZStages) {
            zstage = 0;
            zparity ^= 1;
          }
        }
      }
      // wgrad's reduction runs over m, M_o m_r rows an expert, a multiple
      // of 16 but not always of 64: a chunk at an expert's edge holds the
      // next expert's rows past `rem`, which this warpgroup zeroes in its
      // pieces of X (whole 128-byte rows, so the swizzle does not matter)
      // before its MMAs read them (an expert product has no bias, and the
      // launch refuses one, so no bias sum has read them)
      const int rem = g.R - it * kBK;
      if (EXPERTS && WGRAD && rem < kBK) {
        const int n16 = (kBK - rem) * 8;       // 16-byte pieces a 64-wide piece
        for (int i = t; i < kSub * n16; i += 128)
          *reinterpret_cast<uint4*>(xa + (i / n16) * kHalf + (rem + i % n16 / 8) * 128 +
                                    (i % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) fence_acc(acc[j]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // a 16-deep slice: K-major X advances 32 bytes along its rows,
        // MN-major operands 16 rows of 128 bytes
        const uint64_t db = gmma_desc(st + kXTile + kk * 2048, kHalf, 1024);
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const uint8_t* xj = xa + j * kHalf;
          const uint64_t da = WGRAD ? gmma_desc(xj + kk * 2048, kHalf, 1024)
                                    : gmma_desc(xj + kk * 32, 16, 1024);
          wgmma_m64n128k16<WGRAD ? 1 : 0>(acc[j], da, db);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous chunk's MMAs are done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < kSub; ++j) fence_acc(acc[j]);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        parity ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kSub; ++j) fence_acc(acc[j]);
  }

  // epilogue: the block's float32 tile (and bias partials) into shared
  // memory over the ring, then the cluster sums each row over its splits
  __syncthreads();   // every MMA done: the ring is free
  float* part = reinterpret_cast<float*>(smem);   // [kBM][kPitch]
  float* bscr = part + kBM * kPitch;               // [16][kBM]: bias partials by row class
  float* bpart = bscr + 16 * kBM;                  // [kBM]
  if (wg < kConsumers) {
    // accumulator d[4 i + 2 h + e] of m64 tile j: row 64 j + 16 warp +
    // lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e of the warpgroup's rows
    const int row0 = wg * 128 + (t / 32) * 16 + lane / 4, col0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&part[(row0 + 64 * j + 8 * h) * kPitch + 8 * i + col0]) =
              make_float2(acc[j][4 * i + 2 * h], acc[j][4 * i + 2 * h + 1]);
    if (bias_on) {
#pragma unroll
      for (int j = 0; j < kSub; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          bscr[(t / 8) * kBM + wg * 128 + 64 * j + 8 * (t % 8) + e] = bs[j][e];
    }
  }
  __syncthreads();
  if (bias_on) {
    for (int i = tid; i < kBM; i += kTcThreads) {
      float v = bscr[i];
      for (int k = 1; k < 16; ++k) v += bscr[k * kBM + i];
      bpart[i] = v;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();   // one block if splits == 1
  if (g.splits > 1) cluster.sync(); else __syncthreads();

  const int r_lo = split * kBM / g.splits, r_hi = (split + 1) * kBM / g.splits;
  const int64_t tile = (int64_t)g.p_t * g.q_t;
  for (int i = tid; i < (r_hi - r_lo) * (kBN / 8); i += kTcThreads) {
    const int row = r_lo + i / (kBN / 8), cv = i % (kBN / 8);
    const int p = p0 + row, q = q0 + 8 * cv;
    if (p >= g.P || q >= g.Q) continue;
    float v[8];
    for (int k = 0; k < g.splits; ++k) {
      const float* src = (g.splits > 1 ? cluster.map_shared_rank(part, k) : part) +
                         row * kPitch + 8 * cv;
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = k == 0 ? w[e] : v[e] + w[e];
    }
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    const int64_t off = ((int64_t)(p / g.p_t) * g.Qo + q / g.q_t) * tile +
                        (int64_t)(p % g.p_t) * g.q_t + q % g.q_t;
    *reinterpret_cast<uint4*>(c + off) = out;
  }
  if (bias_on) {
    for (int row = r_lo + tid; row < r_hi; row += kTcThreads) {
      if (p0 + row >= g.P) continue;
      float v = 0.0f;
      for (int k = 0; k < g.splits; ++k)
        v += (g.splits > 1 ? cluster.map_shared_rank(bpart, k) : bpart)[row];
      dbias[p0 + row] = __float2bfloat16(v);
    }
  }
  if (g.splits > 1) cluster.sync();   // keep every tile until the cluster has read it
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

// the descriptor of a dense packed tensor [., O1, ti, tj] read as its
// logical matrix (o1 column tiles), or of [., O1, tj, ti] read transposed
bool dense(const Desc& d, int64_t o1, bool transposed) {
  const int64_t tile = (int64_t)d.ti * d.tj;
  return transposed ? d.ii == 1 && d.ij == d.ti && d.rs == tile && d.cs == o1 * tile
                    : d.ij == 1 && d.ii == d.tj && d.cs == tile && d.rs == o1 * tile;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (the
// library is not linked against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 packed tensor [o0, o1, t0, t1] as a 4-D map (dims innermost
// first), 128-byte swizzle, out-of-bounds elements read as zero; box: 64 of
// t1 (128 bytes) by rows (dgrad's K-major X).  kernels/mmt4d/ops.py:grad_tma
// mirrors it and encode_mn.
int encode(CUtensorMap* map, const void* ptr, int64_t o0, int64_t o1, int64_t t0, int64_t t1,
           const cuuint32_t (&box)[4]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)t1, (cuuint64_t)t0, (cuuint64_t)o1, (cuuint64_t)o0};
  const cuuint64_t strides[3] = {(cuuint64_t)(t1 * 2), (cuuint64_t)(t0 * t1 * 2),
                                 (cuuint64_t)(o1 * t0 * t1 * 2)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// An MN-major operand [o0 (r tiles), o1 (c tiles), t0 (r_t), t1 (c_t)]
// as a 5-D map whose box holds `pieces` 64-wide pieces of c, each 64 rows
// of r: dims (64 of c, r in a tile, r tiles, 64-wide pieces of a c tile,
// c tiles), strides out of order, so the copy lays down [piece][r][64] in
// one operation.  One box where there were one per piece took the tied
// head's wgrad from 0.54 to 0.44 ms on the H100: the copies' count, not
// their bytes, held the producer back.
int encode_mn(CUtensorMap* map, const void* ptr, int64_t o0, int64_t o1, int64_t t0,
              int64_t t1, int pieces) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int64_t h = t1 / 64;   // pieces in a c tile
  const cuuint32_t rb = (cuuint32_t)(t0 < kBK ? t0 : kBK);
  const cuuint32_t nh = (cuuint32_t)(h < pieces ? h : pieces);
  const cuuint64_t dims[5] = {64, (cuuint64_t)t0, (cuuint64_t)o0, (cuuint64_t)h,
                              (cuuint64_t)o1};
  const cuuint64_t strides[4] = {(cuuint64_t)(t1 * 2), (cuuint64_t)(o1 * t0 * t1 * 2), 128,
                                 (cuuint64_t)(t0 * t1 * 2)};
  const cuuint32_t box[5] = {64, rb, (cuuint32_t)kBK / rb, nh, (cuuint32_t)pieces / nh};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool WGRAD, bool BIAS, bool EXPERTS>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tz, const CUtensorMap& ty, void* c,
                 void* dbias, const Geom& g, int act, cudaStream_t stream) {
  static bool configured[repro::kMaxDevices] = {};
  if (int e = repro::opt_in_smem(packed_gemm_wgmma_kernel<WGRAD, BIAS, EXPERTS>, configured))
    return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((g.Q + kBN - 1) / kBN), (unsigned)(g.E * g.pt),
                     (unsigned)g.splits);
  cfg.blockDim = dim3(kTcThreads);
  // as the kernel lays it out: the ring(s), then the barriers
  cfg.dynamicSmemBytes = 1024 +
      (act != kNone ? (kStages - 1) * (kXTile + kYTile) + kZStages * kXTile
                    : kStages * (kXTile + kYTile)) +
      2 * (kStages + kZStages) * sizeof(uint64_t);
  cfg.stream = stream;
  // may start while the previous kernel on the stream drains (the kernel
  // waits on griddepcontrol before it touches device memory); a cluster
  // only to split the reduction
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = (unsigned)g.splits;
  cfg.attrs = attr;
  cfg.numAttrs = g.splits > 1 ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, packed_gemm_wgmma_kernel<WGRAD, BIAS, EXPERTS>, tx, tz, ty,
                                     (bf16*)c, (bf16*)dbias, g, act);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, const void* z, const void* y, void* c, void* dbias, int64_t P,
              int64_t Q, int64_t R, const int64_t* desc, int x_contig_p, int act, int splits,
              int experts, cudaStream_t stream) {
  const Desc dx = desc_of(desc), dy = desc_of(desc + 6), dc = desc_of(desc + 12);
  const bool wgrad = x_contig_p != 0;
  Geom g;
  g.P = (int)P;
  g.Q = (int)Q;
  g.R = (int)R;
  g.p_t = dx.ti;
  g.r_t = dx.tj;
  g.q_t = dy.tj;
  g.splits = splits;
  g.E = experts;
  g.pt = (int)((P + kBM - 1) / kBM);
  const int nch = (int)((R + kBK - 1) / kBK);
  // dense packed operands whose tiles the boxes cut whole: q and wgrad's p
  // in 64-wide pieces, r in 64-deep chunks of whole tiles (or parts of one),
  // dgrad's p in 128-row blocks of whole tiles
  const bool r_ok = g.r_t % kBK == 0 || kBK % g.r_t == 0;
  const bool p_ok = wgrad ? g.p_t % 64 == 0 : (kBM % g.p_t == 0 && g.r_t % kBK == 0);
  auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  if (!r_ok || !p_ok || g.q_t % 64 != 0 || !pow2(g.q_t / 64) || (wgrad && !pow2(g.p_t / 64)) || dy.ti != g.r_t || dc.ti != g.p_t ||
      dc.tj != g.q_t || P % g.p_t || Q % g.q_t || R % g.r_t ||
      (dbias != nullptr && !wgrad) || splits < 1 || splits > kMaxSplits ||
      splits > (nch > 0 ? nch : 1) || (int64_t)experts * g.pt > 65535 ||
      (experts > 1 && dbias != nullptr) ||
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)c | (uintptr_t)(z ? z : x)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) {   // an empty sum
    cudaError_t e = cudaMemsetAsync(c, 0, (size_t)(experts * P * Q) * sizeof(bf16), stream);
    if (e == cudaSuccess && dbias != nullptr)
      e = cudaMemsetAsync(dbias, 0, (size_t)(experts * P) * sizeof(bf16), stream);
    return (int)e;
  }
  const int64_t Po = P / g.p_t, Ro = R / g.r_t;
  g.Qo = (int)(Q / g.q_t);
  if (!dense(dx, wgrad ? Po : Ro, wgrad) || !dense(dy, g.Qo, false) || !dense(dc, g.Qo, false))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tz, ty;
  int e;
  // the experts' slices follow one another, so each map folds them into
  // its outer tile dimension (a sixth dimension would pass TMA's five)
  if (wgrad) {   // dZ [E Ro, Po, r_t, p_t]
    e = encode_mn(&tx, x, experts * Ro, Po, g.r_t, g.p_t, kBM / 64);
    if (!e && z) e = encode_mn(&tz, z, experts * Ro, Po, g.r_t, g.p_t, kBM / 64);
  } else {       // dZ [E Po, Ro, p_t, r_t], K-major: 64 of r by 256 rows of p
    const cuuint32_t k_box[4] = {(cuuint32_t)kBK, (cuuint32_t)g.p_t, 1,
                                 (cuuint32_t)(kBM / g.p_t)};
    e = encode(&tx, x, experts * Po, Ro, g.p_t, g.r_t, k_box);
    if (!e && z) e = encode(&tz, z, experts * Po, Ro, g.p_t, g.r_t, k_box);
  }
  // Y [E Ro, Qo, r_t, q_t]
  if (!e) e = encode_mn(&ty, y, experts * Ro, g.Qo, g.r_t, g.q_t, kBN / 64);
  if (e) return e;
  if (!z) tz = tx;
  if (experts > 1)   // no bias (refused above)
    return wgrad ? launch_wgmma<true, false, true>(tx, tz, ty, c, nullptr, g, act, stream)
                 : launch_wgmma<false, false, true>(tx, tz, ty, c, nullptr, g, act, stream);
  if (!wgrad) return launch_wgmma<false, false, false>(tx, tz, ty, c, nullptr, g, act, stream);
  return dbias ? launch_wgmma<true, true, false>(tx, tz, ty, c, dbias, g, act, stream)
               : launch_wgmma<true, false, false>(tx, tz, ty, c, nullptr, g, act, stream);
}

int launch_f32(const void* x, const void* z, const void* y, void* c, void* dbias,
               int64_t P, int64_t Q, int64_t R, const int64_t* desc, int x_contig_p,
               int act, int experts, cudaStream_t stream) {
  const Desc dx = desc_of(desc), dy = desc_of(desc + 6), dc = desc_of(desc + 12);
  const dim3 grid((unsigned)((Q + BQ - 1) / BQ), (unsigned)((P + BP - 1) / BP),
                  (unsigned)experts);
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
// splits: bfloat16's reduction ranges per output tile, one block each in a
// cluster (kernels/mmt4d/ops.py:pick_grad_split; 1 for float32).  experts:
// the product repeated over that many dense packed slices of X, Z, Y, C
// and dbias, which follow one another (the expert-batched linears: dZ [E,
// M_o, N_o, m_r, n_r], A_pack and B_pack [E, ...]), the expert in the grid.
extern "C" int repro_packed_gemm(const void* x, const void* z, const void* y,
                                 void* c, void* dbias, int dtype, int64_t P,
                                 int64_t Q, int64_t R, const int64_t* desc,
                                 int x_contig_p, int act, int splits, int experts,
                                 void* stream) {
  if (P < 0 || Q < 0 || R < 0 || P > INT32_MAX || Q > INT32_MAX || R > INT32_MAX ||
      experts < 1 || experts > 65535 ||
      (P + BP - 1) / BP > 65535 || act < kNone || act > kTanh ||
      (act != kNone && z == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < 3; ++d)
    if (desc[6 * d + 1] < 1 || desc[6 * d + 4] < 1) return (int)cudaErrorInvalidValue;
  if (P == 0 || Q == 0) return 0;
  if (dtype == repro::kF32)
    return splits == 1
               ? launch_f32(x, z, y, c, dbias, P, Q, R, desc, x_contig_p, act, experts,
                            (cudaStream_t)stream)
               : (int)cudaErrorInvalidValue;
  if (dtype == repro::kBF16)
    return launch_tc(x, z, y, c, dbias, P, Q, R, desc, x_contig_p, act, splits, experts,
                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
