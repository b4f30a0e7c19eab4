// Shared device code of the expm-product chain kernels: K1 forward
// (chain_fwd.cu) and K2 adjoint (chain_bwd.cu) of the basis chain, K5
// forward (plane_fwd.cu) and adjoint (plane_bwd.cu) of the plane chain. The
// four differ only in where a step's generator comes from (a weighted sum
// of a resident basis, or a plane streamed from device memory); the tile
// map, the products, the Taylor ladder, its dual-number form and the chain
// and adjoint steps are here.
//
// Layout. One thread block advances one segment chain; each of its NTH
// threads owns a fixed tile of every DP x DP complex matrix (TileMap): rows
// warp + W r (W = NTH / 32 warps, r < DP / W), columns lane + 32 c (c < 2).
// The forward kernels run NT = 256 threads (8 x 2 tiles), the adjoint
// kernels NTA = 512 (4 x 2 tiles; Adjoint below). Matrices are complex64
// (float2) in native complex arithmetic, row-major, 32 KB each at DP = 64.
// A product C = X Y reads X rows as float4 broadcasts (every lane of a warp
// reads the same address) and Y rows as consecutive float2 across lanes, so
// the shared-memory reads are conflict-free; each thread accumulates its own
// tile in registers (FP32 SIMT FMAs, no tensor cores, no TF32).
//
// The bf16_3x mode (QOC_TPU_MXU_PRECISION=bf16_3x, ops/chain.py): every
// kernel here has a second form (FwdTC, the Adjoint with TC = true) whose
// products run on the tensor cores as 3 x TF32 (mma.sync m16n8k8): each
// real product is x_hi y_hi + x_hi y_lo + x_lo y_hi of operands split to
// TF32 by rounding to nearest, ties away from zero (mm_acc_3x). Its threads
// own the mma accumulator fragments (MmaMap), and one map serves every
// product, epilogue and elementwise pass of a form. At degree 12 the mode
// takes the 4-product scheme _D12A in place of Paterson-Stockmeyer,
// forward and adjoint alike. The tensor
// cores' FP32 sums round toward zero, a bias that a chain of thousands of
// steps would compound where a product's result is dominated by one term
// (U P with U near I, X X in the squarings): so each k8 partial joins its
// accumulator by a rounding FP32 add, a chain step is P + (U - I) P (T +
// (U^H - I) T in the adjoint) and a squaring works on D = X - I, X^2 = I +
// 2 D + D D. The plain versions (ops/chain.py) form the same sums.
//
// Largest dimension: DP = 64. The backward keeps 7 matrices in shared
// memory (7 x 32 KB = 224 KB of the 227 KB a block may use), so a larger DP
// needs another design; the Python wrapper raises ValueError for d > 64 and
// zero-pads smaller d to 64, which is exact (exp of a block-diagonal
// generator stays block-diagonal).
//
// Numerics follow the TPU kernels exactly (qoc_tpu/ops/expm_pallas.py):
// the f32 Taylor ladder (degrees 4/8/12/19 at batch-max 1-norm thresholds
// 0.05/0.45/1.2/3.0), the 3-product degree-8 scheme _D8X, Paterson-
// Stockmeyer for degrees 12 and 19, and above 3.0 per-matrix scaling to
// theta = 1 with T19 and squarings. The batch-max norm arrives by pointer
// (computed on the device by the caller), so choosing the degree costs the
// host no synchronisation.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace qoc {

constexpr int DP = 64;          // padded matrix dimension
constexpr int NT = 256;         // threads per block of the forward kernels
constexpr int NTA = 512;        // threads per block of the adjoint kernels
constexpr int MAT = DP * DP;    // elements per matrix
constexpr int MAX_SQUARINGS = 60;
// Scratch of the per-matrix 1-norm: one column-sum maximum per warp of the
// first DP threads.
constexpr size_t RED_BYTES = 4 * sizeof(float);
// Dynamic shared memory of the forward kernels (P, M, M2, M3, M4, X) and of
// the adjoint kernels (T, U^H / value, tangent and the dual ladder).
constexpr size_t FWD_SMEM = 6 * MAT * sizeof(float2) + RED_BYTES;
constexpr size_t BWD_SMEM = 7 * MAT * sizeof(float2) + RED_BYTES;
// K4 at D = 64: the dual ladder's six slots (no adjoint T).
constexpr size_t DUAL_SMEM = 6 * MAT * sizeof(float2) + RED_BYTES;
// Per-block device-memory stash of the adjoint: the Paterson-Stockmeyer
// chunks below the top one, value and tangent (4 at degree 12, 8 at 19).
constexpr int STASH_SLOTS = 8;

// 1/k!, k = 0..19, rounded to float as the TPU kernels use them.
static __constant__ float kC[20] = {
    1.0f, 1.0f, (float)(1.0 / 2), (float)(1.0 / 6), (float)(1.0 / 24),
    (float)(1.0 / 120), (float)(1.0 / 720), (float)(1.0 / 5040),
    (float)(1.0 / 40320), (float)(1.0 / 362880), (float)(1.0 / 3628800),
    (float)(1.0 / 39916800), (float)(1.0 / 479001600),
    (float)(1.0 / 6227020800.0), (float)(1.0 / 87178291200.0),
    (float)(1.0 / 1307674368000.0), (float)(1.0 / 20922789888000.0),
    (float)(1.0 / 355687428096000.0), (float)(1.0 / 6402373705728000.0),
    (float)(1.0 / 121645100408832000.0)};

// Degree-8 Taylor in 3 products (qoc_tpu/ops/expm_pallas.py _D8X):
//   A2 = M^2;  A4 = A2 (x1 M + x2 A2);
//   A8 = (x3 A2 + A4)(x4 I + x5 M + x6 A2 + x7 A4);
//   T8 = y0 I + y1 M + y2 A2 + A8.
static __constant__ float kD8[10] = {
    (float)-0.2791515105738877, (float)-0.06978787764347194,
    (float)1.9965103670821102, (float)-1.0443935504465197,
    (float)-0.06254782056757438, (float)-0.024382370915357013,
    (float)0.005092363918911529, 1.0f, 1.0f, (float)2.585142563711936};

// Degree-12 Taylor in 4 products (expm_pallas.py _D12A), the bf16_3x
// mode's degree 12: lin(i) = a_i0 I + a_i1 M + a_i2 M2 + a_i3 M3 (kD12[4 i
// ..]), M2 = M M, M3 = M2 M;  A6 = lin(2) + lin(3)^2;
// T12 = lin(0) + (lin(1) + A6) A6. Evaluated as ops/chain.py _taylor12_4
// does, with the constants of A6 and Y = lin(1) + A6 taken out (A6 = A6' +
// a20 I, Y = Y' + y0 I): T12 = c0 I + lin'(0) + Y' A6' + a20 Y' + y0 A6',
// lin' without its constant; c0 = a00 + y0 a20 rounds to 1, so exp(0) = I
// exactly (kD12C = {c0, y0}).
#define QOC_D12A_A00 2.50924541e+00
#define QOC_D12A_A10 5.58758752e+00
#define QOC_D12A_A20 -2.84603020e-01
static __constant__ float kD12[16] = {
    (float)QOC_D12A_A00, 2.50145758e+00f, 6.68628695e-01f, 6.22278884e-02f,
    (float)QOC_D12A_A10, 1.71336946e+00f, 1.60849759e-01f, -1.44147961e-03f,
    (float)QOC_D12A_A20, -2.02022795e-01f, 1.89875093e-02f, 1.23719677e-02f,
    0.0f, 1.31810610e-01f, 2.02785554e-02f, 6.75951847e-03f};
static __constant__ float kD12C[2] = {
    (float)(QOC_D12A_A00 + (QOC_D12A_A10 + QOC_D12A_A20) * QOC_D12A_A20),
    (float)(QOC_D12A_A10 + QOC_D12A_A20)};

// Ladder level from the batch-max norm: 0..3 = degree 4/8/12/19 without
// squaring, 4 = per-matrix scaling and squaring with T19.
__device__ __forceinline__ int ladder_level(float n) {
  if (n <= 0.05f) return 0;
  if (n <= 0.45f) return 1;
  if (n <= 1.2f) return 2;
  if (n <= 3.0f) return 3;
  return 4;
}

// The tile a thread of an NTH-thread block owns (see the file note).
template <int NTH>
struct TileMap {
  static constexpr int W = NTH / 32;     // warps
  static constexpr int RPT = DP / W;     // tile rows per thread
  static constexpr int CPT = DP / 32;    // tile columns per thread
  static constexpr int EPT = RPT * CPT;  // tile elements per thread
  // Linear index of tile element e of the calling thread.
  static __device__ __forceinline__ int own(int e) {
    const int r = e / CPT, c = e % CPT;
    return ((threadIdx.x >> 5) + W * r) * DP + (threadIdx.x & 31) + 32 * c;
  }
  static __device__ __forceinline__ float eye(int e) {
    const int i = own(e);
    return (i / DP == i % DP) ? 1.0f : 0.0f;
  }
  // Shared-memory layout: row-major as it is (own and the device index
  // gown coincide).
  static __device__ __forceinline__ int phys(int i) { return i; }
  static __device__ __forceinline__ int gown(int e) { return own(e); }
};

// The bf16_3x mode's map: the accumulator fragments of mma.m16n8k8. Warp w
// owns MT x NTL tiles of 16 x 8 (rows row0() + 16 mt, columns col0() +
// 8 nt); lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, columns
// 2 t and 2 t + 1 of each: 32 x 16 a warp at 256 threads, 16 x 16 at 512.
// With SW its matrices in shared memory are swizzled: the 16-byte chunk j
// (two complex elements) of row r sits at chunk j ^ swz(r) of the row
// (phys), so that mm_acc_3x's fragment reads of 8 rows, or of 4 rows two
// by two, fall on distinct banks. own(e) is element e's shared-memory
// index, gown its index in a row-major matrix in device memory. The
// forwards (256 threads) swizzle; the adjoints (512 threads) do not: at
// their 128-register cap the swizzle made ptxas spill 316-556 B, which
// cost more than the conflicts (PERF.md).
template <int NTH, bool SW = (NTH == NT)>
struct MmaMap {
  static constexpr int W = NTH / 32;
  static constexpr int NTL = 2;                    // n8 tiles a warp
  static constexpr int MT = MAT / (W * NTL * 128);  // m16 tiles a warp
  static constexpr int WC = DP / (8 * NTL);         // warps across a row
  static constexpr int EPT = MT * NTL * 4;
  static_assert(MT >= 1 && W * EPT * 32 == MAT, "MmaMap: bad block size");
  static __device__ __forceinline__ int row0() {
    return (threadIdx.x >> 5) / WC * 16 * MT;
  }
  static __device__ __forceinline__ int col0() {
    return (threadIdx.x >> 5) % WC * 8 * NTL;
  }
  // The chunk swizzle of row r: a permutation of each aligned group of 8
  // chunks (128 bytes, every bank once).
  static __device__ __forceinline__ int swz(int r) {
    if constexpr (SW) return (r & 6) ^ ((r & 1) << 2);
    return 0;
  }
  static __device__ __forceinline__ int phys(int i) {
    if constexpr (!SW) return i;
    const int r = i / DP, c = i % DP;
    return r * DP + ((((c >> 1) ^ swz(r)) << 1) | (c & 1));
  }
  // Row-major index of fragment element e: tile e / 4, its c[e % 4].
  static __device__ __forceinline__ int gown(int e) {
    const int tile = e >> 2, q = e & 3, lane = threadIdx.x & 31;
    return (row0() + 16 * (tile / NTL) + (lane >> 2) + 8 * (q >> 1)) * DP +
           col0() + 8 * (tile % NTL) + 2 * (lane & 3) + (q & 1);
  }
  // phys(gown(e)), from the fragment's shape: its rows are g and g + 8
  // past multiples of 8 (one swz(g) for all), its chunks 4 nt + t of the
  // warp's aligned group of 8 (col0 / 2 is a multiple of 8).
  static __device__ __forceinline__ int own(int e) {
    const int tile = e >> 2, q = e & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    return (row0() + 16 * (tile / NTL) + g + 8 * (q >> 1)) * DP + col0() +
           2 * ((4 * (tile % NTL) + t) ^ swz(g)) + (q & 1);
  }
  static __device__ __forceinline__ float eye(int e) {
    const int i = gown(e);
    return (i / DP == i % DP) ? 1.0f : 0.0f;
  }
};

// The map of an instantiation: TileMap, or MmaMap in the bf16_3x mode (TC).
template <int NTH, bool TC>
using MapOf = std::conditional_t<TC, MmaMap<NTH>, TileMap<NTH>>;

// The forward kernels' map.
constexpr int RPT = TileMap<NT>::RPT;
constexpr int CPT = TileMap<NT>::CPT;
constexpr int EPT = TileMap<NT>::EPT;

__device__ __forceinline__ int own(int e) { return TileMap<NT>::own(e); }
__device__ __forceinline__ float eye(int e) { return TileMap<NT>::eye(e); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cscale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}

// s * a + b
__device__ __forceinline__ float2 caxpy(float s, float2 a, float2 b) {
  return make_float2(fmaf(s, a.x, b.x), fmaf(s, a.y, b.y));
}

// s * a + b on two complex elements (four floats).
__device__ __forceinline__ float4 axpy4(float s, float4 a, float4 b) {
  return make_float4(fmaf(s, a.x, b.x), fmaf(s, a.y, b.y), fmaf(s, a.z, b.z),
                     fmaf(s, a.w, b.w));
}

template <int N>
__device__ __forceinline__ void zero(float2 (&acc)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += X Y for DP x DP complex X, Y in shared memory, on the calling
// thread's tile of an NTH-thread block, U k-pairs an iteration.
template <int NTH = NT, int U = 2>
__device__ __forceinline__ void mm_acc(
    const float2* __restrict__ X, const float2* __restrict__ Y,
    float2 (&acc)[TileMap<NTH>::EPT]) {
  using T = TileMap<NTH>;
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll 1
  for (int k0 = 0; k0 < DP; k0 += 2 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + 2 * u;
      float4 a[T::RPT];
#pragma unroll
      for (int r = 0; r < T::RPT; ++r)
        a[r] = *reinterpret_cast<const float4*>(X + (ty + T::W * r) * DP + k);
      float2 b0[T::CPT], b1[T::CPT];
#pragma unroll
      for (int c = 0; c < T::CPT; ++c) {
        b0[c] = Y[k * DP + tx + 32 * c];
        b1[c] = Y[(k + 1) * DP + tx + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < T::RPT; ++r) {
#pragma unroll
        for (int c = 0; c < T::CPT; ++c) {
          float2& o = acc[r * T::CPT + c];
          o.x = fmaf(a[r].x, b0[c].x, o.x);
          o.x = fmaf(-a[r].y, b0[c].y, o.x);
          o.x = fmaf(a[r].z, b1[c].x, o.x);
          o.x = fmaf(-a[r].w, b1[c].y, o.x);
          o.y = fmaf(a[r].x, b0[c].y, o.y);
          o.y = fmaf(a[r].y, b0[c].x, o.y);
          o.y = fmaf(a[r].z, b1[c].y, o.y);
          o.y = fmaf(a[r].w, b1[c].x, o.y);
        }
      }
    }
  }
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero.
// cvt leaves the 13 low bits of its result undefined (the mma ignores
// them); they are cleared here, so that x - hi below is the true remainder.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// x = hi + lo, hi = tf32(x), lo = tf32(x - hi): ops/chain.py _split_tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b on one 16 x 8 x 8 TF32 tile (FP32 accumulate).
__device__ __forceinline__ void mma_tf32(float& c0, float& c1, float& c2,
                                         float& c3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += x_hi y_lo + x_lo y_hi, the small passes of the 3 x TF32 product.
__device__ __forceinline__ void mma_small(float (&c)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  mma_tf32(c[0], c[1], c[2], c[3], ah, bl[0], bl[1]);
  mma_tf32(c[0], c[1], c[2], c[3], al, bh[0], bh[1]);
}

// x = hi + lo as split_tf32 forms them, by integer rounding on the bits
// (half a TF32 unit added to the magnitude, as ops/chain.py _tf32): hi with
// its 13 low bits cleared, so that x - hi is the true remainder, lo with
// them left, since the mma ignores them and reads rna-tf32(x - hi). Four
// instructions where split_tf32 takes five.
__device__ __forceinline__ void split_3x(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// acc += X0 Y0 (+ X1 Y1: with X1, the product of depth 2 DP [X0 X1]
// [Y0; Y1] a dual product's tangent pass is) in the bf16_3x mode, on the
// calling thread's fragments of the MmaMap T. A k8 step of the mma takes
// k0 + 2 t as its k = t and k0 + 2 t + 1 as its k = t + 4 (a product may
// order k as it likes), so one float4 read gives a lane both of its X
// elements of a row. Each operand element is split by split_3x
// (ops/chain.py _split_tf32); Zr = Xr Yr - Xi Yi and Zi = Xr Yi + Xi Yr
// take 12 mma a tile and k8 step. The tensor cores' sums round toward
// zero: each k8 step sums into fresh registers, the small passes first and
// the x_hi y_hi passes last, and that partial joins acc by an FP32 add that
// rounds to nearest, so one truncation a real product and k8 step is at the
// partial's scale. Zi's mma read B's imaginary part (Y, NTL x 2 values a
// lane) as it is; it is then negated in its own registers for Zr's, where
// negating A's would take MT x 4. X and Y are in T's layout: swizzled (the
// forwards), a quarter-warp's X chunks and a half-warp's Y elements each
// fill the 32 banks once; row-major (the adjoints), X's reads of 8 rows
// share 16 banks and Y's of 4 rows 8. (A k-loop pipelined by one k8 step,
// its fragments loaded while this step's mma issue, needs 24 more
// registers a thread and was slower at 512 threads and at 256, for the
// adjoints and the forwards, PERF.md.)
template <class T>
__device__ __forceinline__ void mm_acc_3x(
    const float2* __restrict__ X0, const float2* __restrict__ Y0,
    const float2* __restrict__ X1, const float2* __restrict__ Y1,
    float2 (&acc)[T::EPT]) {
  constexpr int KS = DP / 8;  // k8 steps of a DP-deep product
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // X: rows row0 + 16 mt + 8 h + g (swz of g alone), chunk k0 / 2 + t at
  // k0 ^ ua. Y: rows k0 + 2 t + j (swz of 2 t + j), column col0 + 8 nt + g
  // at k0 DP + yo[j][nt].
  const int xo = (T::row0() + g) * DP;
  const int ua = 2 * (t ^ T::swz(g));
  int yo[2][T::NTL];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int nt = 0; nt < T::NTL; ++nt)
      yo[j][nt] = (2 * t + j) * DP + T::col0() +
                  2 * ((4 * nt + (g >> 1)) ^ T::swz(2 * t + j)) + (g & 1);
  }
  const int steps = X1 == nullptr ? KS : 2 * KS;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int k0 = 8 * (s % KS);
    const float2* X = (s < KS ? X0 : X1) + xo + (k0 ^ ua);
    const float2* Y = (s < KS ? Y0 : Y1) + k0 * DP;
    float4 xv[T::MT][2];
    float2 yv[T::NTL][2];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[mt][h] =
            *reinterpret_cast<const float4*>(X + (16 * mt + 8 * h) * DP);
    }
#pragma unroll
    for (int nt = 0; nt < T::NTL; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) yv[nt][j] = Y[yo[j][nt]];
    }
    // A fragments (a0, a1, a2, a3) = rows (g, g + 8, g, g + 8) at k
    // (t, t, t + 4, t + 4), real and imaginary, hi and lo.
    uint32_t arh[T::MT][4], arl[T::MT][4], aih[T::MT][4], ail[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = xv[mt][h];
        split_3x(v.x, arh[mt][h], arl[mt][h]);
        split_3x(v.y, aih[mt][h], ail[mt][h]);
        split_3x(v.z, arh[mt][2 + h], arl[mt][2 + h]);
        split_3x(v.w, aih[mt][2 + h], ail[mt][2 + h]);
      }
    }
    // B fragments (b0, b1) = rows k0 + 2 t, k0 + 2 t + 1 at column g.
    uint32_t brh[T::NTL][2], brl[T::NTL][2], bih[T::NTL][2], bil[T::NTL][2];
#pragma unroll
    for (int nt = 0; nt < T::NTL; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        split_3x(yv[nt][j].x, brh[nt][j], brl[nt][j]);
        split_3x(yv[nt][j].y, bih[nt][j], bil[nt][j]);
      }
    }
    // Each partial's mma: Zi's use B's imaginary part as it is, then it is
    // negated in place for the rest of Zr's.
#pragma unroll
    for (int nt = 0; nt < T::NTL; ++nt) {
      float re[T::MT][4], im[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) re[mt][q] = im[mt][q] = 0.0f;
        mma_small(re[mt], arh[mt], arl[mt], brh[nt], brl[nt]);
        mma_small(im[mt], arh[mt], arl[mt], bih[nt], bil[nt]);
        mma_small(im[mt], aih[mt], ail[mt], brh[nt], brl[nt]);
        mma_tf32(im[mt][0], im[mt][1], im[mt][2], im[mt][3], arh[mt],
                 bih[nt][0], bih[nt][1]);
        mma_tf32(im[mt][0], im[mt][1], im[mt][2], im[mt][3], aih[mt],
                 brh[nt][0], brh[nt][1]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bih[nt][j] ^= 0x80000000u;
        bil[nt][j] ^= 0x80000000u;
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        mma_small(re[mt], aih[mt], ail[mt], bih[nt], bil[nt]);
        mma_tf32(re[mt][0], re[mt][1], re[mt][2], re[mt][3], arh[mt],
                 brh[nt][0], brh[nt][1]);
        mma_tf32(re[mt][0], re[mt][1], re[mt][2], re[mt][3], aih[mt],
                 bih[nt][0], bih[nt][1]);
        float2* c = acc + 4 * (mt * T::NTL + nt);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c[q].x = __fadd_rn(c[q].x, re[mt][q]);
          c[q].y = __fadd_rn(c[q].y, im[mt][q]);
        }
      }
    }
  }
}

// Z = v on the calling thread's elements of Map.
template <class Map>
__device__ __forceinline__ void store_map(float2* Z,
                                          const float2 (&v)[Map::EPT]) {
#pragma unroll
  for (int e = 0; e < Map::EPT; ++e) Z[Map::own(e)] = v[e];
}

// M = sum_k w[k] G_k on the calling thread's tile; G is (n_b, DP, DP) in
// device memory (L2-resident across the steps of every block). KU terms a
// loop iteration (their loads in flight together), then the rest one by
// one.
template <int NTH = NT, int KU = 1, class Map = TileMap<NTH>>
__device__ __forceinline__ void build_generator(float2* M,
                                                const float* __restrict__ w,
                                                const float2* __restrict__ G,
                                                int n_b) {
  using T = TileMap<NTH>;
  float2 v[T::EPT];
  zero(v);
  int k = 0;
  if constexpr (KU > 1) {
    for (; k + KU <= n_b; k += KU) {
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const float wk = __ldg(w + k + u);
        const float2* g = G + (size_t)(k + u) * MAT;
#pragma unroll
        for (int e = 0; e < T::EPT; ++e)
          v[e] = caxpy(wk, __ldg(g + T::own(e)), v[e]);
      }
    }
  }
  for (; k < n_b; ++k) {
    const float wk = __ldg(w + k);
    const float2* g = G + (size_t)k * MAT;
#pragma unroll
    for (int e = 0; e < T::EPT; ++e)
      v[e] = caxpy(wk, __ldg(g + T::own(e)), v[e]);
  }
#pragma unroll
  for (int e = 0; e < T::EPT; ++e) M[Map::phys(T::own(e))] = v[e];
}

// M = X for a DP x DP matrix X in device memory, on the calling thread's
// tile (coalesced reads), into Map's shared-memory layout.
template <int NTH = NT, class Map = TileMap<NTH>>
__device__ __forceinline__ void load(float2* M,
                                     const float2* __restrict__ X) {
  using T = TileMap<NTH>;
#pragma unroll
  for (int e = 0; e < T::EPT; ++e)
    M[Map::phys(T::own(e))] = __ldg(X + T::own(e));
}

// Squaring count of M (shared memory) from its complex 1-norm:
// s = clip(ceil(log2(max(||M||_1 / 1.0, 1))), 0, 60), as _scaling_count.
// The first DP threads sum one column each; ends with a barrier; every
// thread gets the same s. M in Map's layout.
template <class Map>
__device__ __forceinline__ int scaling_count(const float2* M, float* red) {
  if (threadIdx.x < DP) {
    float s = 0.0f;
    for (int i = 0; i < DP; ++i) {
      const float2 v = M[Map::phys(i * DP + threadIdx.x)];
      s += sqrtf(v.x * v.x + v.y * v.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  }
  __syncthreads();
  const float n1 = fmaxf(red[0], red[1]);
  float s = ceilf(log2f(fmaxf(n1 / 1.0f, 1.0f)));
  s = fminf(fmaxf(s, 0.0f), (float)MAX_SQUARINGS);
  return (int)s;
}


// ---------------------------------------------------------------------------
// Forward: exp(M) by the ladder and the chain step (K1, K5 forward; K3 at
// D = 64), on NT threads: Fwd exact, FwdTC in the bf16_3x mode. The kernels
// take a form F and call F::chain (K1, K5) or F::expm_batch (K3).
// ---------------------------------------------------------------------------

// Where a forward chain's generators come from: a weighted sum of a basis
// (K1: w (L, n_b) of the block's chain, basis (n_b, DP, DP)), or planes
// (K5: a (L, DP, DP) of the block's chain).
struct BasisSource {
  static constexpr bool PLANES = false;
  const float* w;
  const float2* basis;
  int n_b;
};
struct PlaneSource {
  static constexpr bool PLANES = true;
  const float2* a;
};

// The exact form: TileMap<NT>, SIMT products, Paterson-Stockmeyer at degree
// 12.
struct Fwd {
  using Map = TileMap<NT>;
  static constexpr int THREADS = NT;
  static constexpr size_t SMEM = FWD_SMEM;
  static constexpr int EP = Map::EPT;

  static __device__ __forceinline__ int own(int e) { return Map::own(e); }
  static __device__ __forceinline__ float eye(int e) { return Map::eye(e); }

  // acc = X Y
  static __device__ __forceinline__ void mm(const float2* X, const float2* Y,
                                            float2 (&acc)[EP]) {
    zero(acc);
    mm_acc<NT, 2>(X, Y, acc);
  }

  static __device__ __forceinline__ void store(float2* Z,
                                               const float2 (&v)[EP]) {
    store_map<Map>(Z, v);
  }

  // chunk(k) = c_k I + c_{k+1} M + c_{k+2} M2 + c_{k+3} M3 on element e.
  static __device__ __forceinline__ float2 chunk(int k, int e,
                                                 const float2* M,
                                                 const float2* M2,
                                                 const float2* M3) {
    const int i = own(e);
    float2 v = caxpy(kC[k + 1], M[i], make_float2(kC[k] * eye(e), 0.0f));
    v = caxpy(kC[k + 2], M2[i], v);
    return caxpy(kC[k + 3], M3[i], v);
  }

  // M2 = M M, M3 = M2 M, M4 = M2 M2. Expects M written; ends with a
  // barrier.
  static __device__ __forceinline__ void powers(const float2* M, float2* M2,
                                                float2* M3, float2* M4) {
    float2 acc[EP];
    mm(M, M, acc);
    store(M2, acc);
    __syncthreads();
    mm(M2, M, acc);
    store(M3, acc);
    mm(M2, M2, acc);
    store(M4, acc);
    __syncthreads();
  }

  // Paterson-Stockmeyer degree 19 into X (powers already formed).
  static __device__ __forceinline__ void taylor19(const float2* M,
                                                  const float2* M2,
                                                  const float2* M3,
                                                  const float2* M4,
                                                  float2* X) {
    float2 acc[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) X[own(e)] = chunk(16, e, M, M2, M3);
    __syncthreads();
    for (int k = 12; k >= 0; k -= 4) {
      mm(X, M4, acc);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EP; ++e)
        X[own(e)] = cadd(acc[e], chunk(k, e, M, M2, M3));
      __syncthreads();
    }
  }

  // exp(M) for the generator M in shared memory (written, behind a
  // barrier). Returns the buffer that holds the result; ends with a barrier.
  static __device__ float2* expm(float2* M, float2* M2, float2* M3,
                                 float2* M4, float2* X, int level,
                                 float* red) {
    float2 acc[EP];
    if (level == 0) {
      // Degree 4: M2 = M M; U = c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2).
      mm(M, M, acc);
      store(M2, acc);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        const int i = own(e);
        M3[i] = caxpy(kC[4], M2[i], cscale(kC[3], M[i]));
      }
      __syncthreads();
      mm(M2, M3, acc);
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        const int i = own(e);
        float2 v = caxpy(kC[1], M[i], make_float2(kC[0] * eye(e), 0.0f));
        X[i] = cadd(caxpy(kC[2], M2[i], v), acc[e]);
      }
      __syncthreads();
      return X;
    }
    if (level == 1) {
      // Degree 8 in 3 products (_D8X).
      mm(M, M, acc);
      store(M2, acc);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        const int i = own(e);
        M3[i] = caxpy(kD8[1], M2[i], cscale(kD8[0], M[i]));
      }
      __syncthreads();
      mm(M2, M3, acc);  // A4
      store(M4, acc);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        const int i = own(e);
        const float2 m = M[i], m2 = M2[i], m4 = M4[i];
        const float id = eye(e);
        M3[i] = caxpy(kD8[2], m2, m4);  // left factor x3 A2 + A4
        float2 r = caxpy(kD8[4], m, make_float2(kD8[3] * id, 0.0f));
        r = caxpy(kD8[5], m2, r);
        X[i] = caxpy(kD8[6], m4, r);  // right factor
        float2 b = caxpy(kD8[8], m, make_float2(kD8[7] * id, 0.0f));
        M2[i] = caxpy(kD8[9], m2, b);  // y0 I + y1 M + y2 A2
      }
      __syncthreads();
      mm(M3, X, acc);
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        const int i = own(e);
        M[i] = cadd(M2[i], acc[e]);
      }
      __syncthreads();
      return M;
    }
    if (level == 2) {
      // Degree 12, Paterson-Stockmeyer (5 products).
      powers(M, M2, M3, M4);
#pragma unroll
      for (int e = 0; e < EP; ++e)
        X[own(e)] = caxpy(kC[12], M4[own(e)], chunk(8, e, M, M2, M3));
      __syncthreads();
      for (int k = 4; k >= 0; k -= 4) {
        mm(M4, X, acc);
        __syncthreads();
#pragma unroll
        for (int e = 0; e < EP; ++e)
          X[own(e)] = cadd(chunk(k, e, M, M2, M3), acc[e]);
        __syncthreads();
      }
      return X;
    }
    int s = 0;
    if (level == 4) {
      // Per-matrix scaling to theta = 1, then T19 and s squarings.
      s = scaling_count<Map>(M, red);
      const float scale = exp2f(-(float)s);
#pragma unroll
      for (int e = 0; e < EP; ++e) M[own(e)] = cscale(scale, M[own(e)]);
      __syncthreads();
    }
    powers(M, M2, M3, M4);
    taylor19(M, M2, M3, M4, X);
    for (int j = 0; j < s; ++j) {
      mm(X, X, acc);
      __syncthreads();
      store(X, acc);
      __syncthreads();
    }
    return X;
  }

  // P <- U P, also written to the prefix slot ``out`` in device memory. U
  // and P are in shared memory; ends with a barrier.
  static __device__ __forceinline__ void advance(float2* P, float2* U,
                                                 float2* __restrict__ out) {
    float2 acc[EP];
    mm(U, P, acc);
    __syncthreads();
    store(P, acc);
#pragma unroll
    for (int e = 0; e < EP; ++e) out[Map::gown(e)] = acc[e];
    __syncthreads();
  }

  // The chain P_t = exp(A_t) P_{t-1} from P_0 = I, A_t from src, P_t
  // written to out + t MAT (t = 1..L). sm: P, M, M2, M3, M4, X and red.
  template <class Src>
  static __device__ __forceinline__ void chain(float2* sm, const Src& src,
                                               int L, int level,
                                               float2* __restrict__ out) {
    float2* P = sm;
    float2* M = sm + MAT;
    float* red = reinterpret_cast<float*>(sm + 6 * MAT);
#pragma unroll
    for (int e = 0; e < EP; ++e) P[own(e)] = make_float2(eye(e), 0.0f);
    for (int t = 0; t < L; ++t) {
      if constexpr (Src::PLANES)
        load<NT, Map>(M, src.a + (size_t)t * MAT);
      else
        build_generator<NT, 1, Map>(M, src.w + (size_t)t * src.n_b,
                                    src.basis, src.n_b);
      __syncthreads();
      advance(P, expm(M, sm + 2 * MAT, sm + 3 * MAT, sm + 4 * MAT,
                      sm + 5 * MAT, level, red),
              out + (size_t)(t + 1) * MAT);
    }
  }

  // out[i] = exp(a[i]) for i = blockIdx.x, + gridDim.x, ... < B (DP x DP
  // each). sm: M, M2, M3, M4, X and red.
  static __device__ __forceinline__ void expm_batch(
      float2* sm, const float2* __restrict__ a, float2* __restrict__ out,
      int B, int level) {
    float2* M = sm;
    float* red = reinterpret_cast<float*>(sm + 5 * MAT);
    for (int m = blockIdx.x; m < B; m += gridDim.x) {
      load<NT, Map>(M, a + (size_t)m * MAT);
      __syncthreads();
      const float2* r = expm(M, sm + MAT, sm + 2 * MAT, sm + 3 * MAT,
                             sm + 4 * MAT, level, red);
#pragma unroll
      for (int e = 0; e < EP; ++e)
        out[(size_t)m * MAT + Map::gown(e)] = r[own(e)];
      __syncthreads();
    }
  }
};

// The bf16_3x mode's form, on NT threads and MmaMap<NT>'s swizzled
// fragments (32 x 16 a warp, 16 elements a thread). Its sums are the
// mode's (ops/chain.py): 3 x TF32 products with one rounding add of each
// k8 partial, _D12A at degree 12, squarings on D = X - I, the chain step
// P + (U - I) P; its products are mm_acc_3x's.
//
// Phases. Every epilogue writes only slots that no thread reads in the
// same phase (or its own elements of a slot that only it reads), so a
// product and the elementwise pass after it share a phase, and the passes
// go over a thread's elements two by two in 16-byte accesses: degree 4, 8
// and 12 take 2, 3 and 4 barriers. The ladder's last epilogue hands its
// value to fin: the chain keeps U - I (rounded as the step would form it,
// so that the step needs no pass of its own), K3 writes exp(M) out.
//
// Step. One phase forms P + (U - I) P into a free slot and the prefix in
// device memory, and brings the next step's generator into another free
// slot; the slots then rotate (chain). A plane is staged by cp.async
// issued before the product. A basis sum is built (build, KU terms' loads
// in flight, in PASSES passes over a thread's chunks) before the product by
// the first half of the warps when EARLY, after it by the rest, so that a
// scheduler's two warps wait on L2 and issue mma side by side. With PAIR a
// seventh slot holds a generator across a step: every other step one pass
// over the basis builds the next two steps' generators, half the basis
// reads a step.
//
// ABLATE (never set by the kernels, only by profiling/resident_variants.py)
// reduces every elementwise pass to a store of the product's accumulator
// (the results are then garbage): what is left is the step's products,
// barriers, generator build or staging and prefix write.
template <int KU, int PASSES, bool EARLY, bool PAIR, bool ABLATE = false>
struct FwdTC {
  using Map = MmaMap<NT>;
  static constexpr int THREADS = NT;
  static constexpr int SLOTS = PAIR ? 7 : 6;  // the chain's
  static constexpr size_t SMEM = SLOTS * MAT * sizeof(float2) + RED_BYTES;
  static constexpr int EP = Map::EPT;
  // The shape, for the design lines (qoc_forward_form).
  static constexpr int SHAPE[4] = {KU, PASSES, EARLY, PAIR};

  static __device__ __forceinline__ int own(int e) { return Map::own(e); }
  static __device__ __forceinline__ float eye(int e) { return Map::eye(e); }

  // f(e) for e = 0, 2, .., EP - 2: elements e and e + 1 are columns 2 t
  // and 2 t + 1 of an mma fragment, adjacent and 16-byte aligned in Map's
  // layout and, at gown(e), in a row-major matrix.
  template <class F>
  static __device__ __forceinline__ void pairs(F f) {
#pragma unroll
    for (int e = 0; e < EP; e += 2) f(e);
  }
  static __device__ __forceinline__ void get2(const float2* x, int e,
                                              float2 (&v)[2]) {
    const float4 q = *reinterpret_cast<const float4*>(x + own(e));
    v[0] = make_float2(q.x, q.y);
    v[1] = make_float2(q.z, q.w);
  }
  static __device__ __forceinline__ void put2(float2* x, int e,
                                              const float2 (&v)[2]) {
    *reinterpret_cast<float4*>(x + own(e)) =
        make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  }
  // Elements e, e + 1 to the row-major matrix z in device memory.
  static __device__ __forceinline__ void out2(float2* z, int e,
                                              const float2 (&v)[2]) {
    *reinterpret_cast<float4*>(z + Map::gown(e)) =
        make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  }
  static __device__ __forceinline__ void put(float2* x,
                                             const float2 (&v)[EP]) {
    pairs([&](int e) { put2(x, e, {v[e], v[e + 1]}); });
  }

  // acc = X Y
  static __device__ __forceinline__ void mm(const float2* X, const float2* Y,
                                            float2 (&acc)[EP]) {
    zero(acc);
    mm_acc_3x<Map>(X, Y, nullptr, nullptr, acc);
  }

  // epi(), or with ABLATE a store of acc to the slot x.
  template <class E>
  static __device__ __forceinline__ void epilogue(E epi,
                                                  const float2 (&acc)[EP],
                                                  float2* x) {
    if constexpr (ABLATE) put(x, acc);
    else epi();
  }

  // c_k I + c_{k+1} m + c_{k+2} m2 + c_{k+3} m3 on element e.
  static __device__ __forceinline__ float2 chunk(int k, int e, float2 m,
                                                 float2 m2, float2 m3) {
    float2 v = caxpy(kC[k + 1], m, make_float2(kC[k] * eye(e), 0.0f));
    v = caxpy(kC[k + 2], m2, v);
    return caxpy(kC[k + 3], m3, v);
  }

  // lin'(j) of _D12A (without its constant a_j0 I) from m, m2, m3.
  static __device__ __forceinline__ float2 lin(int j, float2 m, float2 m2,
                                               float2 m3) {
    const float* a = kD12 + 4 * j;
    return caxpy(a[3], m3, caxpy(a[2], m2, cscale(a[1], m)));
  }

  // exp(M) for the generator M in shared memory (written, behind a
  // barrier); M2, M3, M4 and X are scratch. The last epilogue calls
  // fin(R, e, v) with exp(M)'s elements e, e + 1 of the calling thread (v)
  // and R, a slot that no thread reads in that phase (M at level 1, else
  // X); returns R. Ends with a barrier.
  template <class Fin>
  static __device__ __forceinline__ float2* expm(float2* M, float2* M2,
                                                 float2* M3, float2* M4,
                                                 float2* X, int level,
                                                 float* red, Fin fin) {
    float2 acc[EP];
    if (level == 0) {
      // Degree 4: M2 = M M and Y = c3 M + c4 M2 (its epilogue);
      // c0 I + c1 M + c2 M2 + M2 Y.
      mm(M, M, acc);
      epilogue([&] {
        pairs([&](int e) {
          float2 m[2], y[2];
          get2(M, e, m);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            y[u] = caxpy(kC[4], acc[e + u], cscale(kC[3], m[u]));
          put2(M2, e, {acc[e], acc[e + 1]});
          put2(M3, e, y);
        });
      }, acc, M2);
      __syncthreads();
      mm(M2, M3, acc);
      epilogue([&] {
        pairs([&](int e) {
          float2 m[2], m2[2], v[2];
          get2(M, e, m);
          get2(M2, e, m2);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            v[u] = caxpy(kC[1], m[u], make_float2(kC[0] * eye(e + u), 0.0f));
            v[u] = cadd(caxpy(kC[2], m2[u], v[u]), acc[e + u]);
          }
          fin(X, e, v);
        });
      }, acc, X);
      __syncthreads();
      return X;
    }
    if (level == 1) {
      // Degree 8 in 3 products (_D8X): A2 = M M and Y = x1 M + x2 A2;
      // A4 = A2 Y, whose epilogue forms the factors x3 A2 + A4 (M4) and
      // x4 I + x5 M + x6 A2 + x7 A4 (X), and y0 I + y1 M + y2 A2 (M, the
      // thread's own elements); their product plus that sum.
      mm(M, M, acc);
      epilogue([&] {
        pairs([&](int e) {
          float2 m[2], y[2];
          get2(M, e, m);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            y[u] = caxpy(kD8[1], acc[e + u], cscale(kD8[0], m[u]));
          put2(M2, e, {acc[e], acc[e + 1]});
          put2(M3, e, y);
        });
      }, acc, M2);
      __syncthreads();
      mm(M2, M3, acc);  // A4
      epilogue([&] {
        pairs([&](int e) {
          float2 m[2], m2[2], l[2], r[2], b[2];
          get2(M, e, m);
          get2(M2, e, m2);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float id = eye(e + u);
            const float2 a4 = acc[e + u];
            l[u] = caxpy(kD8[2], m2[u], a4);
            float2 q = caxpy(kD8[4], m[u], make_float2(kD8[3] * id, 0.0f));
            q = caxpy(kD8[5], m2[u], q);
            r[u] = caxpy(kD8[6], a4, q);
            const float2 c =
                caxpy(kD8[8], m[u], make_float2(kD8[7] * id, 0.0f));
            b[u] = caxpy(kD8[9], m2[u], c);
          }
          put2(M4, e, l);
          put2(X, e, r);
          put2(M, e, b);
        });
      }, acc, M4);
      __syncthreads();
      mm(M4, X, acc);
      epilogue([&] {
        pairs([&](int e) {
          float2 b[2], v[2];
          get2(M, e, b);
#pragma unroll
          for (int u = 0; u < 2; ++u) v[u] = cadd(b[u], acc[e + u]);
          fin(M, e, v);
        });
      }, acc, M);
      __syncthreads();
      return M;
    }
    if (level == 2) {
      // Degree 12 in 4 products (_D12A, as kD12C says): M2 = M M; M3 =
      // M2 M, whose epilogue writes lin(3) to X; lin(3)^2, whose epilogue
      // forms A6' = lin'(2) + lin(3)^2 (M4), Y' = lin'(1) + A6' (M2) and
      // c0 I + lin'(0) (M, the thread's own elements); then c0 I +
      // lin'(0) + Y' A6' + a20 Y' + y0 A6'.
      mm(M, M, acc);
      epilogue([&] { put(M2, acc); }, acc, M2);
      __syncthreads();
      mm(M2, M, acc);
      epilogue([&] {
        pairs([&](int e) {
          float2 m[2], m2[2], l3[2];
          get2(M, e, m);
          get2(M2, e, m2);
#pragma unroll
          for (int u = 0; u < 2; ++u) l3[u] = lin(3, m[u], m2[u], acc[e + u]);
          put2(M3, e, {acc[e], acc[e + 1]});
          put2(X, e, l3);
        });
      }, acc, M3);
      __syncthreads();
      mm(X, X, acc);
      epilogue([&] {
        pairs([&](int e) {
          float2 m[2], m2[2], m3[2], a6[2], y[2], c[2];
          get2(M, e, m);
          get2(M2, e, m2);
          get2(M3, e, m3);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            a6[u] = cadd(lin(2, m[u], m2[u], m3[u]), acc[e + u]);
            y[u] = cadd(lin(1, m[u], m2[u], m3[u]), a6[u]);
            c[u] = cadd(make_float2(kD12C[0] * eye(e + u), 0.0f),
                        lin(0, m[u], m2[u], m3[u]));
          }
          put2(M4, e, a6);
          put2(M2, e, y);
          put2(M, e, c);
        });
      }, acc, M4);
      __syncthreads();
      mm(M2, M4, acc);
      epilogue([&] {
        pairs([&](int e) {
          float2 a6[2], y[2], c[2], v[2];
          get2(M4, e, a6);
          get2(M2, e, y);
          get2(M, e, c);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            v[u] = cadd(caxpy(kD12C[1], a6[u], caxpy(kD12[8], y[u], c[u])),
                        acc[e + u]);
          fin(X, e, v);
        });
      }, acc, X);
      __syncthreads();
      return X;
    }
    // Degree 19 by Paterson-Stockmeyer; at level 4 after per-matrix
    // scaling to theta = 1, and followed by s squarings.
    int s = 0;
    if (level == 4) {
      s = scaling_count<Map>(M, red);
      const float scale = exp2f(-(float)s);
      pairs([&](int e) {
        float2 m[2];
        get2(M, e, m);
        m[0] = cscale(scale, m[0]);
        m[1] = cscale(scale, m[1]);
        put2(M, e, m);
      });
      __syncthreads();
    }
    // M2 = M M; M3 = M2 M, whose epilogue writes the top chunk
    // c16 I + c17 M + c18 M2 + c19 M3 to X; M4 = M2 M2.
    mm(M, M, acc);
    epilogue([&] { put(M2, acc); }, acc, M2);
    __syncthreads();
    mm(M2, M, acc);
    epilogue([&] {
      pairs([&](int e) {
        float2 m[2], m2[2], x[2];
        get2(M, e, m);
        get2(M2, e, m2);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          x[u] = chunk(16, e + u, m[u], m2[u], acc[e + u]);
        put2(M3, e, {acc[e], acc[e + 1]});
        put2(X, e, x);
      });
    }, acc, M3);
    mm(M2, M2, acc);
    epilogue([&] { put(M4, acc); }, acc, M4);
    __syncthreads();
    for (int k = 12; k >= 0; k -= 4) {
      mm(X, M4, acc);
      __syncthreads();
      epilogue([&] {
        pairs([&](int e) {
          float2 m[2], m2[2], m3[2], v[2];
          get2(M, e, m);
          get2(M2, e, m2);
          get2(M3, e, m3);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            v[u] = cadd(acc[e + u], chunk(k, e + u, m[u], m2[u], m3[u]));
          if (k == 0 && s == 0) {
            fin(X, e, v);
            return;
          }
          if (k == 0) {
            // The squarings work on D = X - I: X^2 = I + 2 D + D D, so
            // the tensor cores' truncation scales with D D (ops/chain.py
            // _scale_and_square).
            v[0].x += -1.0f * eye(e);
            v[1].x += -1.0f * eye(e + 1);
          }
          put2(X, e, v);
        });
      }, acc, X);
      __syncthreads();
    }
    for (int j = 0; j < s; ++j) {
      mm(X, X, acc);
      __syncthreads();
      epilogue([&] {
        pairs([&](int e) {
          float2 d[2], v[2];
          get2(X, e, d);
#pragma unroll
          for (int u = 0; u < 2; ++u) v[u] = caxpy(2.0f, d[u], acc[e + u]);
          if (j + 1 < s) {
            put2(X, e, v);
            return;
          }
          v[0].x += 1.0f * eye(e);
          v[1].x += 1.0f * eye(e + 1);
          fin(X, e, v);
        });
      }, acc, X);
      __syncthreads();
    }
    return X;
  }

  // s = X (DP x DP in device memory) by cp.async in 16-byte chunks, into
  // Map's layout; the caller waits (cp_async_wait) before its barrier.
  static __device__ __forceinline__ void stage(float2* s,
                                               const float2* __restrict__ X) {
#pragma unroll
    for (int j = 0; j < MAT / 2 / NT; ++j) {
      const int q = 2 * (threadIdx.x + NT * j);
      cp_async16(s + Map::phys(q), X + q);
    }
    cp_async_commit();
  }

  // G0 = sum_k w0[k] B_k (and, TWO, G1 = sum_k w1[k] B_k from the same
  // loads) into Map's layout, B (n_b, DP, DP) in device memory
  // (L2-resident across the steps of every block): each thread sums the
  // 16-byte chunks threadIdx.x + NT c (c < 8) of every term, in PASSES
  // passes over its chunks, KU terms' loads in flight together; each
  // element sums its terms in order from zero, as build_generator does.
  template <bool TWO>
  static __device__ __forceinline__ void build(float2* G0, float2* G1,
                                               const float* __restrict__ w0,
                                               const float* __restrict__ w1,
                                               const float2* __restrict__ B,
                                               int n_b) {
    constexpr int CP = MAT / 2 / NT / PASSES;  // chunks a pass
    constexpr int TERM = MAT / 2;              // chunks a term
    constexpr int NG = TWO ? 2 : 1;
    float2* const G[2] = {G0, G1};
    const float* const w[2] = {w0, w1};
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const float4* b =
          reinterpret_cast<const float4*>(B) + threadIdx.x + NT * CP * pass;
      float4 v[NG][CP];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int c = 0; c < CP; ++c)
          v[j][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      int k = 0;
      for (; k + KU <= n_b; k += KU) {
        float4 g[KU][CP];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
#pragma unroll
          for (int c = 0; c < CP; ++c)
            g[u][c] = __ldg(b + (size_t)(k + u) * TERM + NT * c);
        }
#pragma unroll
        for (int u = 0; u < KU; ++u) {
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const float wk = __ldg(w[j] + k + u);
#pragma unroll
            for (int c = 0; c < CP; ++c) v[j][c] = axpy4(wk, g[u][c], v[j][c]);
          }
        }
      }
      for (; k < n_b; ++k) {
        float4 g[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c)
          g[c] = __ldg(b + (size_t)k * TERM + NT * c);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const float wk = __ldg(w[j] + k);
#pragma unroll
          for (int c = 0; c < CP; ++c) v[j][c] = axpy4(wk, g[c], v[j][c]);
        }
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int q = 2 * (threadIdx.x + NT * (CP * pass + c));
          *reinterpret_cast<float4*>(G[j] + Map::phys(q)) = v[j][c];
        }
      }
    }
  }

  // The chain P_t = exp(A_t) P_{t-1} from P_0 = I, A_t from src, P_t
  // written to out + t MAT (t = 1..L). sm: SLOTS slots and red; P starts in
  // slot 0, A_0 in 1 (with pairs A_1 in 6). A step: the ladder (leaving
  // U - I), then one phase that forms P + (U - I) P (ops/chain.py
  // _step_product; a step with U = I leaves P exactly as it was) into slot
  // m2 and the prefix, and brings A_{t+1} into slot m3 (with pairs, every
  // other step, A_{t+1} into m3 and A_{t+2} into h, and in between A_{t+1}
  // is already in h); then P = m2, M = m3 (or h), and the old P and M are
  // scratch.
  template <class Src>
  static __device__ __forceinline__ void chain(float2* sm, const Src& src,
                                               int L, int level,
                                               float2* __restrict__ out) {
    constexpr bool TWO = PAIR && !Src::PLANES;
    float* red = reinterpret_cast<float*>(sm + SLOTS * MAT);
    const bool early = EARLY && (threadIdx.x >> 5) < NT / 64;
    // A_t into slot g (TWO: and A_{t+1} into slot g2 where t + 1 < L):
    // part 0 before the step's product, part 1 after it.
    auto next = [&](int g, int g2, int t, int part) {
      if constexpr (Src::PLANES) {
        if (part == 0) stage(sm + g * MAT, src.a + (size_t)t * MAT);
        else cp_async_wait<0>();
      } else if ((part == 0) == early) {
        const float* w = src.w + (size_t)t * src.n_b;
        if (TWO && t + 1 < L)
          build<TWO>(sm + g * MAT, sm + g2 * MAT, w, w + src.n_b, src.basis,
                     src.n_b);
        else
          build<false>(sm + g * MAT, nullptr, w, nullptr, src.basis,
                       src.n_b);
      }
    };
    pairs([&](int e) {
      put2(sm, e, {make_float2(eye(e), 0.0f), make_float2(eye(e + 1), 0.0f)});
    });
    next(1, 6, 0, 0);
    next(1, 6, 0, 1);
    __syncthreads();
    // Slots: M4 and X are 4 and 5; h (TWO) holds A_{t+1} where have.
    int p = 0, m = 1, m2 = 2, m3 = 3, h = 6;
    bool have = TWO;
    for (int t = 0; t < L; ++t) {
      float2* const U = expm(
          sm + m * MAT, sm + m2 * MAT, sm + m3 * MAT, sm + 4 * MAT,
          sm + 5 * MAT, level, red, [&](float2* r, int e, float2 (&v)[2]) {
            v[0].x -= eye(e);
            v[1].x -= eye(e + 1);
            put2(r, e, v);
          });
      const float2* P = sm + p * MAT;
      float2* const Pn = sm + m2 * MAT;
      float2* const z = out + (size_t)(t + 1) * MAT;
      const bool fetch = t + 1 < L && !have;
      if (fetch) next(m3, h, t + 1, 0);
      float2 acc[EP];
      mm(U, P, acc);
      pairs([&](int e) {
        float2 v[2] = {acc[e], acc[e + 1]};
        if constexpr (!ABLATE) {
          float2 q[2];
          get2(P, e, q);
          v[0] = cadd(q[0], v[0]);
          v[1] = cadd(q[1], v[1]);
        }
        put2(Pn, e, v);
        out2(z, e, v);
      });
      if (fetch) next(m3, h, t + 1, 1);
      __syncthreads();
      const int p0 = p, m0 = m;
      p = m2;
      if (have) {
        m = h;
        h = m3;
      } else {
        m = m3;
      }
      m2 = p0;
      m3 = m0;
      have = TWO && !have;
    }
  }

  // out[i] = exp(a[i]) for i = blockIdx.x, + gridDim.x, ... < B (DP x DP
  // each), the last epilogue writing out. sm: five slots and red.
  static __device__ __forceinline__ void expm_batch(
      float2* sm, const float2* __restrict__ a, float2* __restrict__ out,
      int B, int level) {
    float* red = reinterpret_cast<float*>(sm + 5 * MAT);
    for (int i = blockIdx.x; i < B; i += gridDim.x) {
      stage(sm, a + (size_t)i * MAT);
      cp_async_wait<0>();
      __syncthreads();
      float2* const z = out + (size_t)i * MAT;
      expm(sm, sm + MAT, sm + 2 * MAT, sm + 3 * MAT, sm + 4 * MAT, level,
           red, [&](float2*, int e, float2 (&v)[2]) { out2(z, e, v); });
    }
  }
};

// The package's mode form (the fastest of profiling/resident_variants.py's
// at every forward entry's main-path inputs on an H100, PERF.md).
using FwdMode = FwdTC<7, 2, true, true>;

// ---------------------------------------------------------------------------
// Adjoint: dual-number exp and the adjoint step (K2, K5 adjoint; K4 at
// D = 64)
// ---------------------------------------------------------------------------

// The seed that adjoint step t of segment chain seg adds: seeds holds
// (S, L, n) per-step seeds (per_step), or (S, n) seeds of the last step,
// each seed n elements; nullptr where the step adds none.
__device__ __forceinline__ const float2* step_seed(const float2* seeds,
                                                   size_t seg, int t, int L,
                                                   bool per_step,
                                                   size_t n = MAT) {
  if (per_step) return seeds + (seg * L + t) * n;
  return t == L - 1 ? seeds + seg * n : nullptr;
}

// The adjoint's design, on NTH threads a block (the kernels run NTA; the
// others are variants that profiling/resident_variants.py times).
//
// Products. A dual product (X, dX)(Y, dY) = (X Y, dX Y + X dY) runs in two
// passes on one accumulator: the value X Y, its epilogue, then the tangent
// as one product of depth 2 DP, [dX X] [Y; dY], and its epilogue. So a
// thread holds one tile accumulator (8 elements at NTA), not two
// (BOTH_ACCUMULATORS, a variant: value and tangent accumulated together).
//
// Buffers. Seven DP x DP slots of shared memory, b[0..6]: b[0] the adjoint
// T; (M, dM) = (b[1], b[2]) at the start of the dual ladder; the rest
// scratch. Every epilogue writes only slots that no thread reads in the same
// phase, or the calling thread's own elements, so a product and its
// epilogue need no barrier between them; the ladder's elementwise passes
// are all fused into epilogues.
//
// Stash. Degrees 12 and 19 need the powers M, M2, M3 (and tangents) after
// M4 is formed, and there is no room for them. The epilogue of M3 = M2 M
// forms the Paterson-Stockmeyer chunks from the thread's own elements of M,
// M2 and the new M3 at once: the top chunk (with c12 M4 at degree 12) stays
// in registers until the powers are dead, the others (and their tangents)
// go to a per-block stash in device memory, written once and read once by
// the epilogue that adds them; each thread reads back only what it wrote,
// coalesced, so no barrier guards it (STASH_POWERS, a variant: stash M, M2,
// M3 and rebuild each chunk from them).
//
// Loops. The products take UNROLL k-pairs an iteration, K2's generator
// build BUILD_UNROLL basis terms (their loads in flight together). The
// kernels' shape, 512 threads, two passes, chunks, 4 k-pairs and 7 terms,
// was the fastest of profiling/resident_variants.py's at the headline and
// M4 inputs on an H100 (PERF.md).
//
// The bf16_3x mode (TC) runs mm_acc_3x (4 instructions a split, B's
// imaginary part negated in place, a tangent pass as one product of depth
// 2 DP), leaves U^H - I as
// the ladder's value (exit_v), so that the next step needs no pass to form
// it, and goes over its epilogues' elements two by two in 16-byte accesses
// (get2, put2). It runs 512 threads, 16 x 16 an mma tile a warp, on
// row-major slots: on 256 threads (MmaMap's swizzled 32 x 16 tiles) the
// products ran faster, but the elementwise passes, on half the warps,
// slower; and this form was 14-17% faster than the first one, whose
// product split every fragment by cvt.rna.tf32 where it read it, at every
// entry's main-path inputs (PERF.md). ABLATE (never set by the kernels, only by
// profiling/resident_variants.py) reduces every elementwise pass of the
// step to a store of the product's accumulator (the results are then
// garbage): what is left is the step's products, barriers, staging,
// transposes and generator build.
template <int NTH, bool BOTH_ACCUMULATORS = false, bool STASH_POWERS = false,
          int UNROLL = 4, int BUILD_UNROLL = 7, bool TC = false,
          bool ABLATE = false>
struct Adjoint {
  using Map = MapOf<NTH, TC>;
  static constexpr int THREADS = NTH;
  static constexpr int BUILD_KU = BUILD_UNROLL;  // K2's generator build
  static constexpr int EP = Map::EPT;

  static __device__ __forceinline__ int own(int e) { return Map::own(e); }

  // Index of element e in x: the tangent output tout (device memory,
  // row-major) or a shared-memory slot (Map's layout).
  static __device__ __forceinline__ int at(const float2* x,
                                           const float2* tout, int e) {
    return x == tout ? Map::gown(e) : own(e);
  }

  // Thread-private element e of stash slot ``slot``.
  static __device__ __forceinline__ float2& stash(float2* st, int slot,
                                                  int e) {
    return st[(size_t)slot * MAT + e * NTH + threadIdx.x];
  }

  // acc += X Y: the SIMT product (UNROLL k-pairs an iteration) or, TC,
  // mm_acc_3x.
  static __device__ __forceinline__ void prod(const float2* X,
                                              const float2* Y,
                                              float2 (&acc)[EP]) {
    if constexpr (TC) mm_acc_3x<Map>(X, Y, nullptr, nullptr, acc);
    else mm_acc<NTH, UNROLL>(X, Y, acc);
  }

  // acc += dX Y + X dY, a dual product's tangent pass.
  static __device__ __forceinline__ void tangent(const float2* dX,
                                                 const float2* Y,
                                                 const float2* X,
                                                 const float2* dY,
                                                 float2 (&acc)[EP]) {
    if constexpr (TC) {
      mm_acc_3x<Map>(dX, Y, X, dY, acc);
    } else {
      prod(dX, Y, acc);
      prod(X, dY, acc);
    }
  }

  // epi(acc), or with ABLATE a store of acc to the slot x.
  template <class E>
  static __device__ __forceinline__ void epilogue(E epi, float2 (&acc)[EP],
                                                  const float2* x) {
    if constexpr (ABLATE) put(const_cast<float2*>(x), acc);
    else epi(acc);
  }

  // The dual product (X, dX)(Y, dY): val(acc) receives X Y, then tan(acc)
  // dX Y + X dY (see the struct note).
  template <class V, class T>
  static __device__ __forceinline__ void dual(const float2* X,
                                              const float2* dX,
                                              const float2* Y,
                                              const float2* dY, V val,
                                              T tan) {
    float2 acc[EP];
    zero(acc);
    if constexpr (BOTH_ACCUMULATORS) {
      float2 dacc[EP];
      zero(dacc);
      prod(X, Y, acc);
      prod(dX, Y, dacc);
      prod(X, dY, dacc);
      val(acc);
      tan(dacc);
    } else {
      prod(X, Y, acc);
      epilogue(val, acc, X);
      zero(acc);
      tangent(dX, Y, X, dY, acc);
      epilogue(tan, acc, dX);
    }
  }

  // The ladder's first dual product, (M, dM)(M, dM) at (b[1], b[2]): its
  // value pass reads M alone, so it runs in the phase that writes dM (the
  // adjoint's gU), and the tangent pass after a barrier.
  template <class V, class T>
  static __device__ __forceinline__ void dual_first(const float2* M,
                                                    const float2* dM, V val,
                                                    T tan) {
    if constexpr (BOTH_ACCUMULATORS) {
      __syncthreads();
      dual(M, dM, M, dM, val, tan);
    } else {
      float2 acc[EP];
      zero(acc);
      prod(M, M, acc);
      epilogue(val, acc, M);
      __syncthreads();
      zero(acc);
      tangent(dM, M, M, dM, acc);
      epilogue(tan, acc, dM);
    }
  }

  // c_k I + c_{k+1} m + c_{k+2} m2 + c_{k+3} m3 on element e, and its
  // tangent c_{k+1} dm + c_{k+2} dm2 + c_{k+3} dm3.
  static __device__ __forceinline__ float2 chunk_v(int k, int e, float2 m,
                                                   float2 m2, float2 m3) {
    float2 v = caxpy(kC[k + 1], m, make_float2(kC[k] * Map::eye(e), 0.0f));
    v = caxpy(kC[k + 2], m2, v);
    return caxpy(kC[k + 3], m3, v);
  }
  static __device__ __forceinline__ float2 chunk_t(int k, float2 dm,
                                                   float2 dm2, float2 dm3) {
    float2 v = cscale(kC[k + 1], dm);
    v = caxpy(kC[k + 2], dm2, v);
    return caxpy(kC[k + 3], dm3, v);
  }

  // Stash the chunks k = 4 j, j < n (value in slot 2 j, tangent in 2 j + 1),
  // or with STASH_POWERS the powers (slots 0, 2, 4 and 1, 3, 5).
  static __device__ __forceinline__ void put_v(float2* st, int n, int e,
                                               float2 m, float2 m2,
                                               float2 m3) {
    if constexpr (STASH_POWERS) {
      stash(st, 0, e) = m;
      stash(st, 2, e) = m2;
      stash(st, 4, e) = m3;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) stash(st, 2 * j, e) = chunk_v(4 * j, e, m, m2, m3);
    }
  }
  static __device__ __forceinline__ void put_t(float2* st, int n, int e,
                                               float2 dm, float2 dm2,
                                               float2 dm3) {
    if constexpr (STASH_POWERS) {
      stash(st, 1, e) = dm;
      stash(st, 3, e) = dm2;
      stash(st, 5, e) = dm3;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) stash(st, 2 * j + 1, e) = chunk_t(4 * j, dm, dm2, dm3);
    }
  }
  // Chunk k = 4 j from the stash: value and tangent.
  static __device__ __forceinline__ float2 get_v(float2* st, int j, int e) {
    if constexpr (STASH_POWERS)
      return chunk_v(4 * j, e, stash(st, 0, e), stash(st, 2, e),
                     stash(st, 4, e));
    return stash(st, 2 * j, e);
  }
  static __device__ __forceinline__ float2 get_t(float2* st, int j, int e) {
    if constexpr (STASH_POWERS)
      return chunk_t(4 * j, stash(st, 1, e), stash(st, 3, e),
                     stash(st, 5, e));
    return stash(st, 2 * j + 1, e);
  }

  // lin'(j) of _D12A (without its constant a_j0 I), of values or of
  // tangents.
  static __device__ __forceinline__ float2 lin(int j, float2 m, float2 m2,
                                               float2 m3) {
    const float* a = kD12 + 4 * j;
    return caxpy(a[3], m3, caxpy(a[2], m2, cscale(a[1], m)));
  }

  // Element e of the value the dual ladder leaves in its slot: exp(M), or
  // with TC exp(M) - I, the operand of the next step's T update (T +
  // (U^H - I) T), rounded as that step would round it, so that the step
  // needs no pass and barrier of its own to form it.
  static __device__ __forceinline__ float2 exit_v(float2 v, int e) {
    if constexpr (TC) v.x -= Map::eye(e);
    return v;
  }

  // Elements e and e + 1 (e even) of slot x in the bf16_3x mode, columns
  // 2 t and 2 t + 1 of an mma fragment, adjacent and 16-byte aligned in
  // MmaMap's layout: one 16-byte access (half the instructions, and on the
  // adjoints' row-major slots half the bank conflicts of two 8-byte ones).
  static __device__ __forceinline__ void get2(const float2* x, int e,
                                              float2 (&v)[2]) {
    const float4 q = *reinterpret_cast<const float4*>(x + own(e));
    v[0] = make_float2(q.x, q.y);
    v[1] = make_float2(q.z, q.w);
  }
  static __device__ __forceinline__ void put2(float2* x, int e,
                                              const float2 (&v)[2]) {
    *reinterpret_cast<float4*>(x + own(e)) =
        make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  }
  // Z = v on the calling thread's elements (with TC put2 by pairs).
  static __device__ __forceinline__ void put(float2* Z,
                                             const float2 (&v)[EP]) {
    if constexpr (TC) {
#pragma unroll
      for (int e = 0; e < EP; e += 2) put2(Z, e, {v[e], v[e + 1]});
    } else {
      store_map<Map>(Z, v);
    }
  }

  // Dual degree 12 in 4 dual products (_D12A as kD12C says), the bf16_3x
  // mode's, in the slots of expm_dual. The epilogue of M3 = M2 M writes
  // lin(3) (and its tangent) to B5, B6 and stashes c0 I + lin'(0),
  // lin'(1), lin'(2) (slots 0, 2, 4; tangents 1, 3, 5); that of lin(3)^2
  // forms A6' (B1, B2) and Y' = lin'(1) + A6' (B3, B4); the last product's
  // value, c0 I + lin'(0) + Y' A6' + a20 Y' + y0 A6', waits in registers
  // until its tangent pass, which reads B1, is done. The epilogues go over
  // the thread's elements two by two (get2, put2).
  static __device__ float2* taylor12_4_dual(float2* B1, float2* B2,
                                            float2* B3, float2* B4,
                                            float2* B5, float2* B6,
                                            float2* st,
                                            float2* __restrict__ tout) {
    dual_first(B1, B2,  // M2
         [&](float2 (&a)[EP]) { put(B3, a); },
         [&](float2 (&a)[EP]) { put(B4, a); });
    __syncthreads();
    dual(B3, B4, B1, B2,  // M3 = M2 M
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; e += 2) {
             float2 m[2], m2[2], l3[2];
             get2(B1, e, m);
             get2(B3, e, m2);
#pragma unroll
             for (int u = 0; u < 2; ++u) {
               const float2 m3 = a[e + u];
               stash(st, 0, e + u) =
                   cadd(make_float2(kD12C[0] * Map::eye(e + u), 0.0f),
                        lin(0, m[u], m2[u], m3));
               stash(st, 2, e + u) = lin(1, m[u], m2[u], m3);
               stash(st, 4, e + u) = lin(2, m[u], m2[u], m3);
               l3[u] = lin(3, m[u], m2[u], m3);
             }
             put2(B5, e, l3);
           }
         },
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; e += 2) {
             float2 dm[2], dm2[2], l3[2];
             get2(B2, e, dm);
             get2(B4, e, dm2);
#pragma unroll
             for (int u = 0; u < 2; ++u) {
#pragma unroll
               for (int j = 0; j < 3; ++j)
                 stash(st, 2 * j + 1, e + u) = lin(j, dm[u], dm2[u], a[e + u]);
               l3[u] = lin(3, dm[u], dm2[u], a[e + u]);
             }
             put2(B6, e, l3);
           }
         });
    __syncthreads();
    dual(B5, B6, B5, B6,  // lin(3)^2
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; e += 2) {
             float2 a6[2], y[2];
#pragma unroll
             for (int u = 0; u < 2; ++u) {
               a6[u] = cadd(stash(st, 4, e + u), a[e + u]);
               y[u] = cadd(stash(st, 2, e + u), a6[u]);
             }
             put2(B1, e, a6);
             put2(B3, e, y);
           }
         },
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; e += 2) {
             float2 da6[2], dy[2];
#pragma unroll
             for (int u = 0; u < 2; ++u) {
               da6[u] = cadd(stash(st, 5, e + u), a[e + u]);
               dy[u] = cadd(stash(st, 3, e + u), da6[u]);
             }
             put2(B2, e, da6);
             put2(B4, e, dy);
           }
         });
    __syncthreads();
    float2 x[EP];
    dual(B3, B4, B1, B2,  // Y' A6'
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; e += 2) {
             float2 a6[2], y[2];
             get2(B1, e, a6);
             get2(B3, e, y);
#pragma unroll
             for (int u = 0; u < 2; ++u) {
               const float2 v = caxpy(kD12C[1], a6[u],
                                      caxpy(kD12[8], y[u],
                                            stash(st, 0, e + u)));
               x[e + u] = exit_v(cadd(v, a[e + u]), e + u);
             }
           }
         },
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; e += 2) {
             float2 da6[2], dy[2];
             get2(B2, e, da6);
             get2(B4, e, dy);
#pragma unroll
             for (int u = 0; u < 2; ++u) {
               const float2 v = caxpy(kD12C[1], da6[u],
                                      caxpy(kD12[8], dy[u],
                                            stash(st, 1, e + u)));
               tout[Map::gown(e + u)] = cadd(v, a[e + u]);
             }
           }
           __syncthreads();  // the tangent pass has read B1
           put(B1, x);
         });
    __syncthreads();
    return B1;
  }

  // Dual exp at (M, dM) = (b[1], b[2]): M written behind a barrier, dM
  // written by the calling thread's phase (dual_first); b[3..6] are
  // scratch, b[0] is left alone. Writes the tangent L(M, dM) to tout
  // (device memory) from the last product's epilogue and returns the slot
  // (b[1] or b[3]) that holds exp(M) (with TC exp(M) - I, exit_v).
  // Ends with a barrier.
  static __device__ float2* expm_dual(float2* const* b, int level,
                                      float2* st, float* red,
                                      float2* __restrict__ tout) {
    float2* const B1 = b[1];
    float2* const B2 = b[2];
    float2* const B3 = b[3];
    float2* const B4 = b[4];
    float2* const B5 = b[5];
    float2* const B6 = b[6];
    if (level == 0) {
      // Degree 4: M2 = M M, Y = c3 M + c4 M2 (the epilogue);
      // U = c0 I + c1 M + c2 M2 + M2 Y.
      dual_first(B1, B2,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               B3[i] = a[e];
               B5[i] = caxpy(kC[4], a[e], cscale(kC[3], B1[i]));
             }
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               B4[i] = a[e];
               B6[i] = caxpy(kC[4], a[e], cscale(kC[3], B2[i]));
             }
           });
      __syncthreads();
      dual(B3, B4, B5, B6,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               float2 v = caxpy(kC[1], B1[i],
                                make_float2(kC[0] * Map::eye(e), 0.0f));
               v = caxpy(kC[2], B3[i], v);
               B1[i] = exit_v(cadd(v, a[e]), e);
             }
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               const float2 dv = caxpy(kC[2], B4[i], cscale(kC[1], B2[i]));
               tout[Map::gown(e)] = cadd(dv, a[e]);
             }
           });
      __syncthreads();
      return B1;
    }
    if (level == 1) {
      // Degree 8 in 3 dual products (_D8X): A2 and Y = x1 M + x2 A2, then
      // A4 = A2 Y held in registers until A2 and Y are dead, then the
      // factors x3 A2 + A4, x4 I + x5 M + x6 A2 + x7 A4 and the sum
      // y0 I + y1 M + y2 A2, and their product.
      dual_first(B1, B2,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               B3[i] = a[e];
               B5[i] = caxpy(kD8[1], a[e], cscale(kD8[0], B1[i]));
             }
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               B4[i] = a[e];
               B6[i] = caxpy(kD8[1], a[e], cscale(kD8[0], B2[i]));
             }
           });
      __syncthreads();
      float2 a4[EP];
      dual(B3, B4, B5, B6,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) a4[e] = a[e];
           },
           [&](float2 (&da4)[EP]) {
             __syncthreads();
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               const float2 m = B1[i], dm = B2[i], m2 = B3[i], dm2 = B4[i];
               const float id = Map::eye(e);
               B3[i] = caxpy(kD8[2], m2, a4[e]);
               B4[i] = caxpy(kD8[2], dm2, da4[e]);
               float2 r = caxpy(kD8[4], m, make_float2(kD8[3] * id, 0.0f));
               r = caxpy(kD8[5], m2, r);
               B5[i] = caxpy(kD8[6], a4[e], r);
               float2 dr = cscale(kD8[4], dm);
               dr = caxpy(kD8[5], dm2, dr);
               B6[i] = caxpy(kD8[6], da4[e], dr);
               const float2 v =
                   caxpy(kD8[8], m, make_float2(kD8[7] * id, 0.0f));
               B1[i] = caxpy(kD8[9], m2, v);
               B2[i] = caxpy(kD8[9], dm2, cscale(kD8[8], dm));
             }
           });
      __syncthreads();
      dual(B3, B4, B5, B6,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               B1[i] = exit_v(cadd(B1[i], a[e]), e);
             }
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               tout[Map::gown(e)] = cadd(B2[i], a[e]);
             }
           });
      __syncthreads();
      return B1;
    }
    if constexpr (TC) {
      if (level == 2) return taylor12_4_dual(B1, B2, B3, B4, B5, B6, st, tout);
    }
    int s = 0;
    if (level == 4) {
      // Per-matrix scaling of the value's 1-norm to theta = 1 (the tangent
      // scales with it), then dual T19 and s dual squarings.
      s = scaling_count<Map>(B1, red);
      const float scale = exp2f(-(float)s);
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        const int i = own(e);
        B1[i] = cscale(scale, B1[i]);
        B2[i] = cscale(scale, B2[i]);
      }
      __syncthreads();
    }
    // Degree 12: x2 = chunk(8) + c12 M4, x1 = chunk(4) + M4 x2,
    // T12 = chunk(0) + M4 x1. Degree 19: p = chunk(16); p = p M4 + chunk(k)
    // for k = 12, 8, 4, 0.
    const bool d12 = level == 2;
    const int n = d12 ? 2 : 4;  // stashed chunks
    const int top = 4 * n;
    dual_first(B1, B2,  // M2
         [&](float2 (&a)[EP]) { put(B3, a); },
         [&](float2 (&a)[EP]) { put(B4, a); });
    __syncthreads();
    dual(B3, B4, B3, B4,  // M4
         [&](float2 (&a)[EP]) { put(B5, a); },
         [&](float2 (&a)[EP]) { put(B6, a); });
    float2 x[EP];
    dual(B3, B4, B1, B2,  // M3 = M2 M: the chunks
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; ++e) {
             const int i = own(e);
             const float2 m = B1[i], m2 = B3[i];
             put_v(st, n, e, m, m2, a[e]);
             x[e] = chunk_v(top, e, m, m2, a[e]);
             if (d12) x[e] = caxpy(kC[12], B5[i], x[e]);
           }
         },
         [&](float2 (&a)[EP]) {
#pragma unroll
           for (int e = 0; e < EP; ++e) {
             const int i = own(e);
             const float2 dm = B2[i], dm2 = B4[i];
             put_t(st, n, e, dm, dm2, a[e]);
             a[e] = chunk_t(top, dm, dm2, a[e]);
             if (d12) a[e] = caxpy(kC[12], B6[i], a[e]);
           }
           __syncthreads();  // M, dM, M2, dM2 are dead
           put(B1, x);
           put(B2, a);
         });
    __syncthreads();
    if (d12) {
      dual(B5, B6, B1, B2,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e)
               B3[own(e)] = cadd(get_v(st, 1, e), a[e]);
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e)
               B4[own(e)] = cadd(get_t(st, 1, e), a[e]);
           });
      __syncthreads();
      dual(B5, B6, B3, B4,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e)
               B1[own(e)] = cadd(get_v(st, 0, e), a[e]);
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e)
               tout[Map::gown(e)] = cadd(get_t(st, 0, e), a[e]);
           });
      __syncthreads();
      return B1;
    }
    float2 *p = B1, *dp = B2, *q = B3, *dq = B4;
    for (int j = 3; j >= 0; --j) {
      float2* const tq = j == 0 && s == 0 ? tout : dq;
      dual(p, dp, B5, B6,
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const float2 v = cadd(a[e], get_v(st, j, e));
               q[own(e)] = j == 0 && s == 0 ? exit_v(v, e) : v;
             }
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e)
               tq[at(tq, tout, e)] = cadd(a[e], get_t(st, j, e));
           });
      __syncthreads();
      float2* const t0 = p;
      float2* const t1 = dp;
      p = q;
      dp = dq;
      q = t0;
      dq = t1;
    }
    // The bf16_3x mode squares (D, dD) = (X - I, dX) as Fwd::expm does:
    // (I + 2 D + D D, 2 dD + dD D + D dD).
    if constexpr (TC) {
      if (s > 0) {
#pragma unroll
        for (int e = 0; e < EP; ++e) p[own(e)].x -= Map::eye(e);
        __syncthreads();
      }
    }
    for (int j = 0; j < s; ++j) {
      float2* const tq = j == s - 1 ? tout : dq;
      if constexpr (TC) {
        dual(p, dp, p, dp,
             [&](float2 (&a)[EP]) {
#pragma unroll
               for (int e = 0; e < EP; ++e) {
                 const int i = own(e);
                 q[i] = caxpy(2.0f, p[i], a[e]);
               }
             },
             [&](float2 (&a)[EP]) {
#pragma unroll
               for (int e = 0; e < EP; ++e)
                 tq[at(tq, tout, e)] = caxpy(2.0f, dp[own(e)], a[e]);
             });
      } else {
        dual(p, dp, p, dp,
             [&](float2 (&a)[EP]) { put(q, a); },
             [&](float2 (&a)[EP]) { put(tq, a); });
      }
      __syncthreads();
      float2* const t0 = p;
      float2* const t1 = dp;
      p = q;
      dp = dq;
      q = t0;
      dq = t1;
    }
    if constexpr (TC) {
      if (s > 0) {
#pragma unroll
        for (int e = 0; e < EP; ++e) {
          float2& v = p[own(e)];
          v.x += Map::eye(e);
          v = exit_v(v, e);
        }
        __syncthreads();
      }
    }
    return p;
  }

  // cp.async of a DP x DP matrix X (device memory, coalesced) into s,
  // row r's 16-byte chunk c at chunk c ^ (r & 7) of the row: the swizzle
  // that lets adjoint_of read s down its columns without bank conflicts.
  static __device__ __forceinline__ void stage_swizzled(
      float2* s, const float2* __restrict__ X) {
#pragma unroll
    for (int j = 0; j < MAT / 2 / NTH; ++j) {
      const int q = threadIdx.x + NTH * j;
      const int r = q >> 5, c = q & 31;
      cp_async16(s + r * DP + 2 * (c ^ (r & 7)), X + r * DP + 2 * c);
    }
  }

  // cp.async of X into s, in Map's layout.
  static __device__ __forceinline__ void stage(float2* s,
                                               const float2* __restrict__ X) {
#pragma unroll
    for (int j = 0; j < MAT / 2 / NTH; ++j) {
      const int q = 2 * (threadIdx.x + NTH * j);
      cp_async16(s + Map::phys(q), X + q);
    }
  }

  // h = X^H for X staged by stage_swizzled into s: each half-warp reads one
  // 16-byte chunk of 16 rows and writes two rows of h, 128 contiguous bytes
  // each, both without bank conflicts. Every thread writes outside its own
  // tile; the caller's barrier publishes h.
  static __device__ __forceinline__ void adjoint_of(float2* h,
                                                    const float2* s) {
#pragma unroll
    for (int j = 0; j < MAT / 2 / NTH; ++j) {
      const int q = threadIdx.x + NTH * j;
      const int r = (q & 15) + 16 * (q >> 9), c = (q >> 4) & 31;
      const float4 v =
          *reinterpret_cast<const float4*>(s + r * DP + 2 * (c ^ (r & 7)));
      h[Map::phys((2 * c) * DP + r)] = make_float2(v.x, -v.y);
      h[Map::phys((2 * c + 1) * DP + r)] = make_float2(v.z, -v.w);
    }
  }

  // Adjoint step t of a segment chain, in the slots of expm_dual (b[0] = T,
  // uh = U_{t+1}^H from the previous step, b[1] or b[3], nullptr at the
  // chain's last step):
  //   T_t  = seed (last step) or U_{t+1}^H T_{t+1} (+ seed, where given),
  //   gU_t = T_t P_{t-1}^H,
  //   (U_t^H, gA_t) = dual Taylor at (A_t^H, gU_t), gA_t into tout.
  // ``seed`` is the step's seed in device memory (every step's in the
  // per-step-seed mode, the last step's only, else nullptr), ``prev`` is
  // P_{t-1}. A_t^H comes from ``plane`` (A_t in device memory), or where
  // that is nullptr from build(M), which writes the calling thread's own
  // elements of M. The step's operands (P_{t-1}, the seed and the plane)
  // are staged by cp.async into free slots (b[5], b[4], b[2]) while the T
  // update runs, and build runs in the same phase, so one warp's L2
  // latency hides behind another's products. A_t^H goes to whichever of
  // b[1], b[3] is not uh, P_{t-1}^H to b[6], where the first product of the
  // ladder, which runs beside gU, does not write. Returns the slot holding
  // U_t^H; ends with a barrier.
  template <class Build>
  static __device__ __forceinline__ float2* step(
      float2* const* b, const float2* uh, const float2* __restrict__ seed,
      const float2* __restrict__ prev, const float2* __restrict__ plane,
      Build build, int level, float2* st, float* red,
      float2* __restrict__ tout) {
    float2* c[7] = {b[0], b[1], b[2], b[3], b[4], b[5], b[6]};
    if (uh == b[1]) {
      c[1] = b[3];
      c[3] = b[1];
    }
    stage_swizzled(b[5], prev);
    if (plane != nullptr) stage_swizzled(b[2], plane);
    if (seed != nullptr) stage(b[4], seed);
    cp_async_commit();
    if (plane == nullptr) build(c[1]);
    float2 acc[EP];
    if (uh != nullptr) {
      zero(acc);
      prod(uh, b[0], acc);
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (TC) {
      // T + (U^H - I) T (Fwd::advance): the ladder left U^H - I in uh
      // (exit_v).
#pragma unroll
      for (int e = 0; e < EP; e += 2) {
        float2 t[2], sd[2];
        if (ABLATE && uh != nullptr) {
          put2(b[0], e, {acc[e], acc[e + 1]});
          continue;
        }
        if (uh == nullptr) {
          get2(b[4], e, sd);
          put2(b[0], e, sd);
          continue;
        }
        get2(b[0], e, t);
        if (seed != nullptr) get2(b[4], e, sd);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          t[u] = cadd(t[u], acc[e + u]);
          if (seed != nullptr) t[u] = cadd(t[u], sd[u]);
        }
        put2(b[0], e, t);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EP; ++e) {
        const int i = own(e);
        if (ABLATE && uh != nullptr) {
          b[0][i] = acc[e];
          continue;
        }
        if (uh == nullptr) b[0][i] = b[4][i];
        else if (seed != nullptr) b[0][i] = cadd(acc[e], b[4][i]);
        else b[0][i] = acc[e];
      }
    }
    adjoint_of(b[6], b[5]);
    if (plane != nullptr) adjoint_of(c[1], b[2]);
    __syncthreads();
    zero(acc);
    prod(b[0], b[6], acc);
    put(b[2], acc);
    return expm_dual(c, level, st, red, tout);
  }
};

// The kernels' design, exact and in the bf16_3x mode.
using AdjointNTA = Adjoint<NTA>;
using AdjointTC = Adjoint<NTA, false, false, 4, 7, true>;

// launch(Form<A>{}) on the Adjoint A that a resident adjoint's entry runs:
// AdjointTC where tf32 != 0 (the bf16_3x mode), else AdjointNTA.
template <class A>
struct Form {
  using type = A;
};
template <class Launch>
int with_adjoint(int tf32, Launch launch) {
  if (tf32) return launch(Form<AdjointTC>{});
  return launch(Form<AdjointNTA>{});
}

// launch(Form<F>{}) on the forward form F that a resident forward's entry
// (K1, K5's forward, K3 at D = 64) runs: FwdMode where tf32 != 0 (the
// bf16_3x mode), else Fwd.
template <class Launch>
int with_forward(int tf32, Launch launch) {
  if (tf32) return launch(Form<FwdMode>{});
  return launch(Form<Fwd>{});
}

}  // namespace qoc
