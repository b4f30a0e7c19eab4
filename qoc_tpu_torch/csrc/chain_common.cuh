// Shared device code of the fused expm-product chain kernels (K1 forward in
// chain_fwd.cu, K2 adjoint in chain_bwd.cu).
//
// Layout. One thread block advances one segment chain; 256 threads each own
// a fixed 16-element tile of every DP x DP complex matrix: rows
// warp + 8 r (r < 8), columns lane + 32 c (c < 2). Matrices are complex64
// (float2) in native complex arithmetic, row-major, 32 KB each at DP = 64.
// A product C = X Y reads X rows as float4 broadcasts (every lane of a warp
// reads the same address) and Y rows as consecutive float2 across lanes, so
// the shared-memory reads are conflict-free; each thread accumulates its own
// tile in registers (FP32 SIMT FMAs, no tensor cores, no TF32).
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

namespace qoc {

constexpr int DP = 64;          // padded matrix dimension
constexpr int NT = 256;         // threads per block
constexpr int MAT = DP * DP;    // elements per matrix
constexpr int RPT = DP / 8;     // tile rows per thread
constexpr int CPT = DP / 32;    // tile columns per thread
constexpr int EPT = RPT * CPT;  // tile elements per thread
constexpr int MAX_SQUARINGS = 60;
// Column-sum scratch for the per-matrix 1-norm: 8 x DP partial sums, DP
// column sums and one broadcast slot.
constexpr int RED_FLOATS = 9 * DP + 1;
constexpr size_t RED_BYTES = RED_FLOATS * sizeof(float);

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

// Ladder level from the batch-max norm: 0..3 = degree 4/8/12/19 without
// squaring, 4 = per-matrix scaling and squaring with T19.
__device__ __forceinline__ int ladder_level(float n) {
  if (n <= 0.05f) return 0;
  if (n <= 0.45f) return 1;
  if (n <= 1.2f) return 2;
  if (n <= 3.0f) return 3;
  return 4;
}

// Linear index of tile element e of the calling thread.
__device__ __forceinline__ int own(int e) {
  const int r = e / CPT, c = e % CPT;
  return ((threadIdx.x >> 5) + 8 * r) * DP + (threadIdx.x & 31) + 32 * c;
}

__device__ __forceinline__ float eye(int e) {
  const int i = own(e);
  return (i / DP == i % DP) ? 1.0f : 0.0f;
}

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

__device__ __forceinline__ void zero(float2 (&acc)[EPT]) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = make_float2(0.0f, 0.0f);
}

// acc += X Y for DP x DP complex X, Y in shared memory.
__device__ __forceinline__ void mm_acc(const float2* __restrict__ X,
                                       const float2* __restrict__ Y,
                                       float2 (&acc)[EPT]) {
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll 2
  for (int k = 0; k < DP; k += 2) {
    float4 a[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      a[r] = *reinterpret_cast<const float4*>(X + (ty + 8 * r) * DP + k);
    float2 b0[CPT], b1[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      b0[c] = Y[k * DP + tx + 32 * c];
      b1[c] = Y[(k + 1) * DP + tx + 32 * c];
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float2& o = acc[r * CPT + c];
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

// acc = X Y
__device__ __forceinline__ void mm(const float2* X, const float2* Y,
                                   float2 (&acc)[EPT]) {
  zero(acc);
  mm_acc(X, Y, acc);
}

// Dual-number product (X, dX)(Y, dY) = (X Y, dX Y + X dY).
__device__ __forceinline__ void mm_dual(const float2* X, const float2* dX,
                                        const float2* Y, const float2* dY,
                                        float2 (&acc)[EPT],
                                        float2 (&dacc)[EPT]) {
  zero(acc);
  zero(dacc);
  mm_acc(X, Y, acc);
  mm_acc(dX, Y, dacc);
  mm_acc(X, dY, dacc);
}

__device__ __forceinline__ void store(float2* Z, const float2 (&v)[EPT]) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) Z[own(e)] = v[e];
}

// M = sum_k w[k] G_k on the calling thread's tile; G is (n_b, DP, DP) in
// device memory (L2-resident across the steps of every block).
__device__ __forceinline__ void build_generator(float2* M,
                                                const float* __restrict__ w,
                                                const float2* __restrict__ G,
                                                int n_b) {
  float2 v[EPT];
  zero(v);
  for (int k = 0; k < n_b; ++k) {
    const float wk = __ldg(w + k);
    const float2* g = G + (size_t)k * MAT;
#pragma unroll
    for (int e = 0; e < EPT; ++e) v[e] = caxpy(wk, __ldg(g + own(e)), v[e]);
  }
  store(M, v);
}

// Squaring count of M (shared memory) from its complex 1-norm:
// s = clip(ceil(log2(max(||M||_1 / 1.0, 1))), 0, 60), as _scaling_count.
// Ends with a barrier; every thread gets the same s.
__device__ __forceinline__ int scaling_count(const float2* M, float* red) {
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    float p = 0.0f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float2 v = M[(ty + 8 * r) * DP + tx + 32 * c];
      p += sqrtf(v.x * v.x + v.y * v.y);
    }
    red[ty * DP + tx + 32 * c] = p;
  }
  __syncthreads();
  if (threadIdx.x < DP) {
    float s = 0.0f;
    for (int j = 0; j < 8; ++j) s += red[j * DP + threadIdx.x];
    red[8 * DP + threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float n1 = 0.0f;
    for (int j = 0; j < DP; ++j) n1 = fmaxf(n1, red[8 * DP + j]);
    float s = ceilf(log2f(fmaxf(n1 / 1.0f, 1.0f)));
    s = fminf(fmaxf(s, 0.0f), (float)MAX_SQUARINGS);
    red[9 * DP] = s;
  }
  __syncthreads();
  return (int)red[9 * DP];
}

}  // namespace qoc
