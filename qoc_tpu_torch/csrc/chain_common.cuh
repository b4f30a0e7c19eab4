// Shared device code of the expm-product chain kernels: K1 forward
// (chain_fwd.cu) and K2 adjoint (chain_bwd.cu) of the basis chain, K5
// forward (plane_fwd.cu) and adjoint (plane_bwd.cu) of the plane chain. The
// four differ only in where a step's generator comes from (a weighted sum
// of a resident basis, or a plane streamed from device memory); the tile
// map, the products, the Taylor ladder, its dual-number form and the chain
// and adjoint steps are here.
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
// Dynamic shared memory of the forward kernels (P, M, M2, M3, M4, X) and of
// the adjoint kernels (T, U^H / value, tangent and the dual powers).
constexpr size_t FWD_SMEM = 6 * MAT * sizeof(float2) + RED_BYTES;
constexpr size_t BWD_SMEM = 7 * MAT * sizeof(float2) + RED_BYTES;
// Per-block device-memory stash of the adjoint: M, dM, M2, dM2, M3, dM3.
constexpr int STASH_SLOTS = 6;

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

// M = X for a DP x DP matrix X in device memory, on the calling thread's
// tile (coalesced reads).
__device__ __forceinline__ void load(float2* M,
                                     const float2* __restrict__ X) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) M[own(e)] = __ldg(X + own(e));
}

// M = X^H: X is read coalesced and stored conjugate-transposed, so every
// thread writes outside its own tile; the caller's barrier publishes M.
__device__ __forceinline__ void load_adjoint(float2* M,
                                             const float2* __restrict__ X) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = own(e);
    const float2 x = __ldg(X + i);
    M[(i % DP) * DP + i / DP] = make_float2(x.x, -x.y);
  }
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


// ---------------------------------------------------------------------------
// Forward: exp(M) by the ladder (K1, K5 forward)
// ---------------------------------------------------------------------------

// chunk(k) = c_k I + c_{k+1} M + c_{k+2} M2 + c_{k+3} M3 on element e.
__device__ __forceinline__ float2 chunk(int k, int e, const float2* M,
                                        const float2* M2, const float2* M3) {
  const int i = own(e);
  float2 v = caxpy(kC[k + 1], M[i], make_float2(kC[k] * eye(e), 0.0f));
  v = caxpy(kC[k + 2], M2[i], v);
  return caxpy(kC[k + 3], M3[i], v);
}

// M2 = M M, M3 = M2 M, M4 = M2 M2. Expects M written; ends with a barrier.
__device__ __forceinline__ void powers(const float2* M, float2* M2,
                                       float2* M3, float2* M4) {
  float2 acc[EPT];
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
__device__ __forceinline__ void taylor19(const float2* M, const float2* M2,
                                         const float2* M3, const float2* M4,
                                         float2* X) {
  float2 acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) X[own(e)] = chunk(16, e, M, M2, M3);
  __syncthreads();
  for (int k = 12; k >= 0; k -= 4) {
    mm(X, M4, acc);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      X[own(e)] = cadd(acc[e], chunk(k, e, M, M2, M3));
    __syncthreads();
  }
}

// exp(M) for the generator M in shared memory (written, behind a barrier).
// Returns the buffer that holds the result; ends with a barrier.
static __device__ float2* expm(float2* M, float2* M2, float2* M3,
                               float2* M4, float2* X, int level, float* red) {
  float2 acc[EPT];
  if (level == 0) {
    // Degree 4: M2 = M M; U = c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2).
    mm(M, M, acc);
    store(M2, acc);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      M3[i] = caxpy(kC[4], M2[i], cscale(kC[3], M[i]));
    }
    __syncthreads();
    mm(M2, M3, acc);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
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
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      M3[i] = caxpy(kD8[1], M2[i], cscale(kD8[0], M[i]));
    }
    __syncthreads();
    mm(M2, M3, acc);  // A4
    store(M4, acc);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
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
    for (int e = 0; e < EPT; ++e) {
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
    for (int e = 0; e < EPT; ++e)
      X[own(e)] = caxpy(kC[12], M4[own(e)], chunk(8, e, M, M2, M3));
    __syncthreads();
    for (int k = 4; k >= 0; k -= 4) {
      mm(M4, X, acc);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        X[own(e)] = cadd(chunk(k, e, M, M2, M3), acc[e]);
      __syncthreads();
    }
    return X;
  }
  int s = 0;
  if (level == 4) {
    // Per-matrix scaling to theta = 1, then T19 and s squarings.
    s = scaling_count(M, red);
    const float scale = exp2f(-(float)s);
#pragma unroll
    for (int e = 0; e < EPT; ++e) M[own(e)] = cscale(scale, M[own(e)]);
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

// ---------------------------------------------------------------------------
// Adjoint: dual-number exp (K2, K5 backward)
// ---------------------------------------------------------------------------

// Thread-private slot of the per-block stash: element e of this thread.
__device__ __forceinline__ float2& stash_at(float2* st, int slot, int e) {
  return st[(size_t)slot * MAT + e * NT + threadIdx.x];
}

// Dual chunk(k) from the stash: value c_k I + c_{k+1} M + c_{k+2} M2 +
// c_{k+3} M3 and tangent c_{k+1} dM + c_{k+2} dM2 + c_{k+3} dM3.
__device__ __forceinline__ void chunk_dual(int k, int e, float2* st,
                                           float2& v, float2& dv) {
  v = caxpy(kC[k + 1], stash_at(st, 0, e), make_float2(kC[k] * eye(e), 0.0f));
  v = caxpy(kC[k + 2], stash_at(st, 2, e), v);
  v = caxpy(kC[k + 3], stash_at(st, 4, e), v);
  dv = cscale(kC[k + 1], stash_at(st, 1, e));
  dv = caxpy(kC[k + 2], stash_at(st, 3, e), dv);
  dv = caxpy(kC[k + 3], stash_at(st, 5, e), dv);
}

// Dual powers for the Paterson-Stockmeyer degrees: (M2, dM2) -> b3, b4,
// (M3, dM3) -> stash, (M4, dM4) -> b5, b6, then M, dM, M2, dM2 -> stash.
// Ends with a barrier; b1..b4 are free afterwards.
__device__ __forceinline__ void dual_powers(float2* const* b, float2* st) {
  float2 acc[EPT], dacc[EPT];
  mm_dual(b[1], b[2], b[1], b[2], acc, dacc);
  store(b[3], acc);
  store(b[4], dacc);
  __syncthreads();
  mm_dual(b[3], b[4], b[1], b[2], acc, dacc);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    stash_at(st, 4, e) = acc[e];
    stash_at(st, 5, e) = dacc[e];
  }
  mm_dual(b[3], b[4], b[3], b[4], acc, dacc);
  store(b[5], acc);
  store(b[6], dacc);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = own(e);
    stash_at(st, 0, e) = b[1][i];
    stash_at(st, 1, e) = b[2][i];
    stash_at(st, 2, e) = b[3][i];
    stash_at(st, 3, e) = b[4][i];
  }
  __syncthreads();
}

// Dual exp at (M, dM) = (b1, b2), both written behind a barrier. Leaves
// (exp(M), L(M, dM)) in (b1, b2); b3..b6 are scratch. Ends with a barrier.
static __device__ void expm_dual(float2* const* b, int level, float2* st,
                                 float* red) {
  float2 acc[EPT], dacc[EPT];
  if (level == 0) {
    // Degree 4.
    mm_dual(b[1], b[2], b[1], b[2], acc, dacc);
    store(b[3], acc);
    store(b[4], dacc);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      b[5][i] = caxpy(kC[4], b[3][i], cscale(kC[3], b[1][i]));
      b[6][i] = caxpy(kC[4], b[4][i], cscale(kC[3], b[2][i]));
    }
    __syncthreads();
    mm_dual(b[3], b[4], b[5], b[6], acc, dacc);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      float2 v = caxpy(kC[1], b[1][i], make_float2(kC[0] * eye(e), 0.0f));
      v = caxpy(kC[2], b[3][i], v);
      float2 dv = caxpy(kC[2], b[4][i], cscale(kC[1], b[2][i]));
      b[1][i] = cadd(v, acc[e]);
      b[2][i] = cadd(dv, dacc[e]);
    }
    __syncthreads();
    return;
  }
  if (level == 1) {
    // Degree 8 in 3 dual products (_D8X).
    mm_dual(b[1], b[2], b[1], b[2], acc, dacc);
    store(b[3], acc);
    store(b[4], dacc);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      b[5][i] = caxpy(kD8[1], b[3][i], cscale(kD8[0], b[1][i]));
      b[6][i] = caxpy(kD8[1], b[4][i], cscale(kD8[0], b[2][i]));
    }
    __syncthreads();
    mm_dual(b[3], b[4], b[5], b[6], acc, dacc);  // A4
    __syncthreads();
    store(b[5], acc);
    store(b[6], dacc);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      const float2 m = b[1][i], dm = b[2][i], m2 = b[3][i], dm2 = b[4][i];
      const float2 m4 = b[5][i], dm4 = b[6][i];
      const float id = eye(e);
      b[3][i] = caxpy(kD8[2], m2, m4);
      b[4][i] = caxpy(kD8[2], dm2, dm4);
      float2 r = caxpy(kD8[4], m, make_float2(kD8[3] * id, 0.0f));
      r = caxpy(kD8[5], m2, r);
      b[5][i] = caxpy(kD8[6], m4, r);
      float2 dr = cscale(kD8[4], dm);
      dr = caxpy(kD8[5], dm2, dr);
      b[6][i] = caxpy(kD8[6], dm4, dr);
      float2 v = caxpy(kD8[8], m, make_float2(kD8[7] * id, 0.0f));
      b[1][i] = caxpy(kD8[9], m2, v);
      b[2][i] = caxpy(kD8[9], dm2, cscale(kD8[8], dm));
    }
    __syncthreads();
    mm_dual(b[3], b[4], b[5], b[6], acc, dacc);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      b[1][i] = cadd(b[1][i], acc[e]);
      b[2][i] = cadd(b[2][i], dacc[e]);
    }
    __syncthreads();
    return;
  }
  if (level == 2) {
    // Degree 12, Paterson-Stockmeyer: x2 = chunk(8) + c12 M4,
    // x1 = chunk(4) + M4 x2, T12 = chunk(0) + M4 x1.
    dual_powers(b, st);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      float2 v, dv;
      chunk_dual(8, e, st, v, dv);
      b[1][i] = caxpy(kC[12], b[5][i], v);
      b[2][i] = caxpy(kC[12], b[6][i], dv);
    }
    __syncthreads();
    for (int k = 4; k >= 0; k -= 4) {
      mm_dual(b[5], b[6], b[1], b[2], acc, dacc);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int i = own(e);
        float2 v, dv;
        chunk_dual(k, e, st, v, dv);
        b[1][i] = cadd(v, acc[e]);
        b[2][i] = cadd(dv, dacc[e]);
      }
      __syncthreads();
    }
    return;
  }
  int s = 0;
  if (level == 4) {
    // Per-matrix scaling of the value's 1-norm to theta = 1 (the tangent
    // scales with it), then dual T19 and s dual squarings.
    s = scaling_count(b[1], red);
    const float scale = exp2f(-(float)s);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      b[1][i] = cscale(scale, b[1][i]);
      b[2][i] = cscale(scale, b[2][i]);
    }
    __syncthreads();
  }
  // Degree 19, Paterson-Stockmeyer: p = chunk(16); p = p M4 + chunk(k).
  dual_powers(b, st);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = own(e);
    float2 v, dv;
    chunk_dual(16, e, st, v, dv);
    b[1][i] = v;
    b[2][i] = dv;
  }
  __syncthreads();
  for (int k = 12; k >= 0; k -= 4) {
    mm_dual(b[1], b[2], b[5], b[6], acc, dacc);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      float2 v, dv;
      chunk_dual(k, e, st, v, dv);
      b[1][i] = cadd(acc[e], v);
      b[2][i] = cadd(dacc[e], dv);
    }
    __syncthreads();
  }
  for (int j = 0; j < s; ++j) {
    mm_dual(b[1], b[2], b[1], b[2], acc, dacc);
    __syncthreads();
    store(b[1], acc);
    store(b[2], dacc);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Chain and adjoint steps
// ---------------------------------------------------------------------------

// P <- U P, also written to the prefix slot ``out`` in device memory. U and
// P are in shared memory; ends with a barrier.
__device__ __forceinline__ void advance(float2* P, const float2* U,
                                        float2* __restrict__ out) {
  float2 acc[EPT];
  mm(U, P, acc);
  __syncthreads();
  store(P, acc);
  store(out, acc);
  __syncthreads();
}

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

// First half of adjoint step t of a segment chain, in the buffers of
// expm_dual (b0 = T, b1 = U_{t+1}^H from the previous step):
//   T_t  = seed (last step) or U_{t+1}^H T_{t+1} (+ seed, where given),
//   gU_t = T_t P_{t-1}^H into b2, with P_{t-1} = prev (device memory).
// ``seed`` is the step's seed in device memory: every step's in the
// per-step-seed mode, the last step's only (nullptr before it) in the
// last-step mode. b1 and b3..b6 are free afterwards: the caller writes A_t^H
// into b1 and sets a barrier before expm_dual.
__device__ __forceinline__ void adjoint_gu(float2* const* b,
                                           const float2* __restrict__ seed,
                                           const float2* __restrict__ prev,
                                           bool last) {
  float2 acc[EPT];
  if (last) {
    load(b[0], seed);
  } else {
    mm(b[1], b[0], acc);
    if (seed != nullptr) {
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        acc[e] = cadd(acc[e], __ldg(seed + own(e)));
    }
    __syncthreads();
    store(b[0], acc);
  }
  load_adjoint(b[3], prev);
  __syncthreads();
  mm(b[0], b[3], acc);
  store(b[2], acc);
}

}  // namespace qoc
