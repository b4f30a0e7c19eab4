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
};

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

// acc = X Y
__device__ __forceinline__ void mm(const float2* X, const float2* Y,
                                   float2 (&acc)[EPT]) {
  zero(acc);
  mm_acc(X, Y, acc);
}

template <int NTH = NT>
__device__ __forceinline__ void store(float2* Z,
                                      const float2 (&v)[TileMap<NTH>::EPT]) {
#pragma unroll
  for (int e = 0; e < TileMap<NTH>::EPT; ++e) Z[TileMap<NTH>::own(e)] = v[e];
}

// M = sum_k w[k] G_k on the calling thread's tile; G is (n_b, DP, DP) in
// device memory (L2-resident across the steps of every block). KU terms a
// loop iteration (their loads in flight together), then the rest one by
// one.
template <int NTH = NT, int KU = 1>
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
  store<NTH>(M, v);
}

// M = X for a DP x DP matrix X in device memory, on the calling thread's
// tile (coalesced reads).
template <int NTH = NT>
__device__ __forceinline__ void load(float2* M,
                                     const float2* __restrict__ X) {
  using T = TileMap<NTH>;
#pragma unroll
  for (int e = 0; e < T::EPT; ++e) M[T::own(e)] = __ldg(X + T::own(e));
}

// Squaring count of M (shared memory) from its complex 1-norm:
// s = clip(ceil(log2(max(||M||_1 / 1.0, 1))), 0, 60), as _scaling_count.
// The first DP threads sum one column each; ends with a barrier; every
// thread gets the same s.
__device__ __forceinline__ int scaling_count(const float2* M, float* red) {
  if (threadIdx.x < DP) {
    float s = 0.0f;
    for (int i = 0; i < DP; ++i) {
      const float2 v = M[i * DP + threadIdx.x];
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
template <int NTH, bool BOTH_ACCUMULATORS = false, bool STASH_POWERS = false,
          int UNROLL = 4, int BUILD_UNROLL = 7>
struct Adjoint {
  using Map = TileMap<NTH>;
  static constexpr int THREADS = NTH;
  static constexpr int BUILD_KU = BUILD_UNROLL;  // K2's generator build
  static constexpr int EP = Map::EPT;

  static __device__ __forceinline__ int own(int e) { return Map::own(e); }

  // Thread-private element e of stash slot ``slot``.
  static __device__ __forceinline__ float2& stash(float2* st, int slot,
                                                  int e) {
    return st[(size_t)slot * MAT + e * NTH + threadIdx.x];
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
      mm_acc<NTH, UNROLL>(X, Y, acc);
      mm_acc<NTH, UNROLL>(dX, Y, dacc);
      mm_acc<NTH, UNROLL>(X, dY, dacc);
      val(acc);
      tan(dacc);
    } else {
      mm_acc<NTH, UNROLL>(X, Y, acc);
      val(acc);
      zero(acc);
      mm_acc<NTH, UNROLL>(dX, Y, acc);
      mm_acc<NTH, UNROLL>(X, dY, acc);
      tan(acc);
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
      mm_acc<NTH, UNROLL>(M, M, acc);
      val(acc);
      __syncthreads();
      zero(acc);
      mm_acc<NTH, UNROLL>(dM, M, acc);
      mm_acc<NTH, UNROLL>(M, dM, acc);
      tan(acc);
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

  // Dual exp at (M, dM) = (b[1], b[2]): M written behind a barrier, dM
  // written by the calling thread's phase (dual_first); b[3..6] are
  // scratch, b[0] is left alone. Writes the tangent L(M, dM) to tout
  // (device memory) from the last product's epilogue and returns the slot
  // (b[1] or b[3]) that holds exp(M). Ends with a barrier.
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
               B1[i] = cadd(v, a[e]);
             }
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               const float2 dv = caxpy(kC[2], B4[i], cscale(kC[1], B2[i]));
               tout[i] = cadd(dv, a[e]);
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
               B1[i] = cadd(B1[i], a[e]);
             }
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e) {
               const int i = own(e);
               tout[i] = cadd(B2[i], a[e]);
             }
           });
      __syncthreads();
      return B1;
    }
    int s = 0;
    if (level == 4) {
      // Per-matrix scaling of the value's 1-norm to theta = 1 (the tangent
      // scales with it), then dual T19 and s dual squarings.
      s = scaling_count(B1, red);
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
         [&](float2 (&a)[EP]) { store<NTH>(B3, a); },
         [&](float2 (&a)[EP]) { store<NTH>(B4, a); });
    __syncthreads();
    dual(B3, B4, B3, B4,  // M4
         [&](float2 (&a)[EP]) { store<NTH>(B5, a); },
         [&](float2 (&a)[EP]) { store<NTH>(B6, a); });
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
           store<NTH>(B1, x);
           store<NTH>(B2, a);
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
               tout[own(e)] = cadd(get_t(st, 0, e), a[e]);
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
             for (int e = 0; e < EP; ++e)
               q[own(e)] = cadd(a[e], get_v(st, j, e));
           },
           [&](float2 (&a)[EP]) {
#pragma unroll
             for (int e = 0; e < EP; ++e)
               tq[own(e)] = cadd(a[e], get_t(st, j, e));
           });
      __syncthreads();
      float2* const t0 = p;
      float2* const t1 = dp;
      p = q;
      dp = dq;
      q = t0;
      dq = t1;
    }
    for (int j = 0; j < s; ++j) {
      float2* const tq = j == s - 1 ? tout : dq;
      dual(p, dp, p, dp,
           [&](float2 (&a)[EP]) { store<NTH>(q, a); },
           [&](float2 (&a)[EP]) { store<NTH>(tq, a); });
      __syncthreads();
      float2* const t0 = p;
      float2* const t1 = dp;
      p = q;
      dp = dq;
      q = t0;
      dq = t1;
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

  // cp.async of X into s as it is.
  static __device__ __forceinline__ void stage(float2* s,
                                               const float2* __restrict__ X) {
#pragma unroll
    for (int j = 0; j < MAT / 2 / NTH; ++j) {
      const int q = 2 * (threadIdx.x + NTH * j);
      cp_async16(s + q, X + q);
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
      h[(2 * c) * DP + r] = make_float2(v.x, -v.y);
      h[(2 * c + 1) * DP + r] = make_float2(v.z, -v.w);
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
      mm_acc<NTH, UNROLL>(uh, b[0], acc);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      const int i = own(e);
      if (uh == nullptr) b[0][i] = b[4][i];
      else if (seed != nullptr) b[0][i] = cadd(acc[e], b[4][i]);
      else b[0][i] = acc[e];
    }
    adjoint_of(b[6], b[5]);
    if (plane != nullptr) adjoint_of(c[1], b[2]);
    __syncthreads();
    zero(acc);
    mm_acc<NTH, UNROLL>(b[0], b[6], acc);
    store<NTH>(b[2], acc);
    return expm_dual(c, level, st, red, tout);
  }
};

// The kernels' design.
using AdjointNTA = Adjoint<NTA>;

}  // namespace qoc
