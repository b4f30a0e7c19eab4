// K1: forward of the fused expm-product chain, written by hand for Hopper
// (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_chain_fwd_kernel (the TPU kernel
// launched by _fwd_pallas). For each of S independent segment chains it
// walks L time steps: A_t = sum_k w[s, t, k] G_k from the generator basis,
// U_t = exp(A_t) by the f32 Taylor ladder, P <- U_t P, and writes every
// prefix P_t (the backward's residuals).
//
// What bounds it on the card: FP32 arithmetic. One step is 3-8 complex
// 64 x 64 x 64 products (Taylor degree 4/8/12/19: 2/3/5/7 products, plus
// U P), 1 MFMA each, against 32 KB of prefix written and 21 x 32 KB of basis
// read from L2. A step is a chain of dependent products, so a chain cannot
// be split across SMs.
//
// What the design does about it: one block per segment chain and many
// segments (the caller picks S near the SM count), so every SM runs its own
// chain; each chain keeps P, A, its powers and the Taylor temporaries
// resident in shared memory (6 x 32 KB), so a step touches device memory
// only for the basis (L2-resident) and one 32 KB prefix write. Products are
// native complex64 FP32 FMAs from conflict-free shared-memory reads; no
// tensor cores (TF32 would lose the f32 accuracy the ladder is tuned for).
//
// Shared memory: P, M, M2, M3, M4, X (6 x DP^2 complex64) + RED_BYTES.

#include "chain_common.cuh"

namespace qoc {
namespace {

constexpr size_t FWD_SMEM = 6 * MAT * sizeof(float2) + RED_BYTES;

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
__device__ float2* expm(float2* M, float2* M2, float2* M3, float2* M4,
                        float2* X, int level, float* red) {
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

__global__ void __launch_bounds__(NT, 1)
    chain_fwd_kernel(const float* __restrict__ w,
                     const float2* __restrict__ basis,
                     const float* __restrict__ norm,
                     float2* __restrict__ prefpad, int L, int n_b) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  float2* P = sm;
  float2* M = sm + MAT;
  float2* M2 = sm + 2 * MAT;
  float2* M3 = sm + 3 * MAT;
  float2* M4 = sm + 4 * MAT;
  float2* X = sm + 5 * MAT;
  float* red = reinterpret_cast<float*>(sm + 6 * MAT);

  const int level = ladder_level(__ldg(norm));
  const float* wseg = w + (size_t)blockIdx.x * L * n_b;
  float2* pseg = prefpad + (size_t)blockIdx.x * (L + 1) * MAT;

#pragma unroll
  for (int e = 0; e < EPT; ++e) P[own(e)] = make_float2(eye(e), 0.0f);
  for (int t = 0; t < L; ++t) {
    build_generator(M, wseg + (size_t)t * n_b, basis, n_b);
    __syncthreads();
    const float2* U = expm(M, M2, M3, M4, X, level, red);
    float2 acc[EPT];
    mm(U, P, acc);
    __syncthreads();
    store(P, acc);
    store(pseg + (size_t)(t + 1) * MAT, acc);
    __syncthreads();
  }
}

}  // namespace
}  // namespace qoc

// w (S, L, n_b) f32; basis (n_b, DP, DP) complex64; norm -> 1 f32 (batch-max
// 1-norm of the generators); prefpad (S, L + 1, DP, DP) complex64, slot 0
// written by the caller, slots 1..L by this kernel. Returns the CUDA error.
extern "C" int qoc_chain_fwd(const void* w, const void* basis,
                             const void* norm, void* prefpad, int S, int L,
                             int n_b, void* stream) {
  using namespace qoc;
  cudaError_t err = cudaFuncSetAttribute(
      chain_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_fwd_kernel<<<S, NT, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(w), static_cast<const float2*>(basis),
      static_cast<const float*>(norm), static_cast<float2*>(prefpad), L, n_b);
  return (int)cudaGetLastError();
}

extern "C" int qoc_chain_dp() { return qoc::DP; }
