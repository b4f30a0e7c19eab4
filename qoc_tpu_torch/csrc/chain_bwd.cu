// K2: exact adjoint of the fused expm-product chain, written by hand for
// Hopper (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_chain_bwd_kernel (the TPU kernel
// launched by _bwd_pallas), in its last-step-seed mode. With PyTorch's
// gradient convention (grad = dL/dRe + i dL/dIm) every quantity below is a
// plain gradient, and the recursion of the TPU kernel's conjugated adjoint
// is the natural one here. For each segment chain, walking t = L-1 .. 0:
//
//   T_t      = seed                   (t = L-1)
//            = U_{t+1}^H T_{t+1}      (otherwise)
//   gU_t     = T_t P_{t-1}^H          (P_{-1} = I: slot 0 of prefpad)
//   (U_t^H, gA_t) = dual Taylor at (A_t^H, gU_t)
//
// The value half of the dual evaluation is exp(A_t^H) = U_t^H, carried to
// the next (earlier) step; the tangent half is the exact Frechet adjoint
// gA_t = L(A_t^H, gU_t), written out per step. A_t^H is built from the
// conjugate-transposed basis G_k^H. The caller projects gA onto the basis.
//
// What bounds it on the card: FP32 arithmetic, about 3x the forward's: a
// dual product is 3 complex 64^3 products, so a step costs 2 (T update and
// gU) + 3 x (2/3/5/7) products for degree 4/8/12/19 (8-23 products).
//
// What the design does about it: as K1, one block per segment chain with
// its working set in shared memory: T, U^H / value, tangent and the dual
// powers (7 x 32 KB = 224 KB, the most a block may use). Degrees 12 and 19
// need more live matrices than fit, so once M^4 is formed the powers M, M^2,
// M^3 and their tangents, which are only read elementwise from then on, go
// to a per-block stash in device memory: each thread reads back only what
// it wrote, with coalesced accesses, so no barrier guards it.
//
// Shared memory: 7 x DP^2 complex64 + RED_BYTES.

#include "chain_common.cuh"

namespace qoc {
namespace {

constexpr size_t BWD_SMEM = 7 * MAT * sizeof(float2) + RED_BYTES;
constexpr int STASH_SLOTS = 6;  // M, dM, M2, dM2, M3, dM3

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
__device__ void expm_dual(float2* const* b, int level, float2* st,
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

__global__ void __launch_bounds__(NT, 1)
    chain_bwd_kernel(const float* __restrict__ w,
                     const float2* __restrict__ basis_h,
                     const float* __restrict__ norm,
                     const float2* __restrict__ prefpad,
                     const float2* __restrict__ seeds,
                     float2* __restrict__ gA, float2* __restrict__ stash,
                     int L, int n_b) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  float2* b[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) b[j] = sm + j * MAT;
  float* red = reinterpret_cast<float*>(sm + 7 * MAT);
  float2* T = b[0];

  const int level = ladder_level(__ldg(norm));
  const size_t seg = blockIdx.x;
  const float* wseg = w + seg * L * n_b;
  const float2* pseg = prefpad + seg * (L + 1) * MAT;
  float2* gseg = gA + seg * L * MAT;
  float2* st = stash + seg * STASH_SLOTS * MAT;

  float2 acc[EPT];
  for (int t = L - 1; t >= 0; --t) {
    if (t == L - 1) {
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        T[own(e)] = __ldg(seeds + seg * MAT + own(e));
    } else {
      mm(b[1], T, acc);  // U_{t+1}^H T_{t+1}
      __syncthreads();
      store(T, acc);
    }
    // P_{t-1}^H into b3: read the prefix coalesced, store transposed.
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = own(e);
      const float2 p = __ldg(pseg + (size_t)t * MAT + i);
      b[3][(i % DP) * DP + i / DP] = make_float2(p.x, -p.y);
    }
    __syncthreads();
    mm(T, b[3], acc);  // gU_t
    store(b[2], acc);
    build_generator(b[1], wseg + (size_t)t * n_b, basis_h, n_b);  // A_t^H
    __syncthreads();
    expm_dual(b, level, st, red);
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      gseg[(size_t)t * MAT + own(e)] = b[2][own(e)];
  }
}

}  // namespace
}  // namespace qoc

// w (S, L, n_b) f32; basis_h (n_b, DP, DP) complex64 holding G_k^H; norm -> 1
// f32 (batch-max inf-norm of the generators = 1-norm of A^H); prefpad
// (S, L + 1, DP, DP) from K1; seeds (S, DP, DP); gA (S, L, DP, DP) out;
// stash (S, 6, DP, DP) scratch. Returns the CUDA error.
extern "C" int qoc_chain_bwd(const void* w, const void* basis_h,
                             const void* norm, const void* prefpad,
                             const void* seeds, void* gA, void* stash, int S,
                             int L, int n_b, void* stream) {
  using namespace qoc;
  cudaError_t err = cudaFuncSetAttribute(
      chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_bwd_kernel<<<S, NT, BWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(w), static_cast<const float2*>(basis_h),
      static_cast<const float*>(norm), static_cast<const float2*>(prefpad),
      static_cast<const float2*>(seeds), static_cast<float2*>(gA),
      static_cast<float2*>(stash), L, n_b);
  return (int)cudaGetLastError();
}

extern "C" int qoc_chain_stash_slots() { return qoc::STASH_SLOTS; }
