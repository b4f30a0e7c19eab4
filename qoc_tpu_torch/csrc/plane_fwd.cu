// K5 forward: the expm-product chain over streamed generator planes,
// written by hand for Hopper (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_splane_fwd_kernel (the TPU kernel
// launched by _splane_fwd_pallas). K1 with the generator read, not built:
// for each of S independent segment chains it walks L time steps, loads
// the plane A_t (any Hamiltonian, any Magnus order: the caller builds the
// planes), computes U_t = exp(A_t) by the f32 Taylor ladder, sets
// P <- U_t P and writes every prefix P_t (the backward's residuals).
//
// What bounds it on the card: FP32 arithmetic, as K1. One step is 3-8
// complex 64 x 64 x 64 products (Taylor degree 4/8/12/19: 2/3/5/7, plus
// U P), 2.1 MFLOP each, against 32 KB of plane read and 32 KB of prefix
// written: about 100 FLOP a byte at degree 12, far above the card's
// 20 FLOP/byte FP32 balance point.
//
// What the design does about it: K1's, one block per segment chain with the
// chain's working set resident in shared memory; a step touches device
// memory for one coalesced plane read and one prefix write, where K1 reads
// its 21-term basis from L2. The bf16_3x mode (tf32 != 0) is K1's form,
// FwdTC, with each step's plane staged by cp.async while the chain step's
// product runs.
//
// Shared memory: P, M, M2, M3, M4, X (6 x DP^2 complex64) + RED_BYTES; the
// mode's form (FwdTC) reserves K1's seventh slot too, unused here.

#include "chain_common.cuh"

namespace qoc {
namespace {

template <class F>
__global__ void __launch_bounds__(F::THREADS, 1)
    plane_fwd_kernel(const float2* __restrict__ a,
                     const float* __restrict__ norm,
                     float2* __restrict__ prefpad, int L) {
  extern __shared__ float4 smem4[];
  const int level = ladder_level(__ldg(norm));
  F::chain(reinterpret_cast<float2*>(smem4),
           PlaneSource{a + (size_t)blockIdx.x * L * MAT}, L, level,
           prefpad + (size_t)blockIdx.x * (L + 1) * MAT);
}

template <class F>
int launch_plane_fwd(const void* a, const void* norm, void* prefpad, int S,
                     int L, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      plane_fwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F::SMEM);
  if (err != cudaSuccess) return (int)err;
  plane_fwd_kernel<F><<<S, F::THREADS, F::SMEM, (cudaStream_t)stream>>>(
      static_cast<const float2*>(a), static_cast<const float*>(norm),
      static_cast<float2*>(prefpad), L);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace qoc

#ifndef QOC_KERNELS_ONLY  // (profiling/resident_variants.cu)

// a (S, L, DP, DP) complex64 planes; norm -> 1 f32 (batch-max 1-norm of the
// planes); prefpad (S, L + 1, DP, DP) complex64, slot 0 written by the
// caller, slots 1..L by this kernel; tf32 != 0: the bf16_3x mode. Returns
// the CUDA error.
extern "C" int qoc_plane_fwd(const void* a, const void* norm, void* prefpad,
                             int S, int L, int tf32, void* stream) {
  return qoc::with_forward(tf32, [&](auto form) {
    return qoc::launch_plane_fwd<typename decltype(form)::type>(
        a, norm, prefpad, S, L, stream);
  });
}

#endif  // QOC_KERNELS_ONLY
