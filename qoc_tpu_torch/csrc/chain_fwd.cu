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
// The bf16_3x mode (tf32 != 0) runs the second form, FwdTC
// (chain_common.cuh): products on the tensor cores as 3 x TF32 with _D12A
// at degree 12 (1 + 4 products a step at degree 12, where the exact form
// takes 1 + 5), elementwise passes fused into the products' epilogues, the
// chain step and the next step's generator build in one phase, half the
// warps building before the step's product and half after it.
//
// Shared memory: P, M, M2, M3, M4, X (6 x DP^2 complex64; FwdTC a seventh
// slot, the generator built a step ahead) + RED_BYTES.

#include "chain_common.cuh"

namespace qoc {
namespace {

template <class F>
__global__ void __launch_bounds__(F::THREADS, 1)
    chain_fwd_kernel(const float* __restrict__ w,
                     const float2* __restrict__ basis,
                     const float* __restrict__ norm,
                     float2* __restrict__ prefpad, int L, int n_b) {
  extern __shared__ float4 smem4[];
  const int level = ladder_level(__ldg(norm));
  F::chain(reinterpret_cast<float2*>(smem4),
           BasisSource{w + (size_t)blockIdx.x * L * n_b, basis, n_b}, L,
           level, prefpad + (size_t)blockIdx.x * (L + 1) * MAT);
}

template <class F>
int launch_chain_fwd(const void* w, const void* basis, const void* norm,
                     void* prefpad, int S, int L, int n_b, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_fwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F::SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_fwd_kernel<F><<<S, F::THREADS, F::SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(w), static_cast<const float2*>(basis),
      static_cast<const float*>(norm), static_cast<float2*>(prefpad), L, n_b);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace qoc

#ifndef QOC_KERNELS_ONLY  // (profiling/resident_variants.cu)

// w (S, L, n_b) f32; basis (n_b, DP, DP) complex64; norm -> 1 f32 (batch-max
// 1-norm of the generators); prefpad (S, L + 1, DP, DP) complex64, slot 0
// written by the caller, slots 1..L by this kernel; tf32 != 0: the bf16_3x
// mode. Returns the CUDA error.
extern "C" int qoc_chain_fwd(const void* w, const void* basis,
                             const void* norm, void* prefpad, int S, int L,
                             int n_b, int tf32, void* stream) {
  return qoc::with_forward(tf32, [&](auto form) {
    return qoc::launch_chain_fwd<typename decltype(form)::type>(
        w, basis, norm, prefpad, S, L, n_b, stream);
  });
}

extern "C" int qoc_chain_dp() { return qoc::DP; }

// The mode's forward form (chain_common.cuh FwdMode), for chip_smoke.py's
// design lines: out gets the basis terms in flight and passes of its
// generator build, whether half the warps build before the step's product
// (0/1) and whether a build makes two steps' generators (0/1). Returns 0.
extern "C" int qoc_forward_form(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = qoc::FwdMode::SHAPE[i];
  return 0;
}

// Threads and dynamic shared memory of a block of a resident kernel:
// kernel 1 the forwards (K1, K5's; K3 at D = 64 takes the threads, its
// shared memory is expm_fwd.cu's RESIDENT_SMEM), 2 K2, 5 K5's adjoint, 4 K4
// at D = 64; tf32 as the kernels take it (!= 0: the bf16_3x mode). Returns
// the CUDA error.
extern "C" int qoc_chain_block(int kernel, int tf32, int* threads,
                               int* smem) {
  using namespace qoc;
  auto shape = [&](auto f) {
    *threads = decltype(f)::type::THREADS;
    return 0;
  };
  switch (kernel) {
    case 1:
      return with_forward(tf32, [&](auto f) {
        *smem = (int)decltype(f)::type::SMEM;
        return shape(f);
      });
    case 2: *smem = (int)BWD_SMEM; return with_adjoint(tf32, shape);
    case 5: *smem = (int)BWD_SMEM; return with_adjoint(tf32, shape);
    case 4: *smem = (int)DUAL_SMEM; return with_adjoint(tf32, shape);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // QOC_KERNELS_ONLY
