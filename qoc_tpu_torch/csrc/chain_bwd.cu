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

  const int level = ladder_level(__ldg(norm));
  const size_t seg = blockIdx.x;
  const float* wseg = w + seg * L * n_b;
  const float2* pseg = prefpad + seg * (L + 1) * MAT;
  float2* gseg = gA + seg * L * MAT;
  float2* st = stash + seg * STASH_SLOTS * MAT;

  for (int t = L - 1; t >= 0; --t) {
    adjoint_gu(b, seeds + seg * MAT, pseg + (size_t)t * MAT, t == L - 1);
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
