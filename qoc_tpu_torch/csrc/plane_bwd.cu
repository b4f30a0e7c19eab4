// K5 adjoint: exact gradient of the plane chain, written by hand for Hopper
// (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_splane_bwd_kernel (the TPU kernel
// launched by _splane_bwd_pallas), in both its seed modes. K2's
// recursion (chain_bwd.cu) with A_t^H read from the forward's planes in
// place of the basis build; for each segment chain, t = L-1 .. 0:
//
//   T_t      = seed_{L-1} (t = L-1), else U_{t+1}^H T_{t+1} [+ seed_t]
//   gU_t     = T_t P_{t-1}^H
//   (U_t^H, gA_t) = dual Taylor at (A_t^H, gU_t)
//
// gA_t is written out per step. With no basis to project on, it is the
// planes' gradient in PyTorch's convention (dL/dRe + i dL/dIm) as it stands.
// The bracketed seed is the per-step-seed mode's (per_step), as in K2.
//
// A_t^H: the kernel reads the forward's plane A_t coalesced and stores it
// conjugate-transposed into shared memory (as K2 stages P_{t-1}^H), so the
// caller keeps one copy of the planes and makes no transposed one.
//
// What bounds it on the card: FP32 arithmetic, as K2: 2 + 3 x (2/3/5/7)
// complex 64^3 products a step for degree 4/8/12/19.
//
// What the design does about it: K2's, one block per segment chain with 7
// resident matrices and the per-block stash for the dual powers (see
// chain_bwd.cu).
//
// Shared memory: 7 x DP^2 complex64 + RED_BYTES.

#include "chain_common.cuh"

namespace qoc {
namespace {

__global__ void __launch_bounds__(NT, 1)
    plane_bwd_kernel(const float2* __restrict__ a,
                     const float* __restrict__ norm,
                     const float2* __restrict__ prefpad,
                     const float2* __restrict__ seeds,
                     float2* __restrict__ gA, float2* __restrict__ stash,
                     int L, bool per_step) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  float2* b[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) b[j] = sm + j * MAT;
  float* red = reinterpret_cast<float*>(sm + 7 * MAT);

  const int level = ladder_level(__ldg(norm));
  const size_t seg = blockIdx.x;
  const float2* aseg = a + seg * L * MAT;
  const float2* pseg = prefpad + seg * (L + 1) * MAT;
  float2* gseg = gA + seg * L * MAT;
  float2* st = stash + seg * STASH_SLOTS * MAT;

  for (int t = L - 1; t >= 0; --t) {
    adjoint_gu(b, step_seed(seeds, seg, t, L, per_step),
               pseg + (size_t)t * MAT, t == L - 1);
    load_adjoint(b[1], aseg + (size_t)t * MAT);  // A_t^H
    __syncthreads();
    expm_dual(b, level, st, red);
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      gseg[(size_t)t * MAT + own(e)] = b[2][own(e)];
  }
}

}  // namespace
}  // namespace qoc

// a (S, L, DP, DP) complex64, the forward's planes; norm -> 1 f32 (batch-max
// inf-norm of the planes = 1-norm of A^H); prefpad (S, L + 1, DP, DP) from
// the forward; seeds (S, DP, DP), or (S, L, DP, DP) with per_step != 0; gA
// (S, L, DP, DP) out; stash (S, STASH_SLOTS, DP, DP) scratch. Returns the
// CUDA error.
extern "C" int qoc_plane_bwd(const void* a, const void* norm,
                             const void* prefpad, const void* seeds, void* gA,
                             void* stash, int S, int L, int per_step,
                             void* stream) {
  using namespace qoc;
  cudaError_t err = cudaFuncSetAttribute(
      plane_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  plane_bwd_kernel<<<S, NT, BWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float2*>(a), static_cast<const float*>(norm),
      static_cast<const float2*>(prefpad), static_cast<const float2*>(seeds),
      static_cast<float2*>(gA), static_cast<float2*>(stash), L,
      per_step != 0);
  return (int)cudaGetLastError();
}
