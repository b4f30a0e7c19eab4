// K2: exact adjoint of the fused expm-product chain, written by hand for
// Hopper (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_chain_bwd_kernel (the TPU kernel
// launched by _bwd_pallas), in both its seed modes. With PyTorch's
// gradient convention (grad = dL/dRe + i dL/dIm) every quantity below is a
// plain gradient, and the recursion of the TPU kernel's conjugated adjoint
// is the natural one here. For each segment chain, walking t = L-1 .. 0:
//
//   T_t      = seed_{L-1}                      (t = L-1)
//            = U_{t+1}^H T_{t+1} [+ seed_t]    (otherwise)
//   gU_t     = T_t P_{t-1}^H          (P_{-1} = I: slot 0 of prefpad)
//   (U_t^H, gA_t) = dual Taylor at (A_t^H, gU_t)
//
// The last-step-seed mode (the gradient of the chain's total) has one seed
// a segment; the per-step-seed mode (per_step: the trajectory's prefixes
// carry gradients too) adds each step's own seed after the product, so
// with every seed but the last zero the two modes agree bitwise.
//
// The value half of the dual evaluation is exp(A_t^H) = U_t^H, carried to
// the next (earlier) step; the tangent half is the exact Frechet adjoint
// gA_t = L(A_t^H, gU_t), written out per step. A_t^H is built from the
// conjugate-transposed basis G_k^H. The caller projects gA onto the basis.
//
// What bounds it on the card: FP32 arithmetic, about 3x the forward's: a
// dual product is 3 complex 64^3 products, so a step costs 2 (T update and
// gU) + 3 x (2/3/5/7) products for degree 4/8/12/19 (8-23 products). The
// per-step mode adds a 32 KB seed read and an elementwise add a step.
//
// What the design does about it (chain_common.cuh Adjoint): one block of
// 512 threads (16 warps, a 4 x 2 register tile each) per segment chain,
// with T, U^H, the generator, its tangent and the ladder resident in seven
// 32 KB slots of shared memory (224 KB, the most a block may use). Each dual
// product runs in two passes on one accumulator (value, then the tangent as
// one product of twice the depth), so a thread needs at most 128 registers
// and nothing spills; the ladder's elementwise passes are fused into the
// products' epilogues. At degrees 12 and 19 the Paterson-Stockmeyer chunks
// are formed once, in the epilogue of M^3, and those below the top one go
// to a per-block device-memory stash, written and read once each. A step's
// operands, P_{t-1} and the seed, are staged by cp.async while the T update
// runs, and P_{t-1}^H is formed in shared memory without bank conflicts.
// A_t^H is built from the basis G_k^H, which stays L2-resident, 7 terms'
// loads in flight at once, in the same phase as the T update, so one warp's
// wait on L2 hides behind another's products; gU runs beside the value pass
// of the ladder's first product. The bf16_3x mode (tf32 != 0) is a second
// instantiation, AdjointTC: every product on the tensor cores as 3 x TF32
// (mma.sync m16n8k8 on the same 512 threads, each warp a 16 x 16 tile,
// operands split by 4 integer instructions, the tangent pass one product
// of depth 2 DP), at degree 12 _D12A's 4 dual products, the ladder leaving
// U^H - I for the next step's T update, epilogues in 16-byte accesses
// (chain_common.cuh).
//
// Shared memory: 7 x DP^2 complex64 + RED_BYTES.

#include "chain_common.cuh"

namespace qoc {
namespace {

template <class A>
__global__ void __launch_bounds__(A::THREADS, 1)
    chain_bwd_kernel(const float* __restrict__ w,
                     const float2* __restrict__ basis_h,
                     const float* __restrict__ norm,
                     const float2* __restrict__ prefpad,
                     const float2* __restrict__ seeds,
                     float2* __restrict__ gA, float2* __restrict__ stash,
                     int L, int n_b, bool per_step) {
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

  const float2* uh = nullptr;
  for (int t = L - 1; t >= 0; --t) {
    uh = A::step(b, uh, step_seed(seeds, seg, t, L, per_step),
                 pseg + (size_t)t * MAT, nullptr,
                 [&](float2* m) {  // A_t^H
                   build_generator<A::THREADS, A::BUILD_KU,
                                   typename A::Map>(
                       m, wseg + (size_t)t * n_b, basis_h, n_b);
                 },
                 level, st, red, gseg + (size_t)t * MAT);
  }
}

template <class A>
int launch_chain_bwd(const void* w, const void* basis_h, const void* norm,
                     const void* prefpad, const void* seeds, void* gA,
                     void* stash, int S, int L, int n_b, int per_step,
                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_bwd_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_bwd_kernel<A><<<S, A::THREADS, BWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(w), static_cast<const float2*>(basis_h),
      static_cast<const float*>(norm), static_cast<const float2*>(prefpad),
      static_cast<const float2*>(seeds), static_cast<float2*>(gA),
      static_cast<float2*>(stash), L, n_b, per_step != 0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace qoc

#ifndef QOC_KERNELS_ONLY  // (profiling/resident_variants.cu)

// w (S, L, n_b) f32; basis_h (n_b, DP, DP) complex64 holding G_k^H; norm -> 1
// f32 (batch-max inf-norm of the generators = 1-norm of A^H); prefpad
// (S, L + 1, DP, DP) from K1; seeds (S, DP, DP), or (S, L, DP, DP) with
// per_step != 0; gA (S, L, DP, DP) out; stash (S, STASH_SLOTS, DP, DP)
// scratch; tf32 != 0: the bf16_3x mode. Returns the CUDA error.
extern "C" int qoc_chain_bwd(const void* w, const void* basis_h,
                             const void* norm, const void* prefpad,
                             const void* seeds, void* gA, void* stash, int S,
                             int L, int n_b, int per_step, int tf32,
                             void* stream) {
  return qoc::with_adjoint(tf32, [&](auto form) {
    return qoc::launch_chain_bwd<typename decltype(form)::type>(
        w, basis_h, norm, prefpad, seeds, gA, stash, S, L, n_b, per_step,
        stream);
  });
}

extern "C" int qoc_chain_stash_slots() { return qoc::STASH_SLOTS; }

#endif  // QOC_KERNELS_ONLY
