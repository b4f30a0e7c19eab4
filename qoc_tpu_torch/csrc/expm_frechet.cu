// K4: batched Fréchet derivative of the matrix exponential, L(B, G) =
// d/dt exp(B + t G) at t = 0, written by hand for Hopper (sm_90a).
//
// Replaces qoc_tpu/ops/expm_pallas.py:_fast_frechet_kernel and
// :_frechet_kernel, which expm_frechet_pallas picks between by the
// batch-max 1-norm of B. The same ladder as K3 (expm_common.cuh) evaluated
// on dual numbers (V, dV)(W, dW) = (V W, dV W + V dW), starting from
// (B, G), through the scaling (both scaled by 2^-s), the Taylor polynomial
// and the squarings: exact for any norm. The tangent is written out.
//
// ops/expm.py's expm calls it with B = A^H and G the gradient of exp(A) in
// PyTorch's convention (dL/dRe + i dL/dIm): L(A^H, G) is then the gradient
// of A. (qoc_tpu calls its kernel with B = A^T and JAX's cotangent, the
// conjugate of PyTorch's gradient; the two agree: conj L(A^T, conj G) =
// L(A^H, G).)
//
// What bounds it on the card: FP32 arithmetic, three complex D^3 products
// a dual product: 6/9/15/21 at degree 4/8/12/19, against two matrices read
// and one written.
//
// What the design does about it: K3's, with the tangents beside the values.
// At D = 64 the dual ladder is chain_common.cuh's Adjoint::expm_dual on 512
// threads, six resident matrices and the per-block stash of the
// Paterson-Stockmeyer chunks (K2's step without the recursion); above, twelve workspace matrices a block, each dual
// product run as one product for the value and one of twice the depth,
// [dX X] [Y; dY], for the tangent, through K3's ring, on 8 x 4 register
// tiles of 128 x 64 panels (8 x 2 tiles of 64 x 64 at D = 192, which 128
// does not divide): at the d = 2^7 planes on an H100 it beat K3's 8 x 2
// and a 4 x 4 tile (profiling/tiled_variants.py, numbers in PERF.md).
// The bf16_3x mode (tf32 != 0) runs each path's second instantiation (3 x
// TF32 tensor-core products, _D12A in dual form): AdjointTC at D = 64, the
// tiled ladder's TC form above (expm_common.cuh Product<2>, PR 11's
// mma.sync form on the same panels: the wgmma form measured slower at the
// d = 2^7 planes, PERF.md).

#include "expm_common.cuh"

namespace qoc {
namespace {

// D = 64: (value, tangent) and four scratch matrices of the dual ladder
// resident, + the 1-norm scratch.
constexpr size_t RESIDENT_SMEM = DUAL_SMEM;

template <class A>
__global__ void __launch_bounds__(A::THREADS, 1)
    frechet_resident_kernel(const float2* __restrict__ b,
                            const float2* __restrict__ g,
                            const float* __restrict__ norm,
                            float2* __restrict__ out, float2* stash, int B) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  // expm_dual's slots b1..b6 (b0, the adjoint's T, is not used here).
  float2* buf[7];
  buf[0] = nullptr;
#pragma unroll
  for (int j = 1; j < 7; ++j) buf[j] = sm + (j - 1) * MAT;
  float* red = reinterpret_cast<float*>(sm + 6 * MAT);
  float2* st = stash + (size_t)blockIdx.x * STASH_SLOTS * MAT;
  const int level = ladder_level(__ldg(norm));
  for (int m = blockIdx.x; m < B; m += gridDim.x) {
    load<A::THREADS, typename A::Map>(buf[1], b + (size_t)m * MAT);
    load<A::THREADS, typename A::Map>(buf[2], g + (size_t)m * MAT);
    __syncthreads();
    A::expm_dual(buf, level, st, red, out + (size_t)m * MAT);
  }
}

template <class A>
int resident(const void* b, const void* g, const void* norm, void* out,
             void* ws, int B, int grid, void* stream) {
  return ex::launch<A::THREADS>(frechet_resident_kernel<A>, RESIDENT_SMEM,
                                grid, stream, 1,
                                static_cast<const float2*>(b),
                                static_cast<const float2*>(g),
                                static_cast<const float*>(norm),
                                static_cast<float2*>(out),
                                static_cast<float2*>(ws), B);
}

template <int T, bool TC>
int tiled(const void* b, const void* g, const void* norm, void* out,
          void* ws, int B, int blocks, void* stream) {
  return ex::launch(ex::expm_tiled_kernel<ex::ExpmTiled<T, true, TC>>,
                    ex::expm_tiled_smem<T, true, TC>(), blocks, stream, 1,
                    static_cast<const float2*>(b),
                    static_cast<const float2*>(g),
                    static_cast<const float*>(norm),
                    static_cast<float2*>(out), static_cast<float2*>(ws), B);
}

template <int T>
int tiled(const void* b, const void* g, const void* norm, void* out,
          void* ws, int B, int blocks, int tf32, void* stream) {
  return tf32 ? tiled<T, true>(b, g, norm, out, ws, B, blocks, stream)
              : tiled<T, false>(b, g, norm, out, ws, B, blocks, stream);
}

template <int T>
int tiled_plan(int* blocks, int* smem) {
  *smem = (int)ex::expm_tiled_smem<T, true>();
  return ex::resident_blocks(
      ex::expm_tiled_kernel<ex::ExpmTiled<T, true>>, (size_t)*smem, blocks);
}

}  // namespace
}  // namespace qoc

#ifndef QOC_KERNELS_ONLY  // (profiling/resident_variants.cu)

// b, g (B, dp, dp) complex64, zero-padded; norm -> 1 f32, the batch-max
// 1-norm of b; out (B, dp, dp); ws (grid, slots, dp, dp) scratch from
// qoc_expm_frechet_plan (the Paterson-Stockmeyer chunks' stash at
// dp = 64). dp is 64, 128, 192 or 256; tf32 != 0 runs the bf16_3x mode's
// instantiation. Returns the CUDA error.
extern "C" int qoc_expm_frechet(const void* b, const void* g,
                                const void* norm, void* out, void* ws, int B,
                                int dp, int grid, int tf32, void* stream) {
  using namespace qoc;
  switch (dp) {
    case 64:
      return with_adjoint(tf32, [&](auto form) {
        return resident<typename decltype(form)::type>(b, g, norm, out, ws,
                                                       B, grid, stream);
      });
    case 128: return tiled<2>(b, g, norm, out, ws, B, grid, tf32, stream);
    case 192: return tiled<3>(b, g, norm, out, ws, B, grid, tf32, stream);
    case 256: return tiled<4>(b, g, norm, out, ws, B, grid, tf32, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As qoc_expm_fwd_plan, for K4. Returns the CUDA error.
extern "C" int qoc_expm_frechet_plan(int dp, int* blocks, int* slots,
                                     int* smem) {
  using namespace qoc;
  *slots = dp == 64 ? STASH_SLOTS : 2 * ex::NV;
  switch (dp) {
    case 64:
      *smem = (int)RESIDENT_SMEM;
      return ex::resident_blocks(frechet_resident_kernel<AdjointNTA>,
                                 RESIDENT_SMEM, blocks, NTA);
    case 128: return tiled_plan<2>(blocks, smem);
    case 192: return tiled_plan<3>(blocks, smem);
    case 256: return tiled_plan<4>(blocks, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // QOC_KERNELS_ONLY
