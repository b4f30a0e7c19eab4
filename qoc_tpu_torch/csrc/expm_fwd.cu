// K3: batched matrix exponential exp(A), written by hand for Hopper
// (sm_90a).
//
// Replaces qoc_tpu/ops/expm_pallas.py:_fast_expm_kernel (the straight-line
// Taylor of one ladder degree) and :_expm_kernel (per-matrix scaling, Taylor
// and squarings), the two TPU kernels that expm_taylor_pallas picks between
// with a lax.switch on the batch-max 1-norm. Here one kernel reads the norm
// by pointer and branches on the ladder level inside (expm_common.cuh).
// It is the forward of ops/expm.py's expm on the blocked route of
// Schrödinger GRAPE: one exp per time step, B steps a call.
//
// What bounds it on the card: FP32 arithmetic. A matrix costs 2/3/5/7
// complex D^3 products at degree 4/8/12/19 (8 D^3 FLOP each) against one
// read of A and one write of exp(A): at D = 128 and degree 12, 84 MFLOP
// for 256 KB, about 320 FLOP a byte, far above the card's FP32 balance
// point of 20.
//
// What the design does about it. One block a matrix, persistent blocks
// walking the batch. At D = 64 the whole ladder stays in shared memory
// (chain_common.cuh's expm, K1's step). Above, the ladder's six matrices
// live in the block's device workspace, and every product streams 32-deep
// k-slices through a 4-stage cp.async ring in shared memory while the FMAs
// run on 8 x 2 register tiles (expm_common.cuh's Tiled); the ladder's
// elementwise passes are fused into the epilogues of the products before
// them, and the last product writes exp(A) out. Chosen by measuring at the
// d = 2^7 GRAPE's planes (2000 x 128^2, degree 19) on an H100 against
// clusters of 2 or 4 blocks a matrix (ladders that fit the L2) and 4 x 4
// and 8 x 4 register tiles: profiling/tiled_variants.py, numbers in
// PERF.md. The bf16_3x mode (tf32 != 0) runs each path's second
// instantiation, 3 x TF32 tensor-core products with _D12A at degree 12: at
// D = 64 the resident ladder's (chain_common.cuh FwdTC, mma.sync),
// above it the tiled ladder's (expm_common.cuh Tiled with TC = 2, PR 11's
// mma.sync form on the same panels: the wgmma form measured slower at the
// d = 2^7 planes, PERF.md; its slot holds exp(A) - I and the last epilogue
// writes exp(A) out).

#include "expm_common.cuh"

namespace qoc {
namespace {

// D = 64: M, M2, M3, M4, X resident + the 1-norm scratch.
constexpr size_t RESIDENT_SMEM = 5 * MAT * sizeof(float2) + RED_BYTES;

template <class F>
__global__ void __launch_bounds__(F::THREADS, 1)
    expm_resident_kernel(const float2* __restrict__ a,
                         const float* __restrict__ norm,
                         float2* __restrict__ out, int B) {
  extern __shared__ float4 smem4[];
  F::expm_batch(reinterpret_cast<float2*>(smem4), a, out, B,
                ladder_level(__ldg(norm)));
}

template <class F>
int resident(const void* a, const void* norm, void* out, int B, int grid,
             void* stream) {
  return ex::launch<F::THREADS>(expm_resident_kernel<F>, RESIDENT_SMEM, grid,
                                stream, 1, static_cast<const float2*>(a),
                                static_cast<const float*>(norm),
                                static_cast<float2*>(out), B);
}

template <int T, bool TC>
int tiled(const void* a, const void* norm, void* out, void* ws, int B,
          int blocks, void* stream) {
  return ex::launch(ex::expm_tiled_kernel<ex::ExpmTiled<T, false, TC>>,
                    ex::expm_tiled_smem<T, false, TC>(), blocks, stream, 1,
                    static_cast<const float2*>(a),
                    static_cast<const float2*>(nullptr),
                    static_cast<const float*>(norm),
                    static_cast<float2*>(out), static_cast<float2*>(ws), B);
}

template <int T>
int tiled(const void* a, const void* norm, void* out, void* ws, int B,
          int blocks, int tf32, void* stream) {
  return tf32 ? tiled<T, true>(a, norm, out, ws, B, blocks, stream)
              : tiled<T, false>(a, norm, out, ws, B, blocks, stream);
}

template <int T>
int tiled_plan(int* blocks, int* smem) {
  *smem = (int)ex::expm_tiled_smem<T, false>();
  return ex::resident_blocks(
      ex::expm_tiled_kernel<ex::ExpmTiled<T, false>>, (size_t)*smem, blocks);
}

}  // namespace
}  // namespace qoc

#ifndef QOC_KERNELS_ONLY  // (profiling/resident_variants.cu)

// a (B, dp, dp) complex64, zero-padded; norm -> 1 f32, the batch-max 1-norm
// of a; out (B, dp, dp); ws (grid, slots, dp, dp) scratch from
// qoc_expm_fwd_plan (none at dp = 64). dp is 64, 128, 192 or 256; tf32 != 0
// runs the bf16_3x mode's instantiation. Returns the CUDA error.
extern "C" int qoc_expm_fwd(const void* a, const void* norm, void* out,
                            void* ws, int B, int dp, int grid, int tf32,
                            void* stream) {
  using namespace qoc;
  switch (dp) {
    case 64:
      return with_forward(tf32, [&](auto form) {
        return resident<typename decltype(form)::type>(a, norm, out, B, grid,
                                                       stream);
      });
    case 128: return tiled<2>(a, norm, out, ws, B, grid, tf32, stream);
    case 192: return tiled<3>(a, norm, out, ws, B, grid, tf32, stream);
    case 256: return tiled<4>(a, norm, out, ws, B, grid, tf32, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The grid of qoc_expm_fwd at dp (resident blocks on the current device),
// the workspace matrices each block needs and the dynamic shared memory of
// a block. Returns the CUDA error.
extern "C" int qoc_expm_fwd_plan(int dp, int* blocks, int* slots,
                                 int* smem) {
  using namespace qoc;
  *slots = dp == 64 ? 0 : ex::NV;
  switch (dp) {
    case 64:
      *smem = (int)RESIDENT_SMEM;
      return ex::resident_blocks(expm_resident_kernel<Fwd>, RESIDENT_SMEM,
                                 blocks);
    case 128: return tiled_plan<2>(blocks, smem);
    case 192: return tiled_plan<3>(blocks, smem);
    case 256: return tiled_plan<4>(blocks, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The design of the tiled bf16_3x forms, for chip_smoke.py's design lines:
// kernel 3 (K3), 4 (K4) at dp 128-256, 6 (K6 forward) or 7 (K6 adjoint) at
// dp 320-512; out gets product_layout's six numbers (expm_common.cuh).
// Returns 0, or cudaErrorInvalidValue.
extern "C" int qoc_tiled_tc_layout(int kernel, int dp, int* out) {
  using namespace qoc::ex;
  switch (kernel * 1000 + dp) {
    case 3128: product_layout<ExpmTiled<2, false, true>>(out); return 0;
    case 3192: product_layout<ExpmTiled<3, false, true>>(out); return 0;
    case 3256: product_layout<ExpmTiled<4, false, true>>(out); return 0;
    case 4128: product_layout<ExpmTiled<2, true, true>>(out); return 0;
    case 4192: product_layout<ExpmTiled<3, true, true>>(out); return 0;
    case 4256: product_layout<ExpmTiled<4, true, true>>(out); return 0;
    case 6320: product_layout<StreamTiled<5, false, 1>>(out); return 0;
    case 6384: product_layout<StreamTiled<6, false, 1>>(out); return 0;
    case 6448: product_layout<StreamTiled<7, false, 1>>(out); return 0;
    case 6512: product_layout<StreamTiled<8, false, 1>>(out); return 0;
    case 7320: product_layout<StreamTiled<5, true, 1>>(out); return 0;
    case 7384: product_layout<StreamTiled<6, true, 1>>(out); return 0;
    case 7448: product_layout<StreamTiled<7, true, 1>>(out); return 0;
    case 7512: product_layout<StreamTiled<8, true, 1>>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // QOC_KERNELS_ONLY
