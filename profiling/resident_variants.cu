// Variants of the resident kernels for profiling/resident_variants.py.
//
// The adjoint (K2, K5's adjoint and K4 at D = 64: qoc_tpu_torch/csrc/
// chain_common.cuh Adjoint): the package's kernels, chain_bwd_kernel,
// plane_bwd_kernel and frechet_resident_kernel, on other Adjoint shapes
// (threads a block, dual products accumulated in one pass or two, chunks or
// powers stashed, k-pairs a loop iteration of the exact product, basis terms
// a loop iteration of K2's generator build, the bf16_3x mode, and the
// ablation of the step's elementwise passes), each behind C entries with
// the package's arguments (qoc_chain_bwd, qoc_plane_bwd, and
// qoc_expm_frechet's at dp = 64).
//
// With QOC_FORWARD_VARIANTS, the bf16_3x forward (K1, K5's forward and K3
// at D = 64: chain_common.cuh FwdTC): the package's chain_fwd_kernel,
// plane_fwd_kernel and expm_resident_kernel on other FwdTC shapes (basis
// terms in flight and passes of the generator build, half the warps
// building before the step's product, one or two steps' generators a
// build, the ablation of the elementwise passes), behind C entries with
// the
// package's arguments (qoc_chain_fwd, qoc_plane_fwd, qoc_expm_fwd's at
// dp = 64, without tf32).
//
// With QOC_BASELINE_FWD (the path of another checkout's chain_fwd.cu whose
// mode form is Fwd<true>, the form before FwdTC), that form's step at
// degree 12 with every elementwise pass reduced to a store: its generator
// build, its five products, its barriers and its prefix write
// (baseline_products_chain_fwd).
//
// The script builds one variant a translation unit (QOC_ONE_VARIANT and
// that variant's line), all at once; built as it stands, the file holds
// every adjoint variant, with QOC_FORWARD_VARIANTS every forward one.

#if defined(QOC_BASELINE_FWD)

#include QOC_BASELINE_FWD

namespace {

__global__ void __launch_bounds__(qoc::NT, 1)
    baseline_products_kernel(const float* __restrict__ w,
                             const float2* __restrict__ basis,
                             float2* __restrict__ prefpad, int L, int n_b) {
  using namespace qoc;
  using F = Fwd<true>;
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  float2* P = sm;
  float2* M = sm + MAT;
  float2* M2 = sm + 2 * MAT;
  float2* M3 = sm + 3 * MAT;
  float2* M4 = sm + 4 * MAT;
  float2* X = sm + 5 * MAT;
  const float* wseg = w + (size_t)blockIdx.x * L * n_b;
  float2* pseg = prefpad + (size_t)blockIdx.x * (L + 1) * MAT;
  float2 acc[F::EP];
#pragma unroll
  for (int e = 0; e < F::EP; ++e) P[F::own(e)] = make_float2(F::eye(e), 0.0f);
  for (int t = 0; t < L; ++t) {
    build_generator<NT, 1, F::Map>(M, wseg + (size_t)t * n_b, basis, n_b);
    __syncthreads();
    // taylor12_4's products, each epilogue one store.
    F::mm(M, M, acc);
    F::store(M2, acc);
    __syncthreads();
    F::mm(M2, M, acc);
    F::store(M3, acc);
    __syncthreads();
    F::mm(X, X, acc);
    F::store(M4, acc);
    __syncthreads();
    F::mm(M2, M4, acc);
    F::store(X, acc);
    __syncthreads();
    // advance: the U - I pass's barrier, the product, the stores.
    __syncthreads();
    F::mm(X, P, acc);
    __syncthreads();
    F::store(P, acc);
#pragma unroll
    for (int e = 0; e < F::EP; ++e)
      pseg[(size_t)(t + 1) * MAT + F::Map::gown(e)] = acc[e];
    __syncthreads();
  }
}

}  // namespace

extern "C" int baseline_products_chain_fwd(const void* w, const void* basis,
                                           const void* norm, void* prefpad,
                                           int S, int L, int n_b,
                                           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      baseline_products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)qoc::FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  baseline_products_kernel<<<S, qoc::NT, qoc::FWD_SMEM,
                             (cudaStream_t)stream>>>(
      static_cast<const float*>(w), static_cast<const float2*>(basis),
      static_cast<float2*>(prefpad), L, n_b);
  return (int)cudaGetLastError();
}

#elif defined(QOC_FORWARD_VARIANTS)

#define QOC_KERNELS_ONLY
#include "../qoc_tpu_torch/csrc/chain_fwd.cu"
#include "../qoc_tpu_torch/csrc/expm_fwd.cu"
#include "../qoc_tpu_torch/csrc/plane_fwd.cu"

// NAME: FwdTC<KU, PASSES, EARLY, PAIR, ABLATE>.
#define FWD_VARIANT(NAME, KU, PASSES, EARLY, PAIR, ABLATE)                  \
  using NAME##_form = qoc::FwdTC<KU, PASSES, EARLY, PAIR, ABLATE>;           \
  extern "C" int NAME##_chain_fwd(const void* w, const void* basis,          \
                                  const void* norm, void* prefpad, int S,    \
                                  int L, int n_b, void* stream) {            \
    return qoc::launch_chain_fwd<NAME##_form>(w, basis, norm, prefpad, S,   \
                                              L, n_b, stream);              \
  }                                                                          \
  extern "C" int NAME##_plane_fwd(const void* a, const void* norm,           \
                                  void* prefpad, int S, int L,               \
                                  void* stream) {                            \
    return qoc::launch_plane_fwd<NAME##_form>(a, norm, prefpad, S, L,       \
                                              stream);                       \
  }                                                                          \
  extern "C" int NAME##_expm_fwd(const void* a, const void* norm, void* out, \
                                 int B, int grid, void* stream) {            \
    return qoc::resident<NAME##_form>(a, norm, out, B, grid, stream);       \
  }

#ifndef QOC_ONE_VARIANT

// The package's FwdMode first (7 basis terms in flight in two passes, half
// the warps building before the step's product, two steps' generators a
// build), then one change each: 4 terms in flight, every warp building
// after the product, one generator a build (with 7 terms in two passes or
// 4 in one), and the elementwise passes reduced to stores (ABLATE true).
FWD_VARIANT(fwd_k7x2_early_pair, 7, 2, true, true, false)
FWD_VARIANT(fwd_k4x2_early_pair, 4, 2, true, true, false)
FWD_VARIANT(fwd_k7x2_pair, 7, 2, false, true, false)
FWD_VARIANT(fwd_k7x2_early, 7, 2, true, false, false)
FWD_VARIANT(fwd_k4x1_early, 4, 1, true, false, false)
FWD_VARIANT(fwd_k7x2_early_pair_products, 7, 2, true, true, true)

#endif  // QOC_ONE_VARIANT

#else

#define QOC_KERNELS_ONLY
#include "../qoc_tpu_torch/csrc/chain_bwd.cu"
#include "../qoc_tpu_torch/csrc/expm_frechet.cu"
#include "../qoc_tpu_torch/csrc/plane_bwd.cu"

// NAME: Adjoint<NTH, BOTH_ACCUMULATORS, STASH_POWERS, UNROLL, KU, TC,
// ABLATE>.
#define VARIANT(NAME, NTH, BOTH_ACCUMULATORS, STASH_POWERS, UNROLL, KU, TC,  \
                ABLATE)                                                      \
  using NAME##_adjoint = qoc::Adjoint<NTH, BOTH_ACCUMULATORS, STASH_POWERS,  \
                                      UNROLL, KU, TC, ABLATE>;               \
  extern "C" int NAME##_chain(const void* w, const void* basis_h,            \
                              const void* norm, const void* prefpad,         \
                              const void* seeds, void* gA, void* stash,      \
                              int S, int L, int n_b, int per_step,           \
                              void* stream) {                                \
    return qoc::launch_chain_bwd<NAME##_adjoint>(                            \
        w, basis_h, norm, prefpad, seeds, gA, stash, S, L, n_b, per_step,    \
        stream);                                                             \
  }                                                                          \
  extern "C" int NAME##_plane(const void* a, const void* norm,               \
                              const void* prefpad, const void* seeds,        \
                              void* gA, void* stash, int S, int L,           \
                              int per_step, void* stream) {                  \
    return qoc::launch_plane_bwd<NAME##_adjoint>(                            \
        a, norm, prefpad, seeds, gA, stash, S, L, per_step, stream);         \
  }                                                                          \
  extern "C" int NAME##_frechet(const void* b, const void* g,                \
                                const void* norm, void* out, void* ws,       \
                                int B, int grid, void* stream) {             \
    return qoc::resident<NAME##_adjoint>(b, g, norm, out, ws, B, grid,       \
                                         stream);                            \
  }

#ifndef QOC_ONE_VARIANT

// Exact (TC false). 512 threads (the package's), two-pass dual products,
// chunks stashed, 4 k-pairs an iteration of the products, 7 basis terms an
// iteration of K2's generator build.
VARIANT(t512_twopass_chunks_u4_k7, 512, false, false, 4, 7, false, false)
VARIANT(t512_twopass_chunks_u4_k3, 512, false, false, 4, 3, false, false)
VARIANT(t512_twopass_chunks_u4_k1, 512, false, false, 4, 1, false, false)
VARIANT(t512_twopass_chunks_u2_k7, 512, false, false, 2, 7, false, false)
VARIANT(t512_twopass_chunks_u8_k7, 512, false, false, 8, 7, false, false)
VARIANT(t256_twopass_chunks_u2_k7, 256, false, false, 2, 7, false, false)
VARIANT(t256_twopass_chunks_u4_k7, 256, false, false, 4, 7, false, false)
VARIANT(t512_onepass_chunks_u4_k7, 512, true, false, 4, 7, false, false)
VARIANT(t256_onepass_chunks_u2_k7, 256, true, false, 2, 7, false, false)
VARIANT(t512_twopass_powers_u4_k7, 512, false, true, 4, 7, false, false)
// The first design's shape: 256 threads, both accumulators, powers stashed,
// 2 k-pairs and one basis term an iteration.
VARIANT(t256_onepass_powers_u2_k1, 256, true, true, 2, 1, false, false)

// The bf16_3x mode (TC true): the package's AdjointTC, on 256 threads, with
// a shorter build, and with its elementwise passes reduced to stores
// (ABLATE true).
VARIANT(tc_t512_k7, 512, false, false, 4, 7, true, false)
VARIANT(tc_t512_k3, 512, false, false, 4, 3, true, false)
VARIANT(tc_t256_k7, 256, false, false, 4, 7, true, false)
VARIANT(tc_t512_k7_products, 512, false, false, 4, 7, true, true)

#endif  // QOC_ONE_VARIANT

#endif
