// Variants of the resident adjoint (K2, K5's adjoint and K4 at D = 64:
// qoc_tpu_torch/csrc/chain_common.cuh Adjoint) for
// profiling/resident_variants.py: the package's kernels, chain_bwd_kernel,
// plane_bwd_kernel and frechet_resident_kernel, on other Adjoint shapes
// (threads a block, dual products accumulated in one pass or two, chunks or
// powers stashed, k-pairs a loop iteration of the exact product, basis terms
// a loop iteration of K2's generator build, the bf16_3x mode, and the
// ablation of the step's elementwise passes), each behind C entries with
// the package's arguments (qoc_chain_bwd, qoc_plane_bwd, and
// qoc_expm_frechet's at dp = 64). The script builds one variant a
// translation unit (QOC_ONE_VARIANT and that variant's line), all at once;
// built as it stands, the file holds every variant.

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
