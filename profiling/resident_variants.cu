// Variants of the resident adjoint (K2 and K5's adjoint,
// qoc_tpu_torch/csrc/chain_common.cuh Adjoint) for
// profiling/resident_variants.py: the same kernels, chain_bwd_kernel and
// plane_bwd_kernel, on other Adjoint shapes (threads a block, dual products
// accumulated in one pass or two, chunks or powers stashed, k-pairs a loop
// iteration of the products, basis terms a loop iteration of K2's generator
// build), each behind a
// C entry with the package's arguments (qoc_chain_bwd, qoc_plane_bwd). The
// package builds only Adjoint<512>; this file is built by the script alone.

#include "../qoc_tpu_torch/csrc/chain_bwd.cu"
#include "../qoc_tpu_torch/csrc/plane_bwd.cu"

#define VARIANT(NAME, NTH, BOTH_ACCUMULATORS, STASH_POWERS, UNROLL, KU)      \
  extern "C" int NAME##_chain(const void* w, const void* basis_h,            \
                              const void* norm, const void* prefpad,         \
                              const void* seeds, void* gA, void* stash,      \
                              int S, int L, int n_b, int per_step,           \
                              void* stream) {                                \
    return qoc::launch_chain_bwd<                                            \
        qoc::Adjoint<NTH, BOTH_ACCUMULATORS, STASH_POWERS, UNROLL, KU>>(     \
        w, basis_h, norm, prefpad, seeds, gA, stash, S, L, n_b, per_step,    \
        stream);                                                             \
  }                                                                          \
  extern "C" int NAME##_plane(const void* a, const void* norm,               \
                              const void* prefpad, const void* seeds,        \
                              void* gA, void* stash, int S, int L,           \
                              int per_step, void* stream) {                  \
    return qoc::launch_plane_bwd<                                            \
        qoc::Adjoint<NTH, BOTH_ACCUMULATORS, STASH_POWERS, UNROLL, KU>>(     \
        a, norm, prefpad, seeds, gA, stash, S, L, per_step, stream);         \
  }

// 512 threads (the package's), two-pass dual products, chunks stashed, 4
// k-pairs an iteration of the products, 7 basis terms an iteration of K2's
// generator build.
VARIANT(t512_twopass_chunks_u4_k7, 512, false, false, 4, 7)
VARIANT(t512_twopass_chunks_u4_k3, 512, false, false, 4, 3)
VARIANT(t512_twopass_chunks_u4_k1, 512, false, false, 4, 1)
VARIANT(t512_twopass_chunks_u2_k7, 512, false, false, 2, 7)
VARIANT(t512_twopass_chunks_u8_k7, 512, false, false, 8, 7)
VARIANT(t256_twopass_chunks_u2_k7, 256, false, false, 2, 7)
VARIANT(t256_twopass_chunks_u4_k7, 256, false, false, 4, 7)
VARIANT(t512_onepass_chunks_u4_k7, 512, true, false, 4, 7)
VARIANT(t256_onepass_chunks_u2_k7, 256, true, false, 2, 7)
VARIANT(t512_twopass_powers_u4_k7, 512, false, true, 4, 7)
// The first design's shape: 256 threads, both accumulators, powers stashed,
// 2 k-pairs and one basis term an iteration.
VARIANT(t256_onepass_powers_u2_k1, 256, true, true, 2, 1)
