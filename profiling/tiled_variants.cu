// Variants of the tiled kernels (qoc_tpu_torch/csrc/expm_common.cuh) for
// profiling/tiled_variants.py: K3/K4's expm_tiled_kernel on other Tiled
// shapes (blocks sharing a matrix, register tiles), and each tiled
// kernel's bf16_3x mode in the form the package does not run there, each
// behind a C entry that plans (groups = 0: resident groups and shared
// memory) or launches. The mode's two forms: Product<1> (wgmma on operands
// split once a k-slice; the package's for K6) and Product<2> (PR 11's
// mma.sync, fragments split at every read; the package's for K3/K4). The
// package builds only its own shapes and forms; this file is built by the
// script alone.

#include "../qoc_tpu_torch/csrc/expm_common.cuh"


// K6's kernels, without the package's C entries, for STREAM_VARIANT below.
#define QOC_KERNELS_ONLY
#include "../qoc_tpu_torch/csrc/stream_bwd.cu"
#include "../qoc_tpu_torch/csrc/stream_fwd.cu"

#define VARIANT(NAME, T, DUAL, CL, TM, TN, GI, F)                             \
  extern "C" int NAME(const void* a, const void* g, const void* norm,         \
                      void* out, void* ws, int B, int groups, void* stream,   \
                      int* smem, int* resident, int* slots) {                 \
    using K = qoc::ex::Tiled<T, DUAL, CL, TM, TN, GI, F>;                     \
    auto kernel = qoc::ex::expm_tiled_kernel<K>;                              \
    *smem = (int)K::G::SMEM;                                                  \
    *slots = K::SLOTS;                                                        \
    if (groups == 0)                                                          \
      return CL == 1                                                          \
                 ? qoc::ex::resident_blocks(kernel, K::G::SMEM, resident)     \
                 : qoc::ex::resident_clusters(kernel, K::G::SMEM, CL,         \
                                              resident);                      \
    return qoc::ex::launch(kernel, K::G::SMEM, groups * CL, stream, CL,       \
                           (const float2*)a, (const float2*)g,                \
                           (const float*)norm, (float2*)out, (float2*)ws, B); \
  }

#ifndef QOC_MODE_ONLY  // (tiled_variants.py --mode-only)
// K3 (exp) at D = 128: one block a matrix on 8 x 2 (the package's), 4 x 4
// and 8 x 4 register tiles; clusters of 2 and 4 blocks a matrix.
VARIANT(k3_block_8x2, 2, false, 1, 8, 2, 8, 0)
VARIANT(k3_block_4x4, 2, false, 1, 4, 4, 16, 0)
VARIANT(k3_block_8x4, 2, false, 1, 8, 4, 16, 0)
VARIANT(k3_cluster2_8x2, 2, false, 2, 8, 2, 8, 0)
VARIANT(k3_cluster4_8x2, 2, false, 4, 8, 2, 8, 0)
// K4 (Fréchet) at D = 128: the same, 8 x 4 the package's.
VARIANT(k4_block_8x2, 2, true, 1, 8, 2, 8, 0)
VARIANT(k4_block_4x4, 2, true, 1, 4, 4, 16, 0)
VARIANT(k4_block_8x4, 2, true, 1, 8, 4, 16, 0)
VARIANT(k4_cluster4_8x2, 2, true, 4, 8, 2, 8, 0)
#endif
// The bf16_3x forms at D = 128: the package's (mma.sync, K4 on 128 x 64
// panels) and the wgmma form (64 x 64 panels for both).
VARIANT(k3_mode_mmasync, 2, false, 1, 8, 2, 8, 2)
VARIANT(k3_mode_wgmma, 2, false, 1, 8, 2, 8, 1)
VARIANT(k4_mode_mmasync, 2, true, 1, 8, 4, 16, 2)
VARIANT(k4_mode_wgmma, 2, true, 1, 8, 2, 8, 1)

// K6 at padded 448 (the Lindblad d = 20 planes) in either bf16_3x form F
// (the package's: 1), on the package's plan (clusters, workspace).
#define STREAM_VARIANT(NAME, F)                                               \
  extern "C" int NAME##_fwd(const void* a, const void* norm, void* pref,      \
                            void* ws, int S, int L, int clusters,             \
                            void* stream) {                                   \
    return qoc::fwd::launch_form<7, F>(a, norm, pref, ws, S, L, clusters,     \
                                       stream);                               \
  }                                                                           \
  extern "C" int NAME##_bwd(const void* a, const void* norm,                  \
                            const void* pref, const void* seeds, void* gA,    \
                            void* ws, int S, int L, int per_step,             \
                            int clusters, void* stream) {                     \
    return qoc::bwd::launch_form<7, F>(a, norm, pref, seeds, gA, ws, S, L,    \
                                       per_step != 0, clusters, stream);      \
  }

STREAM_VARIANT(k6_mode_mmasync, 2)
STREAM_VARIANT(k6_mode_wgmma, 1)
