// Variants of K3/K4's tiled form (qoc_tpu_torch/csrc/expm_common.cuh) for
// profiling/tiled_variants.py: the same kernel, expm_tiled_kernel, on other
// Tiled shapes (blocks sharing a matrix, register tiles), each behind a C
// entry that plans (groups = 0: resident groups and shared memory) or
// launches. The package builds only ExpmTiled's shapes; this file is built
// by the script alone.

#include "../qoc_tpu_torch/csrc/expm_common.cuh"

#define VARIANT(NAME, T, DUAL, CL, TM, TN, GI)                                \
  extern "C" int NAME(const void* a, const void* g, const void* norm,         \
                      void* out, void* ws, int B, int groups, void* stream,   \
                      int* smem, int* resident, int* slots) {                 \
    using K = qoc::ex::Tiled<T, DUAL, CL, TM, TN, GI>;                        \
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

// K3 (exp) at D = 128: one block a matrix on 8 x 2 (the package's), 4 x 4
// and 8 x 4 register tiles; clusters of 2 and 4 blocks a matrix.
VARIANT(k3_block_8x2, 2, false, 1, 8, 2, 8)
VARIANT(k3_block_4x4, 2, false, 1, 4, 4, 16)
VARIANT(k3_block_8x4, 2, false, 1, 8, 4, 16)
VARIANT(k3_cluster2_8x2, 2, false, 2, 8, 2, 8)
VARIANT(k3_cluster4_8x2, 2, false, 4, 8, 2, 8)
// K4 (Fréchet) at D = 128: the same, 8 x 4 the package's.
VARIANT(k4_block_8x2, 2, true, 1, 8, 2, 8)
VARIANT(k4_block_4x4, 2, true, 1, 4, 4, 16)
VARIANT(k4_block_8x4, 2, true, 1, 8, 4, 16)
VARIANT(k4_cluster4_8x2, 2, true, 4, 8, 2, 8)
