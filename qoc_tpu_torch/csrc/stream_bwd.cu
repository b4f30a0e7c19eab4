// K6 adjoint: exact gradient of the streamed chain at 256 < padded d <= 512,
// written by hand for Hopper (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_stream_bwd_kernel (launched by
// _stream_bwd_pallas), in both its seed modes. K5's recursion
// (plane_bwd.cu) at these sizes; for each segment chain, t = L-1 .. 0:
//
//   T_t           = seed_{L-1} (t = L-1), else U_{t+1}^H T_{t+1} [+ seed_t]
//   gU_t          = T_t P_{t-1}^H
//   (U_t^H, gA_t) = dual Taylor at (A_t^H, gU_t)
//
// gA_t, the gradient of the step's generator plane in PyTorch's convention
// (dL/dRe + i dL/dIm), is written out per step. (qoc_tpu's kernel carries
// the conjugate of this recursion and emits conj Ā; the two agree.) U^H is
// never taken for U^-1: the Lindblad generators are not anti-Hermitian.
// The bracketed seed is the per-step-seed mode's (per_step), as in K2: one
// more elementwise pass a step, split across the cluster's blocks like the
// others. qoc_tpu's kernel runs one whole chain a grid step and folds the
// total's gradient into the last step's seed; here the chain is segmented
// like K5's, so its per-step seeds come from the same segment chain rule.
//
// What bounds it on the card: FP32 arithmetic, 2 + 3 x (2/3/5/7) complex
// D^3 products a step at degree 4/8/12/19, about three times the forward.
//
// What the design does about it: the forward's (stream_fwd.cu), with the
// dual ladder (value and tangent slots; a dual product is its value's
// product and its tangent's, [dX X] [Y; dY], of twice the depth, through
// the forward's ring and register tile: expm_common.cuh). Each of the
// cluster's 8 blocks computes one row band (D / 8 rows) of every product,
// so no block waits on a ragged last round of 64 x 64 tiles. A step has
// five cluster barriers at degree 8: after T_t = U_{t+1}^H T_{t+1} (the
// per-step seed added in its epilogue), after gU_t with the plane's
// conjugate transpose loaded beside it (gU_t scaled by 2^-s in its
// epilogue), and after each of the ladder's three products (its
// elementwise passes fused into their epilogues; the last also writes gA_t
// out). A_t^H and P_{t-1}^H are read conjugate-transposed through shared
// memory, so the caller keeps one copy of the planes and prefixes. The
// workspace holds the twelve dual slots and the carry T (two slots,
// written alternately); U_{t+1}^H is the value slot the
// previous step's ladder returned.
//
// The bf16_3x mode (tf32 != 0): the second form (Tiled with TC = 1,
// expm_common.cuh), every product (the T update, gU_t and the dual ladder)
// 3 x TF32 on wgmma, _D12A in dual form at degree 12 (gU_t's P_{t-1}^H is
// copied into the ring as it is, and its split conjugates it); the value
// slot holds U^H - I, and the T update is T_{t+1} + (U_{t+1}^H - I) T_{t+1}
// [+ seed_t], T_{t+1} read in the epilogue, so that a padded step carries T
// exactly.

#include "expm_common.cuh"

namespace qoc {
namespace bwd {

constexpr int CL = ex::STREAM_CL;  // blocks of a cluster

template <int T, int TC>
using Bwd = ex::StreamTiled<T, true, TC>;

template <int T, int TC>
__global__ void __launch_bounds__(NT, 1)
    stream_bwd_kernel(const float2* __restrict__ a,
                      const float* __restrict__ norm,
                      const float2* __restrict__ prefpad,
                      const float2* __restrict__ seeds, float2* gA,
                      float2* ws, int S, int L, bool per_step) {
  using K = Bwd<T, TC>;
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;
  const K k{ws + (size_t)cluster * (K::SLOTS + 2) * K::N, sm,
            reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                     K::G::RED),
            (int)(blockIdx.x % CL)};
  const int level = ladder_level(__ldg(norm));
  const ex::Epi none = ex::epi(ex::lin(0.0f));
  for (int seg = cluster; seg < S; seg += clusters) {
    const float2* aseg = a + (size_t)seg * L * K::N;
    const float2* pseg = prefpad + (size_t)seg * (L + 1) * K::N;
    float2* gseg = gA + (size_t)seg * L * K::N;
    int tc = 0;  // T_t is extra(tc), T_{t-1} goes to extra(1 - tc)
    int r = ex::X;
    for (int t = L - 1; t >= 0; --t) {
      const float2* seed = step_seed(seeds, seg, t, L, per_step, K::N);
      const float2* at = aseg + (size_t)t * K::N;
      float2* gt = gseg + (size_t)t * K::N;
      // U_{t+1}^H T_{t+1} (TC: T_{t+1} + (U_{t+1}^H - I) T_{t+1}), plus
      // (per-step mode) the step's seed.
      ex::Epi et = none;
      if constexpr (TC) et.L = ex::lin(0.0f, 1.0f, K::SLOTS + tc);
      et.add = seed;
      if constexpr (TC) {
        // The T update, gU_t and the ladder's products through one run().
        int s = 0;
        for (int j = 0;; ++j) {
          typename K::Op o;
          bool sy = true;
          if (j == 0) {
            o = typename K::Op{k.v(r), nullptr, k.extra(tc), nullptr,
                               k.extra(1 - tc), nullptr, ex::NONE, false,
                               et};
          } else if (j == 1) {
            s = level == 4 ? k.template squarings<true>(at) : 0;
            ex::Epi e = none;
            e.alpha = exp2f(-(float)s);
            o = typename K::Op{k.extra(tc), nullptr, pseg + (size_t)t * K::N,
                               nullptr, k.t(ex::M), nullptr, ex::NONE, true,
                               e};
          } else {
            int n;
            const int rr = k.ladder_pick(level, s, j - 2, nullptr, gt, o, sy,
                                         n);
            if (j - 2 == n) {
              r = rr;
              break;
            }
          }
          if (j == 0 && t == L - 1) k.copy(k.extra(tc), seed);
          else k.run(o);
          if (j == 0 && t < L - 1) tc = 1 - tc;
          if (j == 1) k.load_adjoint_scaled(at, exp2f(-(float)s));
          if (sy) k.sync();
        }
        continue;
      }
      if (t == L - 1) {
        k.copy(k.extra(tc), seed);
      } else {
        k.gemm_p(k.v(r), nullptr, k.extra(tc), nullptr, k.extra(1 - tc),
                 nullptr, ex::NONE, et);
        tc = 1 - tc;
      }
      k.sync();
      // gU_t = 2^-s T_t P_{t-1}^H into the tangent of slot M, and the
      // value of slot M = 2^-s A_t^H beside it.
      const int s = level == 4 ? k.template squarings<true>(at) : 0;
      const float scale = exp2f(-(float)s);
      ex::Epi e = none;
      e.alpha = scale;
      k.template gemm_p<true>(k.extra(tc), nullptr, pseg + (size_t)t * K::N,
                              nullptr, k.t(ex::M), nullptr, ex::NONE, e);
      k.load_adjoint_scaled(at, scale);
      k.sync();
      r = k.ladder(level, s, nullptr, gt);
    }
  }
}

template <int T, int TC>
int launch_form(const void* a, const void* norm, const void* prefpad,
                const void* seeds, void* gA, void* ws, int S, int L,
                bool per_step, int clusters, void* stream) {
  return ex::launch(stream_bwd_kernel<T, TC>, Bwd<T, TC>::G::SMEM,
                    clusters * CL, stream, CL, static_cast<const float2*>(a),
                    static_cast<const float*>(norm),
                    static_cast<const float2*>(prefpad),
                    static_cast<const float2*>(seeds),
                    static_cast<float2*>(gA), static_cast<float2*>(ws), S, L,
                    per_step);
}

template <int T>
int launch(const void* a, const void* norm, const void* prefpad,
           const void* seeds, void* gA, void* ws, int S, int L, bool per_step,
           int clusters, int tf32, void* stream) {
  return tf32 ? launch_form<T, 1>(a, norm, prefpad, seeds, gA, ws, S, L,
                                  per_step, clusters, stream)
              : launch_form<T, 0>(a, norm, prefpad, seeds, gA, ws, S, L,
                                  per_step, clusters, stream);
}

// The clusters both forms keep resident; the exact form's shared memory.
template <int T>
int plan(int* clusters, int* smem) {
  *smem = (int)Bwd<T, 0>::G::SMEM;
  int tc = 0;
  int err = ex::resident_clusters(stream_bwd_kernel<T, 0>,
                                  Bwd<T, 0>::G::SMEM, CL, clusters);
  if (err == 0)
    err = ex::resident_clusters(stream_bwd_kernel<T, 1>, Bwd<T, 1>::G::SMEM,
                                CL, &tc);
  if (tc < *clusters) *clusters = tc;
  return err;
}

}  // namespace bwd
}  // namespace qoc

#ifndef QOC_KERNELS_ONLY  // (profiling/tiled_variants.cu)

// a (S, L, dp, dp) complex64, the forward's planes; norm -> 1 f32, their
// batch-max inf-norm (the 1-norm of A^H); prefpad (S, L + 1, dp, dp) from
// the forward; seeds (S, dp, dp), or (S, L, dp, dp) with per_step != 0; gA
// (S, L, dp, dp) out; ws (clusters, slots, dp, dp) scratch from
// qoc_stream_bwd_plan. dp is 320, 384, 448 or 512; tf32 != 0 runs the
// bf16_3x mode's form (on the same plan). Returns the CUDA error.
extern "C" int qoc_stream_bwd(const void* a, const void* norm,
                              const void* prefpad, const void* seeds,
                              void* gA, void* ws, int S, int L, int dp,
                              int clusters, int per_step, int tf32,
                              void* stream) {
  using namespace qoc;
  using namespace qoc::bwd;
  const bool steps = per_step != 0;
  switch (dp) {
    case 320:
      return launch<5>(a, norm, prefpad, seeds, gA, ws, S, L, steps,
                       clusters, tf32, stream);
    case 384:
      return launch<6>(a, norm, prefpad, seeds, gA, ws, S, L, steps,
                       clusters, tf32, stream);
    case 448:
      return launch<7>(a, norm, prefpad, seeds, gA, ws, S, L, steps,
                       clusters, tf32, stream);
    case 512:
      return launch<8>(a, norm, prefpad, seeds, gA, ws, S, L, steps,
                       clusters, tf32, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As qoc_stream_fwd_plan, for the adjoint. Returns the CUDA error.
extern "C" int qoc_stream_bwd_plan(int dp, int* clusters, int* blocks,
                                   int* slots, int* smem) {
  using namespace qoc;
  using namespace qoc::bwd;
  *blocks = CL;
  *slots = 2 * ex::NV + 2;
  switch (dp) {
    case 320: return plan<5>(clusters, smem);
    case 384: return plan<6>(clusters, smem);
    case 448: return plan<7>(clusters, smem);
    case 512: return plan<8>(clusters, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // QOC_KERNELS_ONLY
