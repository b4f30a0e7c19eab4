// K6 adjoint: exact gradient of the streamed chain at 256 < padded d <= 512,
// written by hand for Hopper (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_stream_bwd_kernel (launched by
// _stream_bwd_pallas), in its last-step-seed mode. K5's recursion
// (plane_bwd.cu) at these sizes; for each segment chain, t = L-1 .. 0:
//
//   T_t           = seed (t = L-1), else U_{t+1}^H T_{t+1}
//   gU_t          = T_t P_{t-1}^H
//   (U_t^H, gA_t) = dual Taylor at (A_t^H, gU_t)
//
// gA_t, the gradient of the step's generator plane in PyTorch's convention
// (dL/dRe + i dL/dIm), is written out per step. (qoc_tpu's kernel carries
// the conjugate of this recursion and emits conj Ā; the two agree.) U^H is
// never taken for U^-1: the Lindblad generators are not anti-Hermitian.
//
// What bounds it on the card: FP32 arithmetic, 2 + 3 x (2/3/5/7) complex
// D^3 products a step at degree 4/8/12/19, about three times the forward.
//
// What the design does about it: the forward's (stream_fwd.cu), with the
// dual ladder (K4's tiled form: value and tangent slots, four staged tiles
// a k-step). A_t^H and P_{t-1}^H are read conjugate-transposed tile by tile
// through shared memory, so the caller keeps one copy of the planes and
// prefixes. The workspace holds the twelve dual slots and the carry T
// (two slots, written alternately); U_{t+1}^H is the value slot the
// previous step's ladder returned.

#include "expm_common.cuh"

namespace qoc {
namespace {

constexpr int CL = 8;  // blocks of a cluster

template <int T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
    stream_bwd_kernel(const float2* __restrict__ a,
                      const float* __restrict__ norm,
                      const float2* __restrict__ prefpad,
                      const float2* __restrict__ seeds, float2* gA,
                      float2* ws, int S, int L) {
  using K = ex::Tiled<T, true, CL>;
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;
  const K k{ws + (size_t)cluster * (K::SLOTS + 2) * K::N, sm,
            reinterpret_cast<float*>(sm + 4 * MAT), (int)(blockIdx.x % CL)};
  const int level = ladder_level(__ldg(norm));
  const ex::Lin none = ex::lin(0.0f);
  for (int seg = cluster; seg < S; seg += clusters) {
    const float2* aseg = a + (size_t)seg * L * K::N;
    const float2* pseg = prefpad + (size_t)seg * (L + 1) * K::N;
    float2* gseg = gA + (size_t)seg * L * K::N;
    float2* tc = k.extra(0);
    float2* tn = k.extra(1);
    int r = ex::X;
    for (int t = L - 1; t >= 0; --t) {
      if (t == L - 1) {
        k.copy(tc, seeds + (size_t)seg * K::N);
      } else {
        k.gemm_p(k.v(r), nullptr, tc, nullptr, tn, nullptr, none);
        float2* swap = tc;
        tc = tn;
        tn = swap;
      }
      // gU_t = T_t P_{t-1}^H into the tangent of slot M.
      k.template gemm_p<true>(tc, nullptr, pseg + (size_t)t * K::N, nullptr,
                              k.t(ex::M), nullptr, none);
      const float2* at = aseg + (size_t)t * K::N;
      const int s = level == 4 ? k.template squarings<true>(at) : 0;
      k.load_adjoint_scaled(at, exp2f(-(float)s));
      r = k.ladder(level, s);
      k.copy(gseg + (size_t)t * K::N, k.t(r));
    }
  }
}

template <int T>
int launch(const void* a, const void* norm, const void* prefpad,
           const void* seeds, void* gA, void* ws, int S, int L, int clusters,
           void* stream) {
  return ex::launch(stream_bwd_kernel<T>, ex::tiled_smem<true>(),
                    clusters * CL, stream, static_cast<const float2*>(a),
                    static_cast<const float*>(norm),
                    static_cast<const float2*>(prefpad),
                    static_cast<const float2*>(seeds),
                    static_cast<float2*>(gA), static_cast<float2*>(ws), S, L);
}

template <int T>
int plan(int* clusters) {
  return ex::resident_clusters(stream_bwd_kernel<T>, ex::tiled_smem<true>(),
                               CL, clusters);
}

}  // namespace
}  // namespace qoc

// a (S, L, dp, dp) complex64, the forward's planes; norm -> 1 f32, their
// batch-max inf-norm (the 1-norm of A^H); prefpad (S, L + 1, dp, dp) from
// the forward; seeds (S, dp, dp); gA (S, L, dp, dp) out; ws (clusters,
// slots, dp, dp) scratch from qoc_stream_bwd_plan. dp is 320, 384, 448 or
// 512. Returns the CUDA error.
extern "C" int qoc_stream_bwd(const void* a, const void* norm,
                              const void* prefpad, const void* seeds,
                              void* gA, void* ws, int S, int L, int dp,
                              int clusters, void* stream) {
  using namespace qoc;
  switch (dp) {
    case 320:
      return launch<5>(a, norm, prefpad, seeds, gA, ws, S, L, clusters,
                       stream);
    case 384:
      return launch<6>(a, norm, prefpad, seeds, gA, ws, S, L, clusters,
                       stream);
    case 448:
      return launch<7>(a, norm, prefpad, seeds, gA, ws, S, L, clusters,
                       stream);
    case 512:
      return launch<8>(a, norm, prefpad, seeds, gA, ws, S, L, clusters,
                       stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As qoc_stream_fwd_plan, for the adjoint. Returns the CUDA error.
extern "C" int qoc_stream_bwd_plan(int dp, int* clusters, int* blocks,
                                   int* slots) {
  using namespace qoc;
  *blocks = CL;
  *slots = 2 * ex::NV + 2;
  switch (dp) {
    case 320: return plan<5>(clusters);
    case 384: return plan<6>(clusters);
    case 448: return plan<7>(clusters);
    case 512: return plan<8>(clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}
