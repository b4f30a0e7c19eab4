// K6 forward: the streamed expm-product chain at 256 < padded d <= 512,
// written by hand for Hopper (sm_90a).
//
// Replaces qoc_tpu/ops/chain_pallas.py:_stream_fwd_kernel (launched by
// _stream_fwd_pallas). For each of S segment chains of L steps it computes
// U_t = exp(A_t) by the f32 Taylor ladder from the step's generator plane
// A_t (built by the caller: weights x basis, or any plane build), sets
// P <- U_t P and writes every prefix P_t, the backward's residuals. The
// segments are merged by the caller (ops/chain.py), as K5's are.
//
// What bounds it on the card: FP32 arithmetic. A step is 3-8 complex D^3
// products (ladder degree 4/8/12/19: 2/3/5/7, plus U P), 8 D^3 FLOP each:
// 0.72 GFLOP a product at D = 448, against one plane read and one prefix
// written (1.6 MB each), about 1800 FLOP a byte at degree 12.
//
// What the design does about it. One matrix does not fit a block's shared
// memory (1.6 MB at D = 448), so the ladder lives in a device workspace and
// every product streams 64 x 64 tiles through shared memory
// (expm_common.cuh's Tiled, K3's design). A chain is sequential, and a
// chain per block would keep only S of the 132 SMs busy at a time, each for
// S times longer: here the CL = 8 blocks of a thread-block cluster advance
// one segment together, each product's T^2 output tiles and each
// elementwise pass split among them, the cluster meeting at a barrier
// between operations. The grid is as many clusters as the card keeps
// resident and the device memory allows (the wrapper's plan), each walking
// its share of the segments; the running product P is the prefix slot the
// cluster wrote the step before, so the workspace holds the ladder's six
// matrices only.

#include "expm_common.cuh"

namespace qoc {
namespace {

constexpr int CL = 8;  // blocks of a cluster

template <int T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
    stream_fwd_kernel(const float2* __restrict__ a,
                      const float* __restrict__ norm, float2* prefpad,
                      float2* ws, int S, int L) {
  using K = ex::Tiled<T, false, CL>;
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;
  const K k{ws + (size_t)cluster * K::SLOTS * K::N, sm,
            reinterpret_cast<float*>(sm + 2 * MAT), (int)(blockIdx.x % CL)};
  const int level = ladder_level(__ldg(norm));
  for (int seg = cluster; seg < S; seg += clusters) {
    const float2* aseg = a + (size_t)seg * L * K::N;
    float2* pseg = prefpad + (size_t)seg * (L + 1) * K::N;
    for (int t = 0; t < L; ++t) {
      const float2* at = aseg + (size_t)t * K::N;
      const int s = level == 4 ? k.squarings(at) : 0;
      k.load_scaled(at, nullptr, exp2f(-(float)s));
      const int r = k.ladder(level, s);
      // P_t = U_t P_{t-1}: prefix slot t + 1 from slot t.
      k.gemm_p(k.v(r), nullptr, pseg + (size_t)t * K::N, nullptr,
               pseg + (size_t)(t + 1) * K::N, nullptr, ex::lin(0.0f));
    }
  }
}

template <int T>
int launch(const void* a, const void* norm, void* prefpad, void* ws, int S,
           int L, int clusters, void* stream) {
  return ex::launch(stream_fwd_kernel<T>, ex::tiled_smem<false>(),
                    clusters * CL, stream, static_cast<const float2*>(a),
                    static_cast<const float*>(norm),
                    static_cast<float2*>(prefpad), static_cast<float2*>(ws),
                    S, L);
}

template <int T>
int plan(int* clusters) {
  return ex::resident_clusters(stream_fwd_kernel<T>,
                               ex::tiled_smem<false>(), CL, clusters);
}

}  // namespace
}  // namespace qoc

// a (S, L, dp, dp) complex64 planes, zero-padded; norm -> 1 f32, their
// batch-max 1-norm; prefpad (S, L + 1, dp, dp), slot 0 = I written by the
// caller, slots 1..L by this kernel; ws (clusters, slots, dp, dp) scratch
// from qoc_stream_fwd_plan. dp is 320, 384, 448 or 512. Returns the CUDA
// error.
extern "C" int qoc_stream_fwd(const void* a, const void* norm, void* prefpad,
                              void* ws, int S, int L, int dp, int clusters,
                              void* stream) {
  using namespace qoc;
  switch (dp) {
    case 320: return launch<5>(a, norm, prefpad, ws, S, L, clusters, stream);
    case 384: return launch<6>(a, norm, prefpad, ws, S, L, clusters, stream);
    case 448: return launch<7>(a, norm, prefpad, ws, S, L, clusters, stream);
    case 512: return launch<8>(a, norm, prefpad, ws, S, L, clusters, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The clusters of qoc_stream_fwd that the current device keeps resident at
// dp, the blocks a cluster has, and the workspace matrices each cluster
// needs. Returns the CUDA error.
extern "C" int qoc_stream_fwd_plan(int dp, int* clusters, int* blocks,
                                   int* slots) {
  using namespace qoc;
  *blocks = CL;
  *slots = ex::NV;
  switch (dp) {
    case 320: return plan<5>(clusters);
    case 384: return plan<6>(clusters);
    case 448: return plan<7>(clusters);
    case 512: return plan<8>(clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}
