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
// every product streams k-slices through a cp.async ring in shared memory
// (expm_common.cuh's Tiled, K3's design). A chain is sequential, and a
// chain per block would keep only S of the 132 SMs busy at a time, each for
// S times longer: here the CL = 8 blocks of a thread-block cluster advance
// one segment together, each block computing one row band (D / 8 rows) of
// every product and its share of each elementwise pass, the cluster
// meeting at a barrier between dependent operations. The grid is as many
// clusters as the card keeps resident and the device memory allows (the
// wrapper's plan), each walking its share of the segments; the running
// product P is the prefix slot the cluster wrote the step before, so the
// workspace holds the ladder's six matrices only. The next step's plane is
// loaded beside the product P_t = U_t P_{t-1}, which does not read it.
//
// The bf16_3x mode (tf32 != 0): the second form (Tiled with TC = 1,
// expm_common.cuh), every product 3 x TF32 on wgmma on the same row bands
// (the band's D / 8 rows are wgmma's N: 40-64), _D12A at degree 12, with
// two split stages and the warpgroups' staging in 128-153 KB of shared
// memory a block; the ladder's slot holds U_t - I, and the
// step is P_t = P_{t-1} + (U_t - I) P_{t-1}, P_{t-1} added in the
// epilogue, so that the tensor cores' truncation scales with U_t - I and a
// padded step (A_t = 0) leaves P exactly as it was.

#include "expm_common.cuh"

namespace qoc {
namespace fwd {

constexpr int CL = ex::STREAM_CL;  // blocks of a cluster

template <int T, int TC>
using Fwd = ex::StreamTiled<T, false, TC>;

// Slot M = the next step's plane t + 1 scaled by 2^-s, s its squarings.
template <class K>
__device__ __forceinline__ void load_next(const K& k, const float2* aseg,
                                          int t, int level, int& s) {
  const float2* an = aseg + (size_t)(t + 1) * K::N;
  s = level == 4 ? k.squarings(an) : 0;
  k.load_scaled(an, nullptr, exp2f(-(float)s));
}

template <int T, int TC>
__global__ void __launch_bounds__(NT, 1)
    stream_fwd_kernel(const float2* __restrict__ a,
                      const float* __restrict__ norm, float2* prefpad,
                      float2* ws, int S, int L) {
  using K = Fwd<T, TC>;
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;
  const K k{ws + (size_t)cluster * K::SLOTS * K::N, sm,
            reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                     K::G::RED),
            (int)(blockIdx.x % CL)};
  const int level = ladder_level(__ldg(norm));
  for (int seg = cluster; seg < S; seg += clusters) {
    const float2* aseg = a + (size_t)seg * L * K::N;
    float2* pseg = prefpad + (size_t)seg * (L + 1) * K::N;
    int s = level == 4 ? k.squarings(aseg) : 0;
    k.load_scaled(aseg, nullptr, exp2f(-(float)s));
    k.sync();
    for (int t = 0; t < L; ++t) {
      // P_t = U_t P_{t-1} (TC: P_{t-1} + (U_t - I) P_{t-1}): prefix slot
      // t + 1 from slot t; the ladder's result r is never slot M, so the
      // next plane loads beside it.
      ex::Epi e = ex::epi(ex::lin(0.0f));
      const float2* prev = pseg + (size_t)t * K::N;
      float2* next = pseg + (size_t)(t + 1) * K::N;
      if constexpr (TC) {
        // The ladder's products and then the step's, through one run().
        e.add = prev;
        const int sj = s;
        for (int j = 0;; ++j) {
          typename K::Op o;
          bool sy;
          int n;
          const int r = k.ladder_pick(level, sj, j, nullptr, nullptr, o, sy,
                                      n);
          if (j > n) break;
          if (j == n)
            o = typename K::Op{k.v(r), nullptr, prev, nullptr, next,
                               nullptr, ex::NONE, false, e};
          k.run(o);
          if (j < n) {
            if (sy) k.sync();
            continue;
          }
          if (t + 1 < L) load_next(k, aseg, t, level, s);
          k.sync();
        }
      } else {
        const int r = k.ladder(level, s, nullptr, nullptr);
        k.gemm_p(k.v(r), nullptr, prev, nullptr, next, nullptr, ex::NONE, e);
        if (t + 1 < L) load_next(k, aseg, t, level, s);
        k.sync();
      }
    }
  }
}

template <int T, int TC>
int launch_form(const void* a, const void* norm, void* prefpad, void* ws,
                int S, int L, int clusters, void* stream) {
  return ex::launch(stream_fwd_kernel<T, TC>, Fwd<T, TC>::G::SMEM,
                    clusters * CL, stream, CL,
                    static_cast<const float2*>(a),
                    static_cast<const float*>(norm),
                    static_cast<float2*>(prefpad), static_cast<float2*>(ws),
                    S, L);
}

template <int T>
int launch(const void* a, const void* norm, void* prefpad, void* ws, int S,
           int L, int clusters, int tf32, void* stream) {
  return tf32 ? launch_form<T, 1>(a, norm, prefpad, ws, S, L, clusters,
                                  stream)
              : launch_form<T, 0>(a, norm, prefpad, ws, S, L, clusters,
                                  stream);
}

// The clusters both forms keep resident; the exact form's shared memory.
template <int T>
int plan(int* clusters, int* smem) {
  *smem = (int)Fwd<T, 0>::G::SMEM;
  int tc = 0;
  int err = ex::resident_clusters(stream_fwd_kernel<T, 0>,
                                  Fwd<T, 0>::G::SMEM, CL, clusters);
  if (err == 0)
    err = ex::resident_clusters(stream_fwd_kernel<T, 1>, Fwd<T, 1>::G::SMEM,
                                CL, &tc);
  if (tc < *clusters) *clusters = tc;
  return err;
}

}  // namespace fwd
}  // namespace qoc

#ifndef QOC_KERNELS_ONLY  // (profiling/tiled_variants.cu)

// a (S, L, dp, dp) complex64 planes, zero-padded; norm -> 1 f32, their
// batch-max 1-norm; prefpad (S, L + 1, dp, dp), slot 0 = I written by the
// caller, slots 1..L by this kernel; ws (clusters, slots, dp, dp) scratch
// from qoc_stream_fwd_plan. dp is 320, 384, 448 or 512; tf32 != 0 runs the
// bf16_3x mode's form (on the same plan). Returns the CUDA error.
extern "C" int qoc_stream_fwd(const void* a, const void* norm, void* prefpad,
                              void* ws, int S, int L, int dp, int clusters,
                              int tf32, void* stream) {
  using namespace qoc;
  using namespace qoc::fwd;
  switch (dp) {
    case 320:
      return launch<5>(a, norm, prefpad, ws, S, L, clusters, tf32, stream);
    case 384:
      return launch<6>(a, norm, prefpad, ws, S, L, clusters, tf32, stream);
    case 448:
      return launch<7>(a, norm, prefpad, ws, S, L, clusters, tf32, stream);
    case 512:
      return launch<8>(a, norm, prefpad, ws, S, L, clusters, tf32, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The clusters of qoc_stream_fwd that the current device keeps resident at
// dp, the blocks a cluster has, the workspace matrices each cluster needs
// and the dynamic shared memory of a block. Returns the CUDA error.
extern "C" int qoc_stream_fwd_plan(int dp, int* clusters, int* blocks,
                                   int* slots, int* smem) {
  using namespace qoc;
  using namespace qoc::fwd;
  *blocks = CL;
  *slots = ex::NV;
  switch (dp) {
    case 320: return plan<5>(clusters, smem);
    case 384: return plan<6>(clusters, smem);
    case 448: return plan<7>(clusters, smem);
    case 512: return plan<8>(clusters, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // QOC_KERNELS_ONLY
