// Shared device code of the tiled matrix-exponential kernels: K3 forward
// (expm_fwd.cu), K4 Fréchet derivative (expm_frechet.cu) and the streamed
// chain K6 (stream_fwd.cu, stream_bwd.cu). The Taylor ladder and the tile
// map are chain_common.cuh's.
//
// Two designs, by the padded dimension D:
//
// - D = 64 (K3/K4): the matrix's whole ladder resident in shared memory, by
//   chain_common.cuh's expm (5 matrices) and expm_dual (6 matrices and the
//   per-block stash of the dual powers): K1/K5's step without the chain,
//   K2/K5's dual step without the recursion.
// - D = 128 ... 512 (T = D / 64 tiles a side): one complex64 matrix is
//   128 KB - 2 MB, so not even one fits the 227 KB of shared memory a block
//   may use. The ladder's matrices (M, M2, M3, M4 and two accumulators X, Y;
//   with their tangents for the dual form) live in a device-memory
//   workspace, allocated by the wrapper. A product Z = X Y walks Z's T^2
//   64 x 64 output tiles; for each it stages the 64 x 64 tiles of X's row
//   band and Y's column band through shared memory, T of each, and
//   accumulates with chain_common.cuh's mm_acc on the calling thread's 16
//   registers (FP32 SIMT FMAs, no tensor cores, no TF32). The linear
//   combinations of the ladder are fused into the products' epilogues where
//   they follow one.
//
// Who shares a workspace (Tiled's CL): K3/K4 give each block its own and
// walk the batch one matrix a block (CL = 1). K6 advances one chain at a
// time, so it splits every operation of a step across the CL blocks of a
// thread-block cluster: a product's output tiles, an elementwise pass's
// elements. Between two operations the cluster meets at a barrier
// (barrier.cluster, after a device-scope fence of the workspace writes),
// and workspace reads go to L2 (ld.global.cg): another SM wrote them, and
// an L1 line of this SM may be stale.
//
// Ladder rule, both designs and the plain versions (ops/chain.py
// _expm_ladder): the level comes from the batch-max 1-norm (by pointer,
// computed on the device by the wrapper): degree 4/8/12/19 below the
// thresholds 0.05/0.45/1.2/3.0, else per-matrix scaling to theta = 1, T19
// and squarings. The TPU kernel's general branch picks T8 when the scaled
// norm is at most 0.25 (qoc_tpu/ops/expm_pallas.py:283-290); both are
// accurate to f32 roundoff there, and the port keeps T19, as K1/K2/K5 do.

#pragma once

#include "chain_common.cuh"

namespace qoc {
namespace ex {

// Value slots of the tiled ladder; the dual form keeps their tangents in
// slots NV + s.
enum Slot { M = 0, M2, M3, M4, X, Y, NV };
constexpr int NONE = -1;

// id * I + sum_j c[j] * slot s[j] (unused terms have s = NONE). Its tangent
// drops the identity term and reads the tangent slots.
struct Lin {
  float id;
  float c[4];
  int s[4];
};

__device__ __forceinline__ Lin lin(float id, float c0 = 0.f, int s0 = NONE,
                                   float c1 = 0.f, int s1 = NONE,
                                   float c2 = 0.f, int s2 = NONE,
                                   float c3 = 0.f, int s3 = NONE) {
  return Lin{id, {c0, c1, c2, c3}, {s0, s1, s2, s3}};
}

// chunk(k) = c_k I + c_{k+1} M + c_{k+2} M2 + c_{k+3} M3 (+ c4 M4).
__device__ __forceinline__ Lin chunk(int k, float c4 = 0.f, int s4 = NONE) {
  return lin(kC[k], kC[k + 1], M, kC[k + 2], M2, kC[k + 3], M3, c4, s4);
}

// Shared memory of the tiled kernels: the staged tiles (X, Y and, dual,
// dX, dY) and a block-reduction scratch of NT floats.
template <bool DUAL>
constexpr size_t tiled_smem() {
  return (DUAL ? 4 : 2) * MAT * sizeof(float2) + NT * sizeof(float);
}

// CL blocks share one workspace and split each operation (see above). The
// workspace holds SLOTS ladder matrices, then any extra ones of the caller
// (extra(j)).
template <int T, bool DUAL, int CL = 1>
struct Tiled {
  static constexpr int D = 64 * T;
  static constexpr int N = D * D;
  static constexpr int SLOTS = DUAL ? 2 * NV : NV;
  static constexpr int STRIDE = CL * NT;  // threads of the sharing blocks

  float2* ws;  // the workspace of this block (CL = 1) or cluster
  float2* sm;  // staged tiles
  float* red;  // NT floats
  int rank;    // this block's rank among the CL

  __device__ float2* v(int s) const { return ws + (size_t)s * N; }
  __device__ float2* t(int s) const { return ws + (size_t)(NV + s) * N; }
  __device__ float2* extra(int j) const {
    return ws + (size_t)(SLOTS + j) * N;
  }

  // Workspace reads: at L2 when other SMs write the workspace.
  static __device__ __forceinline__ float2 ld(const float2* p) {
    if constexpr (CL > 1) return __ldcg(p);
    return *p;
  }
  static __device__ __forceinline__ float4 ld4(const float2* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    if constexpr (CL > 1) return __ldcg(q);
    return *q;
  }

  // Barrier of the sharing blocks, their workspace writes visible after it.
  __device__ __forceinline__ void sync() const {
    if constexpr (CL > 1) {
      __threadfence();
      // The cluster barrier (cooperative_groups' cluster sync): arrive with
      // release, wait with acquire semantics, every thread of every block.
      asm volatile(
          "barrier.cluster.arrive.aligned;\n"
          "barrier.cluster.wait.aligned;\n" ::: "memory");
    } else {
      __syncthreads();
    }
  }

  // The calling thread's first element of an elementwise pass (its stride
  // is STRIDE).
  __device__ __forceinline__ int first() const {
    return rank * NT + threadIdx.x;
  }

  __device__ float2 value(const Lin& L, int i) const {
    float2 r = make_float2(i / D == i % D ? L.id : 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE) r = caxpy(L.c[j], ld(v(L.s[j]) + i), r);
    return r;
  }

  __device__ float2 tangent(const Lin& L, int i) const {
    float2 r = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE) r = caxpy(L.c[j], ld(t(L.s[j]) + i), r);
    return r;
  }

  // slot dst = L (and its tangent), elementwise; ends with sync(). dst may
  // be one of L's terms: each element is read and written by one thread.
  __device__ void set(int dst, const Lin& L) const {
    for (int i = first(); i < N; i += STRIDE) {
      const float2 x = value(L, i);
      if (DUAL) t(dst)[i] = tangent(L, i);
      v(dst)[i] = x;
    }
    sync();
  }

  // dst = src, a D x D matrix (an input, or workspace); ends with sync().
  __device__ void copy(float2* dst, const float2* src) const {
    for (int i = first(); i < N; i += STRIDE) dst[i] = ld(src + i);
    sync();
  }

  // dst += src for workspace dst and an input src; ends with sync().
  __device__ void add(float2* dst, const float2* __restrict__ src) const {
    for (int i = first(); i < N; i += STRIDE)
      dst[i] = cadd(ld(dst + i), __ldg(src + i));
    sync();
  }

  // The 64 x 64 tile at g (row stride D) into shared memory (row stride 64),
  // 16 bytes a thread and load, coalesced.
  __device__ void stage(float2* s, const float2* g) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int r = idx >> 5, c = idx & 31;
      reinterpret_cast<float4*>(s)[idx] = ld4(g + (size_t)r * D + 2 * c);
    }
  }

  // The conjugate transpose of the 64 x 64 tile at g (row stride D) into
  // shared memory (row stride 64): coalesced reads, transposed writes.
  __device__ void stage_adjoint(float2* s, const float2* g) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int idx = threadIdx.x + NT * j;
      const int r = idx >> 5, c = idx & 31;
      const float4 q = ld4(g + (size_t)r * D + 2 * c);
      s[(2 * c) * 64 + r] = make_float2(q.x, -q.y);
      s[(2 * c + 1) * 64 + r] = make_float2(q.z, -q.w);
    }
  }

  // z = x y + L, or x y^H + L with YADJ; with dz (DUAL only) the dual
  // product, dz = dx y + x dy + tangent of L. z and dz must differ from x,
  // dx, y and dy. The CL blocks split the output tiles; ends with sync().
  template <bool YADJ = false>
  __device__ void gemm_p(const float2* x, const float2* dx, const float2* y,
                         const float2* dy, float2* z, float2* dz,
                         const Lin& L) const {
    const bool dual = DUAL && dz != nullptr;
    float2* xs = sm;
    float2* ys = sm + MAT;
    float2* dxs = sm + 2 * MAT;
    float2* dys = sm + 3 * MAT;
    for (int tile = rank; tile < T * T; tile += CL) {
      const int ti = tile / T, tj = tile % T;
      float2 acc[EPT], dacc[EPT];
      zero(acc);
      if (dual) zero(dacc);
      for (int kt = 0; kt < T; ++kt) {
        const size_t xo = (size_t)ti * 64 * D + kt * 64;
        const size_t yo = YADJ ? (size_t)tj * 64 * D + kt * 64
                               : (size_t)kt * 64 * D + tj * 64;
        stage(xs, x + xo);
        if (YADJ) stage_adjoint(ys, y + yo);
        else stage(ys, y + yo);
        if (dual) {
          stage(dxs, dx + xo);
          if (YADJ) stage_adjoint(dys, dy + yo);
          else stage(dys, dy + yo);
        }
        __syncthreads();
        mm_acc(xs, ys, acc);
        if (dual) {
          mm_acc(dxs, ys, dacc);
          mm_acc(xs, dys, dacc);
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int li = own(e);
        const int gi = (ti * 64 + li / DP) * D + tj * 64 + li % DP;
        const float2 zv = cadd(acc[e], value(L, gi));
        if (dual) dz[gi] = cadd(dacc[e], tangent(L, gi));
        z[gi] = zv;
      }
    }
    sync();
  }

  // slot dst = x y + L (dual: with tangents); dst must differ from x and y.
  __device__ void gemm(int x, int y, int dst, const Lin& L) const {
    gemm_p(v(x), DUAL ? t(x) : nullptr, v(y), DUAL ? t(y) : nullptr, v(dst),
           DUAL ? t(dst) : nullptr, L);
  }

  // Squaring count of the input matrix a (device memory) from its complex
  // 1-norm (column sums), or with ROWS from its inf-norm (row sums: the
  // 1-norm of a^H), as chain_common.cuh's scaling_count; every thread of
  // the block gets it, and every block of the CL computes the same.
  template <bool ROWS = false>
  __device__ int squarings(const float2* __restrict__ a) const {
    float n1 = 0.0f;
    for (int j = threadIdx.x; j < D; j += NT) {
      float s = 0.0f;
      for (int i = 0; i < D; ++i) {
        const float2 z = __ldg(a + (ROWS ? (size_t)j * D + i
                                         : (size_t)i * D + j));
        s += sqrtf(z.x * z.x + z.y * z.y);
      }
      n1 = fmaxf(n1, s);
    }
    red[threadIdx.x] = n1;
    __syncthreads();
    for (int o = NT / 2; o > 0; o >>= 1) {
      if (threadIdx.x < o)
        red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + o]);
      __syncthreads();
    }
    float s = ceilf(log2f(fmaxf(red[0] / 1.0f, 1.0f)));
    s = fminf(fmaxf(s, 0.0f), (float)MAX_SQUARINGS);
    __syncthreads();  // red is reused by the next matrix
    return (int)s;
  }

  // M (and dM) = scale * a (and g). Ends with sync().
  __device__ void load_scaled(const float2* __restrict__ a,
                              const float2* __restrict__ g,
                              float scale) const {
    for (int i = first(); i < N; i += STRIDE) {
      v(M)[i] = cscale(scale, __ldg(a + i));
      if (DUAL) t(M)[i] = cscale(scale, __ldg(g + i));
    }
    sync();
  }

  // M = scale * a^H and dM = scale * dM (dM written by the caller), tile by
  // tile through shared memory (coalesced both ways). Ends with sync().
  __device__ void load_adjoint_scaled(const float2* __restrict__ a,
                                      float scale) const {
    for (int tile = rank; tile < T * T; tile += CL) {
      const int ti = tile / T, tj = tile % T;
      stage_adjoint(sm, a + (size_t)tj * 64 * D + ti * 64);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int li = own(e);
        const int gi = (ti * 64 + li / DP) * D + tj * 64 + li % DP;
        v(M)[gi] = cscale(scale, sm[li]);
        if (DUAL) t(M)[gi] = cscale(scale, ld(t(M) + gi));
      }
      __syncthreads();
    }
    sync();
  }

  // The ladder on slot M (scaled already); s squarings at level 4. Returns
  // the slot that holds exp(M) (and, dual, its Fréchet derivative).
  __device__ int ladder(int level, int s) const {
    const Lin none = lin(0.0f);
    if (level == 0) {
      // Degree 4: c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2).
      gemm(M, M, M2, none);
      set(M3, lin(0.0f, kC[3], M, kC[4], M2));
      gemm(M2, M3, X, lin(kC[0], kC[1], M, kC[2], M2));
      return X;
    }
    if (level == 1) {
      // Degree 8 in 3 products (_D8X).
      gemm(M, M, M2, none);
      set(M3, lin(0.0f, kD8[0], M, kD8[1], M2));
      gemm(M2, M3, M4, none);
      set(M3, lin(0.0f, kD8[2], M2, 1.0f, M4));
      set(X, lin(kD8[3], kD8[4], M, kD8[5], M2, kD8[6], M4));
      gemm(M3, X, Y, lin(kD8[7], kD8[8], M, kD8[9], M2));
      return Y;
    }
    gemm(M, M, M2, none);
    gemm(M2, M, M3, none);
    gemm(M2, M2, M4, none);
    if (level == 2) {
      // Degree 12, Paterson-Stockmeyer: M4 (chunk(4) + M4 (chunk(8) +
      // c12 M4)) + chunk(0).
      set(X, chunk(8, kC[12], M4));
      gemm(M4, X, Y, chunk(4));
      gemm(M4, Y, X, chunk(0));
      return X;
    }
    // Degree 19, Paterson-Stockmeyer: p = chunk(16); p = p M4 + chunk(k).
    set(X, chunk(16));
    gemm(X, M4, Y, chunk(12));
    gemm(Y, M4, X, chunk(8));
    gemm(X, M4, Y, chunk(4));
    gemm(Y, M4, X, chunk(0));
    int r = X;
    for (int j = 0; j < s; ++j) {
      const int o = r == X ? Y : X;
      gemm(r, r, o, none);
      r = o;
    }
    return r;
  }
};

// Batch of matrices a (B, D, D) (and tangents g for the dual form) into out:
// exp(a), or the Fréchet derivative L(a, g). ws holds gridDim.x blocks of
// SLOTS matrices.
template <int T, bool DUAL>
__global__ void __launch_bounds__(NT, 1)
    expm_tiled_kernel(const float2* __restrict__ a,
                      const float2* __restrict__ g,
                      const float* __restrict__ norm,
                      float2* __restrict__ out, float2* ws, int B) {
  using K = Tiled<T, DUAL>;
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const K k{ws + (size_t)blockIdx.x * K::SLOTS * K::N, sm,
            reinterpret_cast<float*>(sm + (DUAL ? 4 : 2) * MAT), 0};
  const int level = ladder_level(__ldg(norm));
  for (int m = blockIdx.x; m < B; m += gridDim.x) {
    const float2* am = a + (size_t)m * K::N;
    const int s = level == 4 ? k.squarings(am) : 0;
    k.load_scaled(am, DUAL ? g + (size_t)m * K::N : nullptr,
                  exp2f(-(float)s));
    const int r = k.ladder(level, s);
    const float2* src = DUAL ? k.t(r) : k.v(r);
    float2* dst = out + (size_t)m * K::N;
    for (int i = threadIdx.x; i < K::N; i += NT) dst[i] = src[i];
    __syncthreads();  // the next matrix overwrites the slots
  }
}

// Sets the kernel's dynamic shared memory, then launches it on grid blocks.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int grid, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Blocks of the kernel resident on the current device at once (blocks per
// SM x SMs): the wrapper's grid, and the workspace it allocates.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Clusters of cl blocks of the kernel (compiled with __cluster_dims__) that
// the current device keeps resident at once.
template <typename Kernel>
int resident_clusters(Kernel kernel, size_t smem, int cl, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  return *clusters > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace ex
}  // namespace qoc
