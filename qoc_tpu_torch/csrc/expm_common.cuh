// Shared device code of the tiled matrix-exponential kernels: K3 forward
// (expm_fwd.cu), K4 Fréchet derivative (expm_frechet.cu) and the streamed
// chain K6 (stream_fwd.cu, stream_bwd.cu). The Taylor ladder and the
// constants are chain_common.cuh's.
//
// Two designs, by the padded dimension D:
//
// - D = 64 (K3/K4): the matrix's whole ladder resident in shared memory, by
//   chain_common.cuh's expm (5 matrices) and Adjoint::expm_dual (6 matrices
//   and the per-block stash of the Paterson-Stockmeyer chunks): K1/K5's
//   step without the chain, K2/K5's dual step without the recursion.
// - D = 128 ... 512 (T = D / 64): one complex64 matrix is 128 KB - 2 MB, so
//   not even one fits the 227 KB of shared memory a block may use. The
//   ladder's matrices (M, M2, M3, M4 and two accumulators X, Y; with their
//   tangents for the dual form) live in a device-memory workspace, shared
//   by the CL blocks of a thread-block cluster (Tiled below).
//
// The tiled product Z = X Y (Tiled::gemm_p). Z is cut into PR x PC panels;
// the CL blocks sharing a workspace take the panels in turn, so an even
// panel count splits every product evenly. Each thread of a block owns a
// TM x TN register tile of a panel (Tile) and accumulates it with FP32 SIMT
// FMAs (no tensor cores, no TF32). The operands stream through shared
// memory in k-slices 32 deep (a PR x 32 slice of X, a 32 x PC slice of Y),
// in a ring of NS stages filled by cp.async.cg (16 bytes a thread, at L2):
// while the FMAs run on one slice, the next NS - 1 are in flight, across
// the block's panels. The dual product (X, dX)(Y, dY) is two such products
// on one accumulator: X Y, then its tangent dX Y + X dY as one product of
// twice the depth, [dX X] [Y; dY]; so it needs no more registers or shared
// memory than a plain one (holding both accumulators and four staged
// slices took 255 registers and spilled). The conjugate
// transpose Y^H (YADJ) cannot be copied as it is, so its slices go through
// registers into the same ring, synchronously. The epilogue of a panel
// adds a linear combination of ladder matrices (Lin), scales, adds an
// input, copies the result out of the workspace, and computes up to two
// further ladder matrices from the new element (the "posts": the ladder's
// elementwise passes, fused where the product's own elements are all they
// need).
//
// Who shares a workspace (CL): K3/K4 give each block its own and walk the
// batch one matrix a block (CL = 1: clusters of 2 or 4 blocks a matrix,
// whose ladders would fit the L2, measured slower at D = 128;
// profiling/tiled_variants.py). K6 advances one chain at a time, so the
// CL = 8 blocks of a thread-block cluster split every operation of a
// step, each block one row band (PR = D / 8) of every product. Between two dependent operations
// the sharing blocks meet at a barrier (with CL > 1 barrier.cluster, after
// a device-scope fence of the workspace writes), and their workspace reads
// go to L2 (ld.global.cg, cp.async.cg): another SM wrote them, and an L1
// line of this SM may be stale.
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

// What a product's epilogue does with each element z of Z = alpha X Y + L:
// adds add[i] (an input), copies z (and, dual, dz) to vout (tout), and
// sets slot post_dst[j] = post[j], where a term on the product's own slot
// reads the new z.
struct Epi {
  Lin L;
  float alpha;
  const float2* add;
  float2* vout;
  float2* tout;
  int post_dst[2];
  Lin post[2];
};

__device__ __forceinline__ Epi epi(const Lin& L) {
  return Epi{L, 1.0f, nullptr, nullptr, nullptr, {NONE, NONE}, {L, L}};
}

__device__ __forceinline__ Epi epi_post(const Lin& L, int d0, const Lin& p0,
                                        int d1 = NONE, const Lin& p1 = {}) {
  Epi e = epi(L);
  e.post_dst[0] = d0;
  e.post[0] = p0;
  e.post_dst[1] = d1;
  e.post[1] = p1;
  return e;
}

__device__ __forceinline__ Epi epi_out(const Lin& L, float2* vout,
                                       float2* tout) {
  Epi e = epi(L);
  e.vout = vout;
  e.tout = tout;
  return e;
}

// A thread's register tile of a product's output panel: the NT threads
// form a GI x GJ grid, thread (i, j) owning rows i + GI r (r < TM) and
// columns j + GJ c (c < TN) of a PR x PC panel.
template <int TM, int TN, int GI>
struct Tile {
  static constexpr int GJ = NT / GI;
  static constexpr int PR = GI * TM;  // panel rows
  static constexpr int PC = GJ * TN;  // panel columns
  static constexpr int EP = TM * TN;  // a thread's elements a panel
  static __device__ __forceinline__ int i() { return threadIdx.x / GJ; }
  static __device__ __forceinline__ int j() { return threadIdx.x % GJ; }
  // Row and column in the panel of the thread's element e.
  static __device__ __forceinline__ int row(int e) {
    return i() + GI * (e / TN);
  }
  static __device__ __forceinline__ int col(int e) {
    return j() + GJ * (e % TN);
  }
};

// acc += X Y for a PR x KD slice X (row stride KD) and a KD x PC slice Y
// (row stride PC) in shared memory, on the calling thread's tile
// (Tile<TM, TN, GI>). X rows are read as float4 (two k) broadcasts to the
// threads of a row, Y rows as consecutive float2 across j (conflict-free).
template <int TM, int TN, int GI, int KD>
__device__ __forceinline__ void mm_slice(const float2* __restrict__ Xs,
                                         const float2* __restrict__ Ys,
                                         float2 (&acc)[TM * TN]) {
  using P = Tile<TM, TN, GI>;
  const int ti = P::i(), tj = P::j();
#pragma unroll 4
  for (int k = 0; k < KD; k += 2) {
    float4 a[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r)
      a[r] = *reinterpret_cast<const float4*>(Xs + (ti + GI * r) * KD + k);
    float2 b0[TN], b1[TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      b0[c] = Ys[k * P::PC + tj + P::GJ * c];
      b1[c] = Ys[(k + 1) * P::PC + tj + P::GJ * c];
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        float2& o = acc[r * TN + c];
        o.x = fmaf(a[r].x, b0[c].x, o.x);
        o.x = fmaf(-a[r].y, b0[c].y, o.x);
        o.x = fmaf(a[r].z, b1[c].x, o.x);
        o.x = fmaf(-a[r].w, b1[c].y, o.x);
        o.y = fmaf(a[r].x, b0[c].y, o.y);
        o.y = fmaf(a[r].y, b0[c].x, o.y);
        o.y = fmaf(a[r].z, b1[c].y, o.y);
        o.y = fmaf(a[r].w, b1[c].x, o.y);
      }
    }
  }
}

// Ring and panel geometry of a product at D = 64 T on the tile P.
template <int T, typename P>
struct Geometry {
  static constexpr int D = 64 * T;
  static constexpr int KS = 32;                 // k-slice depth
  static constexpr int KT = D / KS;             // slices a panel
  static constexpr int PR = P::PR, PC = P::PC;  // panel rows, columns
  static constexpr int RP = D / PR;             // row panels
  static constexpr int PANELS = RP * (D / PC);
  static constexpr int NS = 4;                  // ring stages
  static constexpr int XSL = PR * KS;           // X slice elements
  static constexpr int YSL = KS * PC;           // Y slice elements
  static constexpr int STAGE = XSL + YSL;
  static constexpr size_t SMEM = (size_t)NS * STAGE * sizeof(float2) +
                                 NT * sizeof(float);
  static_assert(D % PR == 0 && D % PC == 0, "panels must tile D");
  static_assert(NS * STAGE >= MAT, "the ring must hold a 64 x 64 tile");
};

// CL blocks share one workspace and split each operation (see the file
// note). The workspace holds the SLOTS ladder matrices, then any extra
// ones of the caller (extra(j)).
template <int T, bool DUAL, int CL, int TM = 8, int TN = 2, int GI = 8>
struct Tiled {
  using P = Tile<TM, TN, GI>;
  using G = Geometry<T, P>;
  static constexpr int D = G::D;
  static constexpr int N = D * D;
  static constexpr int SLOTS = DUAL ? 2 * NV : NV;
  static constexpr int BLOCKS = CL;       // blocks sharing a workspace
  static constexpr int STRIDE = CL * NT;  // threads of the sharing blocks
  static constexpr int EP = P::EP;

  float2* ws;  // the workspace of this cluster
  float2* sm;  // the ring (and a 64 x 64 staging tile outside products)
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
  // Every operation below leaves it to the caller.
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

  // L at element i; a term on slot zs reads z instead of the workspace.
  __device__ float2 value(const Lin& L, int i, int zs = NONE,
                          float2 z = {}) const {
    float2 r = make_float2(i / D == i % D ? L.id : 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE)
        r = caxpy(L.c[j], L.s[j] == zs ? z : ld(v(L.s[j]) + i), r);
    return r;
  }

  __device__ float2 tangent(const Lin& L, int i, int zs = NONE,
                            float2 dz = {}) const {
    float2 r = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE)
        r = caxpy(L.c[j], L.s[j] == zs ? dz : ld(t(L.s[j]) + i), r);
    return r;
  }

  // dst = src, a D x D matrix (an input, or workspace).
  __device__ void copy(float2* dst, const float2* src) const {
    for (int i = first(); i < N; i += STRIDE) dst[i] = ld(src + i);
  }

  // One k-slice of a product into ring stage st: the PR x 32 slice of x
  // at rows r0 and the 32 x PC slice of y (y^H with YADJ) at columns c0,
  // both at depth k0.
  template <bool YADJ>
  __device__ void issue(float2* st, const float2* x, const float2* y, int r0,
                        int c0, int k0) const {
    float2* xs = st;
    float2* ys = st + G::XSL;
    for (int c = threadIdx.x; c < G::PR * 16; c += NT) {
      const int r = c >> 4, q = 2 * (c & 15);
      cp_async16(xs + r * G::KS + q, x + (size_t)(r0 + r) * D + k0 + q);
    }
    if constexpr (YADJ) {
      // (y^H)[k0 + kk, c0 + j] = conj y[c0 + j, k0 + kk], through registers.
      for (int c = threadIdx.x; c < G::PC * 16; c += NT) {
        const int j = c >> 4, q = 2 * (c & 15);
        const float4 a = ld4(y + (size_t)(c0 + j) * D + k0 + q);
        ys[q * G::PC + j] = make_float2(a.x, -a.y);
        ys[(q + 1) * G::PC + j] = make_float2(a.z, -a.w);
      }
    } else {
      constexpr int H = G::PC / 2;  // 16-byte chunks a row
      for (int c = threadIdx.x; c < G::KS * H; c += NT) {
        const int r = c / H, q = 2 * (c % H);
        cp_async16(ys + r * G::PC + q, y + (size_t)(k0 + r) * D + c0 + q);
      }
    }
  }

  // Z = alpha x y + L (y^H with YADJ) and the epilogue e; with dz (DUAL
  // only) the dual product, dz = alpha (dx y + x dy) + tangent of L. z and
  // dz must differ from x, dx, y and dy; zs is z's slot (NONE if z is not
  // one), which e's posts may read. The CL blocks split the panels; a panel
  // takes KT slices (x, y), and in the dual form 2 KT more, (dx, y) then
  // (x, dy), its value's epilogue after the first KT and its tangent's
  // after the last.
  template <bool YADJ = false>
  __device__ void gemm_p(const float2* x, const float2* dx, const float2* y,
                         const float2* dy, float2* z, float2* dz, int zs,
                         const Epi& e) const {
    const bool dual = DUAL && dz != nullptr;
    const int spp = dual ? 3 * G::KT : G::KT;  // slices a panel
    const int mine = rank < G::PANELS ? (G::PANELS - 1 - rank) / CL + 1 : 0;
    const int n_it = mine * spp;
    auto start = [&](int it) {
      const int p = rank + (it / spp) * CL, s = it % spp;
      const int pass = s / G::KT;  // 0: (x, y), 1: (dx, y), 2: (x, dy)
      issue<YADJ>(sm + (it % G::NS) * G::STAGE, pass == 1 ? dx : x,
                  pass == 2 ? dy : y, (p % G::RP) * G::PR,
                  (p / G::RP) * G::PC, (s % G::KT) * G::KS);
    };
#pragma unroll
    for (int it = 0; it < G::NS - 1; ++it) {
      if (it < n_it) start(it);
      cp_async_commit();
    }
    float2 acc[EP];
#pragma unroll
    for (int j = 0; j < EP; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int it = 0; it < n_it; ++it) {
      cp_async_wait<G::NS - 2>();
      __syncthreads();
      // The stage of it - 1 is free: every thread has passed its FMAs.
      if (it + G::NS - 1 < n_it) start(it + G::NS - 1);
      cp_async_commit();
      const float2* st = sm + (it % G::NS) * G::STAGE;
      mm_slice<TM, TN, GI, G::KS>(st, st + G::XSL, acc);
      const int s = it % spp;
      if (s != G::KT - 1 && s != spp - 1) continue;
      // Epilogue of the panel's value (s = KT - 1) or tangent.
      const bool tan = s != G::KT - 1;
      const int p = rank + (it / spp) * CL;
      const int r0 = (p % G::RP) * G::PR, c0 = (p / G::RP) * G::PC;
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        const int gi = (r0 + P::row(j)) * D + c0 + P::col(j);
        float2 w = cscale(e.alpha, acc[j]);
        acc[j] = make_float2(0.f, 0.f);
        if (tan) {
          w = cadd(w, tangent(e.L, gi));
          dz[gi] = w;
          if (e.tout != nullptr) e.tout[gi] = w;
        } else {
          w = cadd(w, value(e.L, gi));
          if (e.add != nullptr) w = cadd(w, __ldg(e.add + gi));
          z[gi] = w;
          if (e.vout != nullptr) e.vout[gi] = w;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (e.post_dst[q] == NONE) continue;
          if (tan) t(e.post_dst[q])[gi] = tangent(e.post[q], gi, zs, w);
          else v(e.post_dst[q])[gi] = value(e.post[q], gi, zs, w);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next product
  }

  // slot dst = x y + e (dual: with tangents); dst must differ from x, y.
  __device__ void gemm(int x, int y, int dst, const Epi& e) const {
    gemm_p(v(x), DUAL ? t(x) : nullptr, v(y), DUAL ? t(y) : nullptr, v(dst),
           DUAL ? t(dst) : nullptr, dst, e);
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

  // M (and dM) = scale * a (and g).
  __device__ void load_scaled(const float2* __restrict__ a,
                              const float2* __restrict__ g,
                              float scale) const {
    for (int i = first(); i < N; i += STRIDE) {
      v(M)[i] = cscale(scale, __ldg(a + i));
      if (DUAL) t(M)[i] = cscale(scale, __ldg(g + i));
    }
  }

  // M = scale * a^H, 64 x 64 tile by tile through shared memory (coalesced
  // both ways). Outside products only: it stages in the ring.
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
      }
      __syncthreads();
    }
  }

  // The ladder on slot M (scaled and synced already); s squarings at level
  // 4. The last product also writes its value to vout and its tangent to
  // tout (where not null). Returns the slot that holds exp(M) (and, dual,
  // its Fréchet derivative); ends with sync(). Every elementwise pass of
  // the ladder is a post of the product before it.
  __device__ int ladder(int level, int s, float2* vout, float2* tout) const {
    const Lin none = lin(0.0f);
    if (level == 0) {
      // Degree 4: c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2).
      gemm(M, M, M2, epi_post(none, M3, lin(0.0f, kC[3], M, kC[4], M2)));
      sync();
      gemm(M2, M3, X, epi_out(lin(kC[0], kC[1], M, kC[2], M2), vout, tout));
      sync();
      return X;
    }
    if (level == 1) {
      // Degree 8 in 3 products (_D8X): A4 = A2 (x1 M + x2 A2);
      // T8 = y0 I + y1 M + y2 A2 + (x3 A2 + A4)(x4 I + x5 M + x6 A2 + x7 A4).
      gemm(M, M, M2, epi_post(none, M3, lin(0.0f, kD8[0], M, kD8[1], M2)));
      sync();
      gemm(M2, M3, M4,
           epi_post(none, X, lin(0.0f, kD8[2], M2, 1.0f, M4), Y,
                    lin(kD8[3], kD8[4], M, kD8[5], M2, kD8[6], M4)));
      sync();
      gemm(X, Y, M3,
           epi_out(lin(kD8[7], kD8[8], M, kD8[9], M2), vout, tout));
      sync();
      return M3;
    }
    gemm(M, M, M2, epi(none));
    sync();
    // M3 and M4 in one phase: both read M and M2 only, and the post reads
    // the M3 element this thread wrote.
    gemm(M2, M, M3, epi(none));
    if (level == 2) {
      // Degree 12, Paterson-Stockmeyer: M4 (chunk(4) + M4 (chunk(8) +
      // c12 M4)) + chunk(0).
      gemm(M2, M2, M4, epi_post(none, X, chunk(8, kC[12], M4)));
      sync();
      gemm(M4, X, Y, epi(chunk(4)));
      sync();
      gemm(M4, Y, X, epi_out(chunk(0), vout, tout));
      sync();
      return X;
    }
    // Degree 19, Paterson-Stockmeyer: p = chunk(16); p = p M4 + chunk(k).
    gemm(M2, M2, M4, epi_post(none, X, chunk(16)));
    sync();
    gemm(X, M4, Y, epi(chunk(12)));
    sync();
    gemm(Y, M4, X, epi(chunk(8)));
    sync();
    gemm(X, M4, Y, epi(chunk(4)));
    sync();
    gemm(Y, M4, X, s == 0 ? epi_out(chunk(0), vout, tout) : epi(chunk(0)));
    sync();
    int r = X;
    for (int j = 0; j < s; ++j) {
      const int o = r == X ? Y : X;
      gemm(r, r, o, j == s - 1 ? epi_out(none, vout, tout) : epi(none));
      sync();
      r = o;
    }
    return r;
  }
};

// K3/K4's tiled form: one matrix a block, its ladder in the block's own
// workspace; K4 on 8 x 4 register tiles of 128 x 64 panels where they tile
// D (not at D = 192). Both chosen by measuring (expm_fwd.cu).
template <int T, bool DUAL>
using ExpmTiled = Tiled<T, DUAL, 1, 8, DUAL && T != 3 ? 4 : 2,
                        DUAL && T != 3 ? 16 : 8>;

// Batch of matrices a (B, D, D) (and tangents g for the dual form) into out:
// exp(a), or the Fréchet derivative L(a, g), one matrix a group of
// K::BLOCKS blocks (ExpmTiled: one block; profiling/tiled_variants.cu runs
// the others). ws holds gridDim.x / K::BLOCKS workspaces of K::SLOTS
// matrices.
template <typename K>
__global__ void __launch_bounds__(NT, 1)
    expm_tiled_kernel(const float2* __restrict__ a,
                      const float2* __restrict__ g,
                      const float* __restrict__ norm,
                      float2* __restrict__ out, float2* ws, int B) {
  constexpr bool DUAL = K::SLOTS == 2 * NV;
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const int group = blockIdx.x / K::BLOCKS;
  const int groups = gridDim.x / K::BLOCKS;
  const K k{ws + (size_t)group * K::SLOTS * K::N, sm,
            reinterpret_cast<float*>(sm + (size_t)K::G::NS * K::G::STAGE),
            (int)(blockIdx.x % K::BLOCKS)};
  const int level = ladder_level(__ldg(norm));
  for (int m = group; m < B; m += groups) {
    const float2* am = a + (size_t)m * K::N;
    const int s = level == 4 ? k.squarings(am) : 0;
    k.load_scaled(am, DUAL ? g + (size_t)m * K::N : nullptr,
                  exp2f(-(float)s));
    k.sync();
    float2* dst = out + (size_t)m * K::N;
    k.ladder(level, s, DUAL ? nullptr : dst, DUAL ? dst : nullptr);
  }
}

template <int T, bool DUAL>
constexpr size_t expm_tiled_smem() {
  return ExpmTiled<T, DUAL>::G::SMEM;
}

// Sets the kernel's dynamic shared memory, then launches it on grid blocks
// of THREADS threads, in clusters of cl blocks where cl > 1.
template <int THREADS = NT, typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int grid, void* stream, int cl,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cl <= 1) {
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the kernel (of ``threads`` threads) resident on the current
// device at once (blocks per SM x SMs): the wrapper's grid, and the
// workspace it allocates.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int* blocks,
                    int threads = NT) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Clusters of cl blocks of the kernel (a launch attribute, as launch()
// gives it) that the current device keeps resident at once.
template <typename Kernel>
int resident_clusters(Kernel kernel, size_t smem, int cl, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  return *clusters > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace ex
}  // namespace qoc
