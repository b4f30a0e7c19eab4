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
// The bf16_3x mode (TC = true, ops/chain.py): the second instantiation of
// Tiled runs every product of the ladder, the chain step and the adjoint's
// T update as 3 x TF32 mma.sync.m16n8k8 on operands split by cvt.rna
// (chain_common.cuh split_tf32, mma_tf32), each k8 partial joined to its
// accumulator by a rounding FP32 add, as the resident kernels' mode does.
// Its threads own the mma accumulator fragments of the panel transposed
// (TcTile: Z^T = Y^T X^T, m along the panel's columns, n along its rows), so
// any PR that is a multiple of 8 tiles, K6's row bands of 8 T rows too; the
// ring's slices are swizzled by 16-byte chunks so that the fragment reads
// are conflict-free (xoff, yoff). The tensor cores' sums round toward zero,
// so where one term dominates it stays out of them: the ladder's slot holds
// exp(M) - I (its last epilogue drops the identity, and the squarings run
// on D = X - I, D' = 2 D + D D), a copy out adds I back (Epi::vid), a chain
// step is P + (U - I) P and the adjoint's T + (U^H - I) T. Degree 12 is
// _D12A (4 products) with its constants taken out, so exp(0) - I is 0
// exactly and a padded step leaves P unchanged.
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
// adds add[i] (an input, or a matrix other blocks wrote), copies z (and,
// dual, dz) to vout (tout), vid I added to the copy of z, and sets slot
// post_dst[j] = post[j], where a term on the product's own slot reads the
// new z.
struct Epi {
  Lin L;
  float alpha;
  const float2* add;
  float2* vout;
  float2* tout;
  float vid;
  int post_dst[2];
  Lin post[2];
};

__device__ __forceinline__ Epi epi(const Lin& L) {
  return Epi{L, 1.0f, nullptr, nullptr, nullptr, 0.0f, {NONE, NONE}, {L, L}};
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
  static __device__ __forceinline__ bool has(int) { return true; }
};

// The bf16_3x mode's register tile of a PR x PC panel: the accumulator
// fragments of mma.m16n8k8 on the panel transposed, Z^T = Y^T X^T (m along
// the panel's MT = PC / 16 column tiles, n along its NN = PR / 8 row tiles).
// Warp w takes m-tile w % MT and n-tiles w / MT + WS j (WS = warps an
// m-tile); where WS does not divide NN the last n-tile of some warps is
// missing (has). Lane (g, t) = (lane / 4, lane % 4) holds fragment element
// q of each of its tiles: m = g + 8 (q / 2), n = 2 t + q % 2.
template <int PR_, int PC_>
struct TcTile {
  static constexpr int PR = PR_, PC = PC_;
  static constexpr int W = NT / 32;
  static constexpr int MT = PC / 16;
  static constexpr int WS = W / MT;
  static constexpr int NN = PR / 8;
  static constexpr int NJ = (NN + WS - 1) / WS;  // n-tiles a warp, at most
  static constexpr int EP = 4 * NJ;
  static_assert(W % MT == 0 && PR % 8 == 0, "TcTile: bad panel");
  static __device__ __forceinline__ int mi() { return (threadIdx.x >> 5) % MT; }
  static __device__ __forceinline__ int ni(int j) {
    return (threadIdx.x >> 5) / MT + WS * j;
  }
  static __device__ __forceinline__ int row(int e) {
    return 8 * ni(e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
  }
  static __device__ __forceinline__ int col(int e) {
    return 16 * mi() + ((threadIdx.x & 31) >> 2) + 8 * ((e >> 1) & 1);
  }
  static __device__ __forceinline__ bool has(int e) {
    return ni(e >> 2) < NN;
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

// Shared-memory index of element (r, k) of a PR x KS X slice and of
// element (k, c) of a KS x PC Y slice in the ring: row-major, and in the
// bf16_3x mode (SW) with each 16-byte chunk (two complex elements) XORed
// within its aligned group of 8: chunk k / 2 of X row r by 4 (r & 1), chunk
// c / 2 of Y row k by k & 6. Then mm_slice_tc's reads of a fragment (X: 8
// lanes, rows g and g + 1, chunks t; Y: 16 lanes, rows 2 t, chunks g / 2)
// fall on 32 distinct banks.
template <bool SW, int KS>
__device__ __forceinline__ int xoff(int r, int k) {
  if constexpr (!SW) return r * KS + k;
  return r * KS + ((((k >> 1) ^ ((r & 1) << 2)) << 1) | (k & 1));
}

template <bool SW, int PC>
__device__ __forceinline__ int yoff(int k, int c) {
  if constexpr (!SW) return k * PC + c;
  return k * PC + ((((c >> 1) ^ (k & 6)) << 1) | (c & 1));
}

// acc += X Y for a PR x KS slice X and a KS x PC slice Y in the ring's
// bf16_3x layout (xoff, yoff), on the calling warp's TcTile fragments: 3 x
// TF32 mma.sync a real product (chain_common.cuh mm_acc_tc's arithmetic,
// there on X Y, here on Y^T X^T). A k8 step takes k0 + 2 t as the mma's
// k = t and k0 + 2 t + 1 as k = t + 4, so one float4 read gives a lane both
// of its X elements (B fragment); the A fragment is Y's, one a warp and k8
// step, reused over the warp's n-tiles. Zr = Yr Xr - Yi Xi, Zi = Yr Xi +
// Yi Xr: 12 mma a tile and k8 step, summed into fresh registers (the small
// passes first) and joined to acc by an FP32 add that rounds to nearest.
// The n-tiles go in groups of up to 4 whose mma interleave (each tile's
// 12 form two dependent chains, and a warp has 7 peers an SM to hide their
// latency; groups of 2 measured 2-4% slower, PERF.md). A warp's missing
// tile (has) is computed like the others, on rows past the panel that stay
// inside the ring's stage, and never stored: its warp would wait at the
// next barrier anyway.
template <class P, int KS>
__device__ __forceinline__ void mm_slice_tc(const float2* __restrict__ Xs,
                                            const float2* __restrict__ Ys,
                                            float2 (&acc)[P::EP]) {
  constexpr int GJ = P::NJ < 4 ? P::NJ : 4;  // n-tiles interleaved
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * P::mi();
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += 8) {
    // A = Y^T: a[2 h + u] = Y[k0 + 2 t + h][m0 + g + 8 u], split; the
    // imaginary part negated for Zr.
    uint32_t arh[4], arl[4], aih[4], ail[4], anh[4], anl[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 y = Ys[yoff<true, P::PC>(k0 + 2 * t + h, m0 + g + 8 * u)];
        split_tf32(y.x, arh[2 * h + u], arl[2 * h + u]);
        split_tf32(y.y, aih[2 * h + u], ail[2 * h + u]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      anh[q] = aih[q] ^ 0x80000000u;
      anl[q] = ail[q] ^ 0x80000000u;
    }
#pragma unroll
    for (int j0 = 0; j0 < P::NJ; j0 += GJ) {
      // The group's tiles u < GJ with j0 + u < NJ (known once unrolled).
      // B = X^T: (b0, b1) = X[8 ni + g][k0 + 2 t], X[8 ni + g][k0 + 2 t + 1].
      uint32_t brh[GJ][2], brl[GJ][2], bih[GJ][2], bil[GJ][2];
#pragma unroll
      for (int u = 0; u < GJ; ++u) {
        if (j0 + u >= P::NJ) continue;
        const float4 x = *reinterpret_cast<const float4*>(
            Xs + xoff<true, KS>(8 * P::ni(j0 + u) + g, k0 + 2 * t));
        split_tf32(x.x, brh[u][0], brl[u][0]);
        split_tf32(x.y, bih[u][0], bil[u][0]);
        split_tf32(x.z, brh[u][1], brl[u][1]);
        split_tf32(x.w, bih[u][1], bil[u][1]);
      }
      float re[GJ][4], im[GJ][4];
#pragma unroll
      for (int u = 0; u < GJ; ++u) {
        if (j0 + u >= P::NJ) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) re[u][q] = im[u][q] = 0.0f;
      }
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ) mma_small(re[u], arh, arl, brh[u], brl[u]);
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ) mma_small(im[u], arh, arl, bih[u], bil[u]);
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ) mma_small(re[u], anh, anl, bih[u], bil[u]);
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ) mma_small(im[u], aih, ail, brh[u], brl[u]);
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ)
          mma_tf32(re[u][0], re[u][1], re[u][2], re[u][3], arh, brh[u][0],
                   brh[u][1]);
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ)
          mma_tf32(im[u][0], im[u][1], im[u][2], im[u][3], arh, bih[u][0],
                   bih[u][1]);
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ)
          mma_tf32(re[u][0], re[u][1], re[u][2], re[u][3], anh, bih[u][0],
                   bih[u][1]);
#pragma unroll
      for (int u = 0; u < GJ; ++u)
        if (j0 + u < P::NJ)
          mma_tf32(im[u][0], im[u][1], im[u][2], im[u][3], aih, brh[u][0],
                   brh[u][1]);
#pragma unroll
      for (int u = 0; u < GJ; ++u) {
        if (j0 + u >= P::NJ) continue;
        float2* c = acc + 4 * (j0 + u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c[q].x = __fadd_rn(c[q].x, re[u][q]);
          c[q].y = __fadd_rn(c[q].y, im[u][q]);
        }
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
// ones of the caller (extra(j), slot SLOTS + j of value()). TC: the
// bf16_3x mode's instantiation, on the same GI TM x (NT / GI) TN panels.
template <int T, bool DUAL, int CL, int TM = 8, int TN = 2, int GI = 8,
          bool TC = false>
struct Tiled {
  using P = std::conditional_t<TC, TcTile<GI * TM, NT / GI * TN>,
                               Tile<TM, TN, GI>>;
  using G = Geometry<T, P>;
  static constexpr int D = G::D;
  static constexpr int N = D * D;
  static constexpr int SLOTS = DUAL ? 2 * NV : NV;
  static constexpr int BLOCKS = CL;       // blocks sharing a workspace
  static constexpr int STRIDE = CL * NT;  // threads of the sharing blocks
  static constexpr int EP = P::EP;

  // The identity the ladder's slot lacks: exp(M) - I in the mode.
  static constexpr float ONE = TC ? 1.0f : 0.0f;

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
      cp_async16(xs + xoff<TC, G::KS>(r, q),
                 x + (size_t)(r0 + r) * D + k0 + q);
    }
    if constexpr (YADJ) {
      // (y^H)[k0 + kk, c0 + j] = conj y[c0 + j, k0 + kk], through registers.
      for (int c = threadIdx.x; c < G::PC * 16; c += NT) {
        const int j = c >> 4, q = 2 * (c & 15);
        const float4 a = ld4(y + (size_t)(c0 + j) * D + k0 + q);
        ys[yoff<TC, G::PC>(q, j)] = make_float2(a.x, -a.y);
        ys[yoff<TC, G::PC>(q + 1, j)] = make_float2(a.z, -a.w);
      }
    } else {
      constexpr int H = G::PC / 2;  // 16-byte chunks a row
      for (int c = threadIdx.x; c < G::KS * H; c += NT) {
        const int r = c / H, q = 2 * (c % H);
        cp_async16(ys + yoff<TC, G::PC>(r, q),
                   y + (size_t)(k0 + r) * D + c0 + q);
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
      if constexpr (TC) mm_slice_tc<P, G::KS>(st, st + G::XSL, acc);
      else mm_slice<TM, TN, GI, G::KS>(st, st + G::XSL, acc);
      const int s = it % spp;
      if (s != G::KT - 1 && s != spp - 1) continue;
      // Epilogue of the panel's value (s = KT - 1) or tangent.
      const bool tan = s != G::KT - 1;
      const int p = rank + (it / spp) * CL;
      const int r0 = (p % G::RP) * G::PR, c0 = (p / G::RP) * G::PC;
#pragma unroll
      for (int j = 0; j < EP; ++j) {
        if (!P::has(j)) continue;
        const int gi = (r0 + P::row(j)) * D + c0 + P::col(j);
        float2 w = cscale(e.alpha, acc[j]);
        acc[j] = make_float2(0.f, 0.f);
        if (tan) {
          w = cadd(w, tangent(e.L, gi));
          dz[gi] = w;
          if (e.tout != nullptr) e.tout[gi] = w;
        } else {
          w = cadd(w, value(e.L, gi));
          if (e.add != nullptr) w = cadd(w, ld(e.add + gi));
          z[gi] = w;
          if (e.vout != nullptr) {
            float2 o = w;
            if (TC && gi / D == gi % D) o.x += e.vid;
            e.vout[gi] = o;
          }
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

  // L without the identity that the mode's slot lacks.
  __device__ static Lin drop(Lin L) {
    L.id -= ONE;
    return L;
  }

  // The epilogue of the ladder's last product: L and the copies out to
  // vout and tout (where not null), vout with the mode's identity back.
  __device__ static Epi last(const Lin& L, float2* vout, float2* tout) {
    Epi e = epi_out(L, vout, tout);
    e.vid = ONE;
    return e;
  }

  // The ladder on slot M (scaled and synced already); s squarings at level
  // 4. The last product also writes its value to vout and its tangent to
  // tout (where not null). Returns the slot that holds exp(M), exp(M) - I
  // in the mode (and, dual, its Fréchet derivative); ends with sync().
  // Every elementwise pass of the ladder is a post of the product before
  // it.
  __device__ int ladder(int level, int s, float2* vout, float2* tout) const {
    const Lin none = lin(0.0f);
    if (level == 0) {
      // Degree 4: c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2).
      gemm(M, M, M2, epi_post(none, M3, lin(0.0f, kC[3], M, kC[4], M2)));
      sync();
      gemm(M2, M3, X,
           last(drop(lin(kC[0], kC[1], M, kC[2], M2)), vout, tout));
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
           last(drop(lin(kD8[7], kD8[8], M, kD8[9], M2)), vout, tout));
      sync();
      return M3;
    }
    gemm(M, M, M2, epi(none));
    sync();
    if (TC && level == 2) {
      // Degree 12 in 4 products (_D12A, chain_common.cuh kD12), its
      // identity dropped: M3 = M2 M, its post X = lin'(3); A6' = lin'(2) +
      // X X into Y, its posts Y' = lin'(1) + A6' into M4 and (c0 - 1) I +
      // lin'(0) = lin'(0) into M3 (which the first post reads before); then
      // Y' A6' + M3 + a20 Y' + y0 A6'.
      gemm(M2, M, M3, epi_post(none, X, lin(0.0f, kD12[13], M, kD12[14], M2,
                                            kD12[15], M3)));
      sync();
      gemm(X, X, Y,
           epi_post(lin(0.0f, kD12[9], M, kD12[10], M2, kD12[11], M3), M4,
                    lin(0.0f, kD12[5], M, kD12[6], M2, kD12[7], M3, 1.0f, Y),
                    M3, lin(kD12C[0] - 1.0f, kD12[1], M, kD12[2], M2,
                            kD12[3], M3)));
      sync();
      gemm(M4, Y, X,
           last(lin(0.0f, 1.0f, M3, kD12[8], M4, kD12C[1], Y), vout, tout));
      sync();
      return X;
    }
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
      gemm(M4, Y, X, last(chunk(0), vout, tout));
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
    gemm(Y, M4, X, s == 0 ? last(drop(chunk(0)), vout, tout)
                          : epi(drop(chunk(0))));
    sync();
    // The squarings: X X, or in the mode D' = 2 D + D D on D = X - I.
    const Lin sq = lin(0.0f, 2.0f * ONE, X);
    int r = X;
    for (int j = 0; j < s; ++j) {
      const int o = r == X ? Y : X;
      Lin L = sq;
      L.s[0] = TC ? r : NONE;
      gemm(r, r, o, j == s - 1 ? last(L, vout, tout) : epi(L));
      sync();
      r = o;
    }
    return r;
  }
};

// K3/K4's tiled form: one matrix a block, its ladder in the block's own
// workspace; K4 on 8 x 4 register tiles of 128 x 64 panels where they tile
// D (not at D = 192). Both chosen by measuring (expm_fwd.cu). TC: the
// bf16_3x mode's instantiation on the same panels.
template <int T, bool DUAL, bool TC = false>
using ExpmTiled = Tiled<T, DUAL, 1, 8, DUAL && T != 3 ? 4 : 2,
                        DUAL && T != 3 ? 16 : 8, TC>;

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

template <int T, bool DUAL, bool TC = false>
constexpr size_t expm_tiled_smem() {
  return ExpmTiled<T, DUAL, TC>::G::SMEM;
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
