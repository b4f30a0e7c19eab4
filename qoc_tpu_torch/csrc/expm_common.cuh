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
// The bf16_3x mode (TC != 0, ops/chain.py): a second form of Tiled runs
// every product of the ladder, the chain step and the adjoint's T update
// as 3 x TF32. Form 1 (Product<1> below) uses Hopper's warpgroup
// tensor-core instruction. Each raw k-slice is loaded by all the block's threads into
// registers and split once into TF32 hi/lo planes (re hi, re lo, im hi,
// im lo of each operand; hi = tf32(x), lo = tf32(x - hi), rounded to
// nearest on the bits as ops/chain.py _tf32) in the canonical K-major
// layout with the 128-byte swizzle (a 32-deep row of TF32 is one swizzle
// row), one of two split stages in shared memory; the two warpgroups
// read them through descriptors (wgmma.mma_async m64nNk8, both operands in
// shared memory). The panel is computed transposed, Z^T = Y^T X^T: M = 64
// runs along its PC = 64 columns and N = PR along its rows, so K6's row
// bands of 8 T rows are a legal N. Warpgroup 0 accumulates the real part
// Yr Xr - Yi Xi, warpgroup 1 the imaginary part Yr Xi + Yi Xr, with the
// same instructions (partials p1 = Yr Xb and p2 = Yi Xc from B planes
// chosen by address, joined as p1 -+ p2), each real product x_hi y_hi +
// x_hi y_lo + x_lo y_hi (6 wgmma a k8 step, the small passes first), into
// fresh registers per k-slice that join the accumulator by an FP32 add
// that rounds to nearest; the next slice's split and loads and the last
// panel's epilogue run while the tensor cores work. Each warpgroup runs
// the epilogue of its own component (the ladder's combinations are
// real-linear). ptxas serialises wgmma that a function call separates, so
// the mode's kernels are inlined whole, and each runs all its products
// through one call site in a loop over ops (Tiled::run, ladder_pick). The tensor cores' sums round
// toward zero, so where one term dominates it stays out of them: the
// ladder's slot holds exp(M) - I (its last epilogue drops the identity, and
// the squarings run on D = X - I, D' = 2 D + D D), a copy out adds I back
// (Epi::vid), a chain step is P + (U - I) P and the adjoint's T + (U^H - I)
// T. Degree 12 is
// _D12A (4 products) with its constants taken out, so exp(0) - I is 0
// exactly and a padded step leaves P unchanged. K6 runs this form; K3/K4
// run PR 11's (Product<2>: 3 x TF32 mma.sync on fragments split at every
// read), which measured faster at their panels
// (profiling/tiled_variants.py times both).
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

// ---------------------------------------------------------------------------
// The bf16_3x mode's product on wgmma (Product<1>; see the file note).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, k), k < 32, of a TF32 plane in GMMA's K-major
// layout with the 128-byte swizzle: row r at 128 r, its 16-byte chunk k / 4
// XORed with r % 8 (atoms of 8 rows, 1 KB apart, 1 KB-aligned).
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return r * 128 + ((((k >> 2) ^ (r & 7)) << 4) | ((k & 3) << 2));
}

// The shared-memory descriptor of such a plane from shared address a (a
// row's k8 step s at a + 32 s): start address a / 16, leading byte offset
// 1 (unused with the swizzle), stride byte offset 1024 B / 16 (from one
// 8-row atom to the next), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Generic-proxy writes to shared memory (the split pass) made visible to
// the async proxy (wgmma), before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N of the warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of d across a wgmma fence or wait
// (the instruction writes d asynchronously).
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= SA * A B on one m64nNk8 TF32 tile of the warpgroup, A (64 x 8) and
// B (N x 8, K-major) from shared memory by descriptors a and b; acc = 0
// overwrites d. Thread (warp w of the group, lane 4 g + q) holds d[4 j + 2 h
// + v] = D[16 w + g + 8 h][8 j + 2 q + v].
template <int N, int SA>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int acc) {
  static_assert(SA == 1 || SA == -1, "wgmma_tf32: scale is +1 or -1");
  if constexpr (N == 40) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, %20, %21, p, %23, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, %27, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  } else if constexpr (N == 56) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27"
        "}, %28, %29, p, %31, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  } else {
    static_assert(N == 64, "wgmma_tf32: N is 40, 48, 56 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, %35, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(SA));
  }
}

// The mode's tile of a PR x PC panel on wgmma: each warpgroup holds one
// component of the whole panel in PR / 2 accumulator registers a thread,
// wgmma_tf32's map on Z^T: element j is panel row 8 (j / 4) + 2 q + j % 2,
// column 16 w + g + 8 ((j / 2) % 2).
template <int PR_, int PC_>
struct WgTile {
  static constexpr int PR = PR_, PC = PC_;
  static constexpr int NA = PR / 2;  // accumulator registers a thread
  static constexpr int EP = NA;
  static_assert(NT == 256 && PC == 64 && PR % 8 == 0 && PR <= 64,
                "WgTile: two warpgroups, M = 64 columns, N = PR rows");
  static __device__ __forceinline__ int row(int j) {
    return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
  }
  static __device__ __forceinline__ int col(int j) {
    return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
           8 * ((j >> 1) & 1);
  }
};

// The bf16_3x mode's products, by form: 1 is the package's (wgmma), other
// forms are specialised by the profiling variants.
template <int F>
struct Product;

template <>
struct Product<1> {
  template <int PR, int PC>
  using Tile = WgTile<PR, PC>;
  static constexpr int NS = 0;      // no raw ring: loads go to registers
  static constexpr int STAGES = 2;  // split stages
  // One split stage: the A planes (Y^T: re hi, re lo, im hi, im lo, PC rows
  // of 128 B each), then the B planes (X, PR rows each).
  template <class P>
  __host__ __device__ static constexpr int split_bytes() {
    return 4 * (P::PC + P::PR) * 128;
  }
  // A warpgroup's staging of its component of a panel for the epilogue:
  // PR rows of SROW floats (padded: the accumulator map's stores fall on
  // 32 banks).
  static constexpr int SROW = 64 + 4;
  template <class P>
  __host__ __device__ static constexpr int staging_bytes() {
    return P::PR * SROW * 4;
  }
  // Shared memory of the product: the split stages (1 KB-aligned, with the
  // slack that aligns them), the two warpgroups' staging, and the
  // product's operands (Tiled::Op) at the end.
  static constexpr size_t OP_BYTES = 512;
  template <class P>
  __host__ __device__ static constexpr size_t extra() {
    return 1024 + STAGES * (size_t)split_bytes<P>() +
           2 * (size_t)staging_bytes<P>() + OP_BYTES;
  }

  // x = hi + lo in TF32 (hi = tf32(x), lo = tf32(x - hi)), rounded to
  // nearest with ties away from zero on the bits, as ops/chain.py _tf32:
  // integer operations, where cvt.rna.tf32.f32 would run at the
  // conversion units' lower rate.
  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
  }

  // Elements (r, k), (r, k + 1) of rows of 32 (i = 16 r + k / 2) into the
  // planes at p (re hi, re lo, im hi, im lo, ROWS x 128 B each), the
  // imaginary part negated with CONJ: 8-byte writes, a warp's 16 of a row
  // on 32 banks.
  template <int ROWS, bool CONJ>
  static __device__ __forceinline__ void put_row(float4 v, int i, char* p) {
    const int r = i >> 4, k = 2 * (i & 15);
    uint2 h[2], l[2];  // re, im
    split(v.x, h[0].x, l[0].x);
    split(v.z, h[0].y, l[0].y);
    split(CONJ ? -v.y : v.y, h[1].x, l[1].x);
    split(CONJ ? -v.w : v.w, h[1].y, l[1].y);
    char* a = p + swz(r, k);
    *reinterpret_cast<uint2*>(a) = h[0];
    *reinterpret_cast<uint2*>(a + ROWS * 128) = l[0];
    *reinterpret_cast<uint2*>(a + 2 * ROWS * 128) = h[1];
    *reinterpret_cast<uint2*>(a + 3 * ROWS * 128) = l[1];
  }

  // Elements (4 q + u, c), u < 4, of a 32 x PC slice (i = PC q + c) into
  // the planes of its column c: 16-byte writes, 8 lanes on 32 banks.
  template <int PC>
  static __device__ __forceinline__ void put_col(const float2 (&v)[4], int i,
                                                 char* p) {
    const int c = i % PC, q = i / PC;
    uint4 rh, rl, ih, il;
    split(v[0].x, rh.x, rl.x);
    split(v[1].x, rh.y, rl.y);
    split(v[2].x, rh.z, rl.z);
    split(v[3].x, rh.w, rl.w);
    split(v[0].y, ih.x, il.x);
    split(v[1].y, ih.y, il.y);
    split(v[2].y, ih.z, il.z);
    split(v[3].y, ih.w, il.w);
    char* a = p + c * 128 + ((q ^ (c & 7)) << 4);
    *reinterpret_cast<uint4*>(a) = rh;
    *reinterpret_cast<uint4*>(a + PC * 128) = rl;
    *reinterpret_cast<uint4*>(a + 2 * PC * 128) = ih;
    *reinterpret_cast<uint4*>(a + 3 * PC * 128) = il;
  }

  // A thread's share of one raw k-slice, in registers from its load to its
  // split: X's PR x 32 slice as pairs of a row (float4), and Y's 32 x PC
  // slice as 4 k of a column (2 float4 an item), or with yadj y's PC x 32
  // block as pairs of a row (conjugated by the split). Each warp-wide load
  // reads 256 contiguous bytes.
  template <int PR, int PC>
  struct Raw {
    static constexpr int JX = (PR * 16 + NT - 1) / NT;
    static constexpr int JY = PC * 16 / NT;  // float4 of Y a thread
    static_assert(PC * 8 / NT * 2 == JY, "Raw: Y items");
    float4 x[JX];
    float4 y[JY];

    template <class K>
    __device__ __forceinline__ void load(const float2* xp, const float2* yp,
                                         int r0, int c0, int k0,
                                         bool yadj) {
#pragma unroll
      for (int j = 0; j < JX; ++j) {
        const int i = threadIdx.x + NT * j;
        if (i < PR * 16)
          x[j] = K::ld4(xp + (size_t)(r0 + (i >> 4)) * K::D + k0 +
                        2 * (i & 15));
      }
      if (yadj) {
#pragma unroll
        for (int j = 0; j < JY; ++j) {
          const int i = threadIdx.x + NT * j;
          y[j] = K::ld4(yp + (size_t)(c0 + (i >> 4)) * K::D + k0 +
                        2 * (i & 15));
        }
      } else {
#pragma unroll
        for (int j = 0; j < JY / 2; ++j) {
          const int i = threadIdx.x + NT * j;
          const float2* q = yp + (size_t)(k0 + 4 * (i / PC)) * K::D + c0 +
                            i % PC;
          const float2 v0 = K::ld(q), v1 = K::ld(q + K::D);
          const float2 v2 = K::ld(q + 2 * K::D), v3 = K::ld(q + 3 * K::D);
          y[2 * j] = make_float4(v0.x, v0.y, v1.x, v1.y);
          y[2 * j + 1] = make_float4(v2.x, v2.y, v3.x, v3.y);
        }
      }
    }

    // Into the split stage at s: the A planes from Y^T, then the B planes.
    __device__ __forceinline__ void put(char* s, bool yadj) const {
      if (yadj) {
#pragma unroll
        for (int j = 0; j < JY; ++j)
          put_row<PC, true>(y[j], threadIdx.x + NT * j, s);
      } else {
#pragma unroll
        for (int j = 0; j < JY / 2; ++j) {
          const float2 v[4] = {make_float2(y[2 * j].x, y[2 * j].y),
                               make_float2(y[2 * j].z, y[2 * j].w),
                               make_float2(y[2 * j + 1].x, y[2 * j + 1].y),
                               make_float2(y[2 * j + 1].z, y[2 * j + 1].w)};
          put_col<PC>(v, threadIdx.x + NT * j, s);
        }
      }
#pragma unroll
      for (int j = 0; j < JX; ++j) {
        const int i = threadIdx.x + NT * j;
        if (i < PR * 16) put_row<PR, false>(x[j], i, s + 4 * PC * 128);
      }
    }
  };

  // The k-slice's two real products of this warpgroup from the split stage
  // at s (A = Y^T planes at s, B planes at xb and xc, hi then lo): p1 = Yr
  // xb, p2 = Yi xc, each x_hi y_hi + x_hi y_lo + x_lo y_hi with the small
  // passes first, overwriting p1 and p2. The real part is p1 - p2 with
  // (xb, xc) = (Xr, Xi), the imaginary part p1 + p2 with (Xi, Xr): both
  // warpgroups run the same instructions (a branch between the two would
  // make ptxas serialise the wgmma).
  template <int PR, int PC>
  static __device__ __forceinline__ void slice(float (&p1)[PR / 2],
                                               float (&p2)[PR / 2],
                                               uint32_t s, uint32_t xb,
                                               uint32_t xc) {
    constexpr uint32_t AP = PC * 128, BP = PR * 128;  // plane bytes
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t o = 32 * k;
      wgmma_tf32<PR, 1>(p1, gmma_desc(s + o), gmma_desc(xb + BP + o), k > 0);
      wgmma_tf32<PR, 1>(p2, gmma_desc(s + 2 * AP + o),
                        gmma_desc(xc + BP + o), k > 0);
      wgmma_tf32<PR, 1>(p1, gmma_desc(s + AP + o), gmma_desc(xb + o), 1);
      wgmma_tf32<PR, 1>(p2, gmma_desc(s + 3 * AP + o), gmma_desc(xc + o), 1);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t o = 32 * k;
      wgmma_tf32<PR, 1>(p1, gmma_desc(s + o), gmma_desc(xb + o), 1);
      wgmma_tf32<PR, 1>(p2, gmma_desc(s + 2 * AP + o), gmma_desc(xc + o), 1);
    }
  }

  // Slice it of a product into raw: the operands of its pass (0: (x, y),
  // 1: (dx, y), 2: (x, dy); spp slices a panel), its panel's rows and
  // columns, its depth.
  template <class K, class R>
  static __device__ __forceinline__ void load_slice(
      const K& k, R& raw, int it, int spp, const float2* x, const float2* dx,
      const float2* y, const float2* dy, bool yadj) {
    using G = typename K::G;
    const int p = k.rank + (it / spp) * K::BLOCKS, s = it % spp;
    const int pass = s / G::KT;
    raw.template load<K>(pass == 1 ? dx : x, pass == 2 ? dy : y,
                         (p % G::RP) * G::PR, (p / G::RP) * G::PC,
                         (s % G::KT) * G::KS, yadj);
  }

  // The epilogue of the panel whose last slice was it (its value's after
  // KT slices, its tangent's after spp), on this warpgroup's component:
  // acc staged in the warpgroup's rows at stg (then zeroed for the next
  // panel), and Tiled::finish_c run on a loop over the panel's elements,
  // consecutive threads on consecutive columns. The loop stays rolled: the
  // epilogue unrolled over a thread's accumulators would not fit the
  // instruction cache beside the product.
  template <class K, int NA>
  static __device__ __forceinline__ void epilogue(const K& k, float (&acc)[NA],
                                                  float* stg, int it, int spp,
                                                  const typename K::Op& o) {
    using G = typename K::G;
    using P = typename K::P;
    const int p = k.rank + (it / spp) * K::BLOCKS;
    const int r0 = (p % G::RP) * G::PR, c0 = (p / G::RP) * G::PC;
    const bool tan = it % spp != G::KT - 1;
    const int comp = threadIdx.x >> 7;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      stg[P::row(j) * SROW + P::col(j)] = acc[j];
      acc[j] = 0.0f;
    }
    // The warpgroup's own barrier (named barrier 1 + comp, 128 threads).
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + comp) : "memory");
#pragma unroll 1
    for (int i = threadIdx.x & 127; i < G::PR * G::PC; i += 128) {
      const int n = i / G::PC, m = i % G::PC;
      k.finish_c((r0 + n) * K::D + c0 + m, comp, stg[n * SROW + m], tan, o.e,
                 o.z, o.dz, o.zs);
    }
  }

  // Tiled::gemm_p in the mode (its contract), on the tiled K. Iteration it:
  // the wgmma of slice it issued (async) on split stage it % 2; while they
  // run, the epilogue of a panel that ended at it - 1, slice it + 1 split
  // from registers into the other stage (whose wgmma, of it - 1, both
  // warpgroups awaited before the last barrier) and slice it + 2 loaded
  // into registers; then the wgmma awaited and their partials joined to the
  // accumulator by rounding adds (reading a partial while any wgmma runs
  // would make ptxas serialise them); one barrier. Each warpgroup runs its
  // component's epilogue on its own accumulator (Tiled::finish_c). o, the
  // product's operands and epilogue, is read from shared memory where it
  // is used, so that it holds no registers. Everything here is inlined,
  // and the kernels that run it call no function that issues wgmma: ptxas
  // serialises those that a call separates.
  template <class K>
  static __device__ __forceinline__ void gemm(const K& k,
                                              const typename K::Op& o) {
    using G = typename K::G;
    using P = typename K::P;
    constexpr int PR = P::PR, PC = P::PC, NA = P::NA;
    constexpr uint32_t SB = split_bytes<P>();
    static_assert(G::KS == 32, "Product<1>: KS 32");
    const bool dual = K::DUAL_FORM && o.dz != nullptr;
    const int spp = dual ? 3 * G::KT : G::KT;  // slices a panel
    const int mine = k.rank < G::PANELS
                         ? (G::PANELS - 1 - k.rank) / K::BLOCKS + 1
                         : 0;
    const int n_it = mine * spp;
    Raw<PR, PC> raw;
    const uint32_t sm0 = smem_u32(k.sm);
    const uint32_t base = (sm0 + 1023u) & ~1023u;  // split stage 0
    char* const gbase = reinterpret_cast<char*>(k.sm) + (base - sm0);
    float* const stg = reinterpret_cast<float*>(
        gbase + STAGES * SB + (threadIdx.x >> 7) * staging_bytes<P>());
    // The operands in registers; the epilogue reads o in shared memory.
    const float2 *x = o.x, *dx = o.dx, *y = o.y, *dy = o.dy;
    const bool yadj = o.yadj;
    // Warpgroup 0 the real part (p1 - p2), 1 the imaginary (p1 + p2).
    const int comp = threadIdx.x >> 7;
    const float sgn = comp ? 1.0f : -1.0f;
    const uint32_t xoff = 4 * PC * 128 + comp * 2 * PR * 128;
    const uint32_t xalt = 4 * PC * 128 + (1 - comp) * 2 * PR * 128;
    float acc[NA], p1[NA], p2[NA];
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] = p1[j] = p2[j] = 0.0f;
    if (n_it > 0) {
      load_slice(k, raw, 0, spp, x, dx, y, dy, yadj);
      raw.put(gbase, yadj);
      if (n_it > 1) load_slice(k, raw, 1, spp, x, dx, y, dy, yadj);
    }
    fence_proxy_async();
    __syncthreads();
    int ended = -1;  // the last slice of a panel whose epilogue is due
    for (int it = 0; it < n_it; ++it) {
      const uint32_t s = base + (uint32_t)(it & 1) * SB;
      reg_fence(p1);
      reg_fence(p2);
      wgmma_fence();
      slice<PR, PC>(p1, p2, s, s + xoff, s + xalt);
      wgmma_commit();
      if (ended >= 0) epilogue(k, acc, stg, ended, spp, o);
      if (it + 1 < n_it) raw.put(gbase + ((it + 1) & 1) * SB, yadj);
      if (it + 2 < n_it)
        load_slice(k, raw, it + 2, spp, x, dx, y, dy, yadj);
      wgmma_wait<0>();
      reg_fence(p1);
      reg_fence(p2);
#pragma unroll
      for (int j = 0; j < NA; ++j)
        acc[j] = __fadd_rn(acc[j], fmaf(sgn, p2[j], p1[j]));
      const int sl = it % spp;
      ended = sl == G::KT - 1 || sl == spp - 1 ? it : -1;
      fence_proxy_async();
      __syncthreads();
    }
    if (ended >= 0) epilogue(k, acc, stg, ended, spp, o);
    __syncthreads();  // the split stages are free for the next product
  }
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

// Shared-memory index of element (r, k) of a PR x KS X slice and of
// element (k, c) of a KS x PC Y slice in the ring: row-major with each 16-byte chunk (two complex elements) XORed
// within its aligned group of 8: chunk k / 2 of X row r by 4 (r & 1), chunk
// c / 2 of Y row k by k & 6. Then mm_slice_tc's reads of a fragment (X: 8
// lanes, rows g and g + 1, chunks t; Y: 16 lanes, rows 2 t, chunks g / 2)
// fall on 32 distinct banks.
template <int KS>
__device__ __forceinline__ int xoff(int r, int k) {
  return r * KS + ((((k >> 1) ^ ((r & 1) << 2)) << 1) | (k & 1));
}

template <int PC>
__device__ __forceinline__ int yoff(int k, int c) {
  return k * PC + ((((c >> 1) ^ (k & 6)) << 1) | (c & 1));
}

// acc += X Y for a PR x KS slice X and a KS x PC slice Y in the ring's
// bf16_3x layout (xoff, yoff), on the calling warp's TcTile fragments: 3 x
// TF32 mma.sync a real product (chain_common.cuh mm_acc_3x's arithmetic,
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
        const float2 y = Ys[yoff<P::PC>(k0 + 2 * t + h, m0 + g + 8 * u)];
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
            Xs + xoff<KS>(8 * P::ni(j0 + u) + g, k0 + 2 * t));
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

// PR 11's bf16_3x form, kept for K3/K4 (ExpmTiled): 3 x TF32 mma.sync
// m16n8k8 on the panel transposed (TcTile), from a ring of 4 chunk-swizzled
// raw stages (xoff, yoff; the conjugate transpose through registers), each
// warp splitting the fragments it reads at every k8 step, each k8 partial
// joined by a rounding add. At their 64 x 64 and 128 x 64 panels the wgmma
// form (Product<1>, there on 64 x 64) measured slower (PERF.md, PR 12;
// profiling/tiled_variants.py).
template <>
struct Product<2> {
  template <int PR, int PC>
  using Tile = TcTile<PR, PC>;
  static constexpr int NS = 4;
  static constexpr int STAGES = 0;  // no split stages
  template <class P>
  __host__ __device__ static constexpr size_t extra() {
    return OP_BYTES;
  }
  template <class P>
  __host__ __device__ static constexpr int split_bytes() {
    return 0;
  }

  // One k-slice into ring stage st in the swizzled layout (xoff, yoff).
  template <bool YADJ, class K>
  static __device__ void issue(const K& k, float2* st, const float2* x,
                               const float2* y, int r0, int c0, int k0) {
    using G = typename K::G;
    float2* xs = st;
    float2* ys = st + G::XSL;
    for (int c = threadIdx.x; c < G::PR * 16; c += NT) {
      const int r = c >> 4, q = 2 * (c & 15);
      cp_async16(xs + xoff<G::KS>(r, q), x + (size_t)(r0 + r) * K::D + k0 + q);
    }
    if constexpr (YADJ) {
      for (int c = threadIdx.x; c < G::PC * 16; c += NT) {
        const int j = c >> 4, q = 2 * (c & 15);
        const float4 a = K::ld4(y + (size_t)(c0 + j) * K::D + k0 + q);
        ys[yoff<G::PC>(q, j)] = make_float2(a.x, -a.y);
        ys[yoff<G::PC>(q + 1, j)] = make_float2(a.z, -a.w);
      }
    } else {
      constexpr int H = G::PC / 2;
      for (int c = threadIdx.x; c < G::KS * H; c += NT) {
        const int r = c / H, q = 2 * (c % H);
        cp_async16(ys + yoff<G::PC>(r, q),
                   y + (size_t)(k0 + r) * K::D + c0 + q);
      }
    }
  }

  static constexpr size_t OP_BYTES = 512;

  // Tiled::run's entry (the stream kernels' op loops in this form, built by
  // profiling/tiled_variants.cu); Tiled::gemm_p calls gemm_form directly.
  // Out of line: inlined at each op site it would multiply the code. One
  // block a workspace (K3/K4) runs no conjugate-transpose product.
  template <class K>
  static __device__ __noinline__ void gemm(const K& k,
                                           const typename K::Op& op) {
    const typename K::Op o = op;
    const bool dual = K::DUAL_FORM && o.dz != nullptr;
    if (K::BLOCKS > 1 && o.yadj)
      gemm_form<K::BLOCKS != 1>(k, dual, o.x, o.dx, o.y, o.dy, o.z, o.dz,
                                o.zs, o.e);
    else
      gemm_form<false>(k, dual, o.x, o.dx, o.y, o.dy, o.z, o.dz, o.zs, o.e);
  }

  template <bool YADJ, class K>
  static __device__ void gemm_form(const K& k, bool dual, const float2* x,
                                   const float2* dx, const float2* y,
                                   const float2* dy, float2* z, float2* dz,
                                   int zs, const Epi& e) {
    using G = typename K::G;
    using P = typename K::P;
    const int spp = dual ? 3 * G::KT : G::KT;
    const int mine = k.rank < G::PANELS
                         ? (G::PANELS - 1 - k.rank) / K::BLOCKS + 1
                         : 0;
    const int n_it = mine * spp;
    auto start = [&](int it) {
      const int p = k.rank + (it / spp) * K::BLOCKS, s = it % spp;
      const int pass = s / G::KT;
      issue<YADJ>(k, k.sm + (it % G::NS) * G::STAGE, pass == 1 ? dx : x,
                  pass == 2 ? dy : y, (p % G::RP) * G::PR,
                  (p / G::RP) * G::PC, (s % G::KT) * G::KS);
    };
#pragma unroll
    for (int it = 0; it < G::NS - 1; ++it) {
      if (it < n_it) start(it);
      cp_async_commit();
    }
    float2 acc[P::EP];
#pragma unroll
    for (int j = 0; j < P::EP; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int it = 0; it < n_it; ++it) {
      cp_async_wait<G::NS - 2>();
      __syncthreads();
      if (it + G::NS - 1 < n_it) start(it + G::NS - 1);
      cp_async_commit();
      const float2* st = k.sm + (it % G::NS) * G::STAGE;
      mm_slice_tc<P, G::KS>(st, st + G::XSL, acc);
      const int s = it % spp;
      if (s != G::KT - 1 && s != spp - 1) continue;
      const bool tan = s != G::KT - 1;
      const int p = k.rank + (it / spp) * K::BLOCKS;
      const int r0 = (p % G::RP) * G::PR, c0 = (p / G::RP) * G::PC;
#pragma unroll
      for (int j = 0; j < P::EP; ++j) {
        if (!P::has(j)) continue;
        k.finish((r0 + P::row(j)) * K::D + c0 + P::col(j), acc[j], tan, e, z,
                 dz, zs);
        acc[j] = make_float2(0.f, 0.f);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// Ring and panel geometry of a product at D = 64 T on the tile P: NS ring
// stages, EXTRA bytes of shared memory after the ring (the mode's split
// stages), then the NT floats of the 1-norm reduction at byte RED.
template <int T, typename P, int NS_ = 4, size_t EXTRA = 0>
struct Geometry {
  static constexpr int D = 64 * T;
  static constexpr int KS = 32;                 // k-slice depth
  static constexpr int KT = D / KS;             // slices a panel
  static constexpr int PR = P::PR, PC = P::PC;  // panel rows, columns
  static constexpr int RP = D / PR;             // row panels
  static constexpr int PANELS = RP * (D / PC);
  static constexpr int NS = NS_;                // ring stages
  static constexpr int XSL = PR * KS;           // X slice elements
  static constexpr int YSL = KS * PC;           // Y slice elements
  static constexpr int STAGE = XSL + YSL;
  static constexpr size_t RED = (size_t)NS * STAGE * sizeof(float2) + EXTRA;
  static constexpr size_t SMEM = RED + NT * sizeof(float);
  static_assert(D % PR == 0 && D % PC == 0, "panels must tile D");
  static_assert(RED >= MAT * sizeof(float2),
                "the shared memory must hold a 64 x 64 staging tile");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

// The tile and geometry of Tiled's form TC (0: the exact SIMT form).
template <int TC, int T, int TM, int TN, int GI>
struct FormOf {
  using P = typename Product<TC>::template Tile<GI * TM, NT / GI * TN>;
  using G = Geometry<T, P, Product<TC>::NS,
                     Product<TC>::template extra<P>()>;
};

template <int T, int TM, int TN, int GI>
struct FormOf<0, T, TM, TN, GI> {
  using P = Tile<TM, TN, GI>;
  using G = Geometry<T, P>;
};

// CL blocks share one workspace and split each operation (see the file
// note). The workspace holds the SLOTS ladder matrices, then any extra
// ones of the caller (extra(j), slot SLOTS + j of value()). TC: the
// bf16_3x mode's form (Product<TC>), on GI TM x (NT / GI) TN panels.
template <int T, bool DUAL, int CL, int TM = 8, int TN = 2, int GI = 8,
          int TC = 0>
struct Tiled {
  using P = typename FormOf<TC, T, TM, TN, GI>::P;
  using G = typename FormOf<TC, T, TM, TN, GI>::G;
  static constexpr int D = G::D;
  static constexpr int N = D * D;
  static constexpr int SLOTS = DUAL ? 2 * NV : NV;
  static constexpr int BLOCKS = CL;       // blocks sharing a workspace
  static constexpr int STRIDE = CL * NT;  // threads of the sharing blocks
  static constexpr int EP = P::EP;
  static constexpr int TC_FORM = TC;
  static constexpr bool DUAL_FORM = DUAL;

  // The identity the ladder's slot lacks: exp(M) - I in the mode.
  static constexpr float ONE = TC ? 1.0f : 0.0f;

  float2* ws;  // the workspace of this cluster
  float2* sm;  // the ring (and a 64 x 64 staging tile outside products)
  float* red;  // NT floats, at byte G::RED of the shared memory
  int rank;    // this block's rank among the CL

  __device__ __forceinline__ float2* v(int s) const {
    return ws + (size_t)s * N;
  }
  __device__ __forceinline__ float2* t(int s) const {
    return ws + (size_t)(NV + s) * N;
  }
  __device__ __forceinline__ float2* extra(int j) const {
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
  __device__ __forceinline__ float2 value(const Lin& L, int i,
                                          int zs = NONE,
                                          float2 z = {}) const {
    float2 r = make_float2(i / D == i % D ? L.id : 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE)
        r = caxpy(L.c[j], L.s[j] == zs ? z : ld(v(L.s[j]) + i), r);
    return r;
  }

  __device__ __forceinline__ float2 tangent(const Lin& L, int i,
                                            int zs = NONE,
                                            float2 dz = {}) const {
    float2 r = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE)
        r = caxpy(L.c[j], L.s[j] == zs ? dz : ld(t(L.s[j]) + i), r);
    return r;
  }

  // dst = src, a D x D matrix (an input, or workspace).
  __device__ __forceinline__ void copy(float2* dst,
                                       const float2* src) const {
    for (int i = first(); i < N; i += STRIDE) dst[i] = ld(src + i);
  }

  // One k-slice of a product into ring stage st: the PR x 32 slice of x
  // at rows r0 and the 32 x PC slice of y (y^H with YADJ) at columns c0,
  // both at depth k0, row-major.
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

  // Component c (0: real, 1: imaginary) of workspace element p, and a
  // reference to it.
  static __device__ __forceinline__ float ldc(const float2* p, int c) {
    const float* q = reinterpret_cast<const float*>(p) + c;
    if constexpr (CL > 1) return __ldcg(q);
    return *q;
  }
  static __device__ __forceinline__ float& at(float2* p, int c) {
    return reinterpret_cast<float*>(p)[c];
  }

  // value() and tangent() on component c: the ladder's combinations are
  // real-linear, so each component is the same sums of that component.
  __device__ __forceinline__ float value_c(const Lin& L, int i, int c,
                                           int zs = NONE, float z = 0) const {
    float r = c == 0 && i / D == i % D ? L.id : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE)
        r = fmaf(L.c[j], L.s[j] == zs ? z : ldc(v(L.s[j]) + i, c), r);
    return r;
  }

  __device__ __forceinline__ float tangent_c(const Lin& L, int i, int c,
                                             int zs = NONE,
                                             float dz = 0) const {
    float r = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (L.s[j] != NONE)
        r = fmaf(L.c[j], L.s[j] == zs ? dz : ldc(t(L.s[j]) + i, c), r);
    return r;
  }

  // finish() on component c of element gi, a its product's component: the
  // mode's warpgroups each run the epilogue of their own component.
  __device__ __forceinline__ void finish_c(int gi, int c, float a, bool tan,
                                           const Epi& e, float2* z,
                                           float2* dz, int zs) const {
    float w = e.alpha * a;
    if (tan) {
      w += tangent_c(e.L, gi, c);
      at(dz + gi, c) = w;
      if (e.tout != nullptr) at(e.tout + gi, c) = w;
    } else {
      w += value_c(e.L, gi, c);
      if (e.add != nullptr) w += ldc(e.add + gi, c);
      at(z + gi, c) = w;
      if (e.vout != nullptr)
        at(e.vout + gi, c) = c == 0 && gi / D == gi % D ? w + e.vid : w;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (e.post_dst[q] == NONE) continue;
      if (tan) at(t(e.post_dst[q]) + gi, c) = tangent_c(e.post[q], gi, c, zs, w);
      else at(v(e.post_dst[q]) + gi, c) = value_c(e.post[q], gi, c, zs, w);
    }
  }

  // The epilogue of element gi of a panel whose product is a (Z = alpha a
  // + L, or its tangent with tan; see gemm_p).
  __device__ __forceinline__ void finish(int gi, float2 a, bool tan,
                                         const Epi& e, float2* z, float2* dz,
                                         int zs) const {
    float2 w = cscale(e.alpha, a);
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

  // Z = alpha x y + L (y^H with YADJ) and the epilogue e; with dz (DUAL
  // only) the dual product, dz = alpha (dx y + x dy) + tangent of L. z and
  // dz must differ from x, dx, y and dy; zs is z's slot (NONE if z is not
  // one), which e's posts may read. The CL blocks split the panels; a panel
  // takes KT slices (x, y), and in the dual form 2 KT more, (dx, y) then
  // (x, dy), its value's epilogue after the first KT and its tangent's
  // after the last.
  template <bool YADJ = false>
  __device__ __forceinline__ void gemm_p(const float2* x, const float2* dx,
                                         const float2* y, const float2* dy,
                                         float2* z, float2* dz, int zs,
                                         const Epi& e) const {
    if constexpr (TC == 1) run(Op{x, dx, y, dy, z, dz, zs, YADJ, e});
    else if constexpr (TC) gemm_tc<YADJ>(x, dx, y, dy, z, dz, zs, e);
    else gemm_simt<YADJ>(DUAL && dz != nullptr, x, dx, y, dy, z, dz, zs, e);
  }

  // The mma.sync form's product (Product<2>), a function of its own as the
  // exact form's: it issues no wgmma, and its callers need no single site.
  template <bool YADJ>
  __device__ void gemm_tc(const float2* x, const float2* dx, const float2* y,
                          const float2* dy, float2* z, float2* dz, int zs,
                          const Epi& e) const {
    Product<TC>::template gemm_form<YADJ>(*this, DUAL && dz != nullptr, x, dx,
                                          y, dy, z, dz, zs, e);
  }

  // One product of the mode's form, gemm_p's arguments (yadj: YADJ). Every
  // product of a kernel in the mode runs through one run() site, in a loop
  // over its ops (ladder, ladder_pick): each site inlines the whole
  // product.
  struct Op {
    const float2 *x, *dx, *y, *dy;
    float2 *z, *dz;
    int zs;
    bool yadj;
    Epi e;
  };

  // The product's operands go to shared memory (the last OP_BYTES before
  // red), where the product reads them; every product ends with a barrier,
  // so the slot is free.
  __device__ __forceinline__ void run(const Op& o) const {
    static_assert(sizeof(Op) <= Product<TC>::OP_BYTES, "Op slot too small");
    Op* slot = reinterpret_cast<Op*>(reinterpret_cast<char*>(red) -
                                     Product<TC>::OP_BYTES);
    if (threadIdx.x == 0) *slot = o;
    __syncthreads();
    Product<TC>::gemm(*this, *slot);
  }

  // The op of gemm(x, y, dst, e).
  __device__ __forceinline__ Op slot_op(int x, int y, int dst,
                                        const Epi& e) const {
    return Op{v(x), DUAL ? t(x) : nullptr, v(y), DUAL ? t(y) : nullptr,
              v(dst), DUAL ? t(dst) : nullptr, dst, false, e};
  }

  // The exact form's product: FP32 SIMT FMAs on the register tile (Tile).
  template <bool YADJ>
  __device__ void gemm_simt(bool dual, const float2* x, const float2* dx,
                            const float2* y, const float2* dy, float2* z,
                            float2* dz, int zs, const Epi& e) const {
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
        finish((r0 + P::row(j)) * D + c0 + P::col(j), acc[j], tan, e, z, dz,
               zs);
        acc[j] = make_float2(0.f, 0.f);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next product
  }

  // slot dst = x y + e (dual: with tangents); dst must differ from x, y.
  __device__ __forceinline__ void gemm(int x, int y, int dst,
                                       const Epi& e) const {
    gemm_p(v(x), DUAL ? t(x) : nullptr, v(y), DUAL ? t(y) : nullptr, v(dst),
           DUAL ? t(dst) : nullptr, dst, e);
  }

  // The conjugate transpose of the 64 x 64 tile at g (row stride D) into
  // shared memory (row stride 64): coalesced reads, transposed writes.
  __device__ __forceinline__ void stage_adjoint(float2* s,
                                                const float2* g) const {
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
  __device__ __forceinline__ int squarings(
      const float2* __restrict__ a) const {
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
  __device__ __forceinline__ void load_scaled(const float2* __restrict__ a,
                                              const float2* __restrict__ g,
                                              float scale) const {
    for (int i = first(); i < N; i += STRIDE) {
      v(M)[i] = cscale(scale, __ldg(a + i));
      if (DUAL) t(M)[i] = cscale(scale, __ldg(g + i));
    }
  }

  // M = scale * a^H, 64 x 64 tile by tile through shared memory (coalesced
  // both ways). Outside products only: it stages in the ring.
  __device__ __forceinline__ void load_adjoint_scaled(
      const float2* __restrict__ a, float scale) const {
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
  __device__ __forceinline__ static Lin drop(Lin L) {
    L.id -= ONE;
    return L;
  }

  // The epilogue of the ladder's last product: L and the copies out to
  // vout and tout (where not null), vout with the mode's identity back.
  __device__ __forceinline__ static Epi last(const Lin& L, float2* vout,
                                             float2* tout) {
    Epi e = epi_out(L, vout, tout);
    e.vid = ONE;
    return e;
  }

  // The ladder on slot M (scaled and synced already); s squarings at level
  // 4. The last product also writes its value to vout and its tangent to
  // tout (where not null). Returns the slot that holds exp(M), exp(M) - I
  // in the mode (and, dual, its Fréchet derivative); ends with sync().
  // Every elementwise pass of the ladder is a post of the product before
  // it. The wgmma form (TC = 1) runs the products one at a time through
  // one run() site (ladder_pick); the others as ladder_ops names them.
  __device__ __forceinline__ int ladder(int level, int s, float2* vout,
                                        float2* tout) const {
    if constexpr (TC == 1) {
      for (int j = 0;; ++j) {
        Op o;
        bool sy;
        int n;
        const int r = ladder_pick(level, s, j, vout, tout, o, sy, n);
        if (j == n) return r;
        run(o);
        if (sy) sync();
      }
    } else {
      return ladder_exact(level, s, vout, tout);
    }
  }

  __device__ int ladder_exact(int level, int s, float2* vout,
                              float2* tout) const {
    Exec x{this};
    return ladder_ops(level, s, vout, tout, x);
  }

  // ladder_ops' sinks: Exec runs each product (and its barrier); Pick keeps
  // product j (sy: a barrier follows it) and counts them (n).
  struct Exec {
    const Tiled* k;
    __device__ __forceinline__ void operator()(int x, int y, int dst,
                                               const Epi& e, bool sy) const {
      k->gemm(x, y, dst, e);
      if (sy) k->sync();
    }
  };
  struct Pick {
    const Tiled* k;
    int j, n;
    Op* o;
    bool* sy;
    __device__ __forceinline__ void operator()(int x, int y, int dst,
                                               const Epi& e, bool s) {
      if (n++ == j) {
        *o = k->slot_op(x, y, dst, e);
        *sy = s;
      }
    }
  };

  // Product j of the ladder into o (sy: a barrier follows it), n the
  // ladder's product count; returns the ladder's result slot.
  __device__ __forceinline__ int ladder_pick(int level, int s, int j,
                                             float2* vout, float2* tout,
                                             Op& o, bool& sy, int& n) const {
    Pick p{this, j, 0, &o, &sy};
    const int r = ladder_ops(level, s, vout, tout, p);
    n = p.n;
    return r;
  }

  // The ladder's products, in order, each op(x, y, dst, epilogue, barrier
  // after it); returns the result slot.
  template <class S>
  __device__ __forceinline__ int ladder_ops(int level, int s, float2* vout,
                                            float2* tout, S& op) const {
    const Lin none = lin(0.0f);
    if (level == 0) {
      // Degree 4: c0 I + c1 M + c2 M2 + M2 (c3 M + c4 M2).
      op(M, M, M2, epi_post(none, M3, lin(0.0f, kC[3], M, kC[4], M2)), true);
      op(M2, M3, X, last(drop(lin(kC[0], kC[1], M, kC[2], M2)), vout, tout),
         true);
      return X;
    }
    if (level == 1) {
      // Degree 8 in 3 products (_D8X): A4 = A2 (x1 M + x2 A2);
      // T8 = y0 I + y1 M + y2 A2 + (x3 A2 + A4)(x4 I + x5 M + x6 A2 + x7 A4).
      op(M, M, M2, epi_post(none, M3, lin(0.0f, kD8[0], M, kD8[1], M2)),
         true);
      op(M2, M3, M4,
         epi_post(none, X, lin(0.0f, kD8[2], M2, 1.0f, M4), Y,
                  lin(kD8[3], kD8[4], M, kD8[5], M2, kD8[6], M4)),
         true);
      op(X, Y, M3,
         last(drop(lin(kD8[7], kD8[8], M, kD8[9], M2)), vout, tout), true);
      return M3;
    }
    op(M, M, M2, epi(none), true);
    if (TC && level == 2) {
      // Degree 12 in 4 products (_D12A, chain_common.cuh kD12), its
      // identity dropped: M3 = M2 M, its post X = lin'(3); A6' = lin'(2) +
      // X X into Y, its posts Y' = lin'(1) + A6' into M4 and (c0 - 1) I +
      // lin'(0) = lin'(0) into M3 (which the first post reads before); then
      // Y' A6' + M3 + a20 Y' + y0 A6'.
      op(M2, M, M3,
         epi_post(none, X,
                  lin(0.0f, kD12[13], M, kD12[14], M2, kD12[15], M3)),
         true);
      op(X, X, Y,
         epi_post(lin(0.0f, kD12[9], M, kD12[10], M2, kD12[11], M3), M4,
                  lin(0.0f, kD12[5], M, kD12[6], M2, kD12[7], M3, 1.0f, Y),
                  M3, lin(kD12C[0] - 1.0f, kD12[1], M, kD12[2], M2,
                          kD12[3], M3)),
         true);
      op(M4, Y, X,
         last(lin(0.0f, 1.0f, M3, kD12[8], M4, kD12C[1], Y), vout, tout),
         true);
      return X;
    }
    // M3 and M4 in one phase: both read M and M2 only, and the post reads
    // the M3 element this thread wrote.
    op(M2, M, M3, epi(none), false);
    if (level == 2) {
      // Degree 12, Paterson-Stockmeyer: M4 (chunk(4) + M4 (chunk(8) +
      // c12 M4)) + chunk(0).
      op(M2, M2, M4, epi_post(none, X, chunk(8, kC[12], M4)), true);
      op(M4, X, Y, epi(chunk(4)), true);
      op(M4, Y, X, last(chunk(0), vout, tout), true);
      return X;
    }
    // Degree 19, Paterson-Stockmeyer: p = chunk(16); p = p M4 + chunk(k).
    op(M2, M2, M4, epi_post(none, X, chunk(16)), true);
    op(X, M4, Y, epi(chunk(12)), true);
    op(Y, M4, X, epi(chunk(8)), true);
    op(X, M4, Y, epi(chunk(4)), true);
    op(Y, M4, X,
       s == 0 ? last(drop(chunk(0)), vout, tout) : epi(drop(chunk(0))),
       true);
    // The squarings: X X, or in the mode D' = 2 D + D D on D = X - I.
    const Lin sq = lin(0.0f, 2.0f * ONE, X);
    int r = X;
    for (int j = 0; j < s; ++j) {
      const int o = r == X ? Y : X;
      Lin L = sq;
      L.s[0] = TC ? r : NONE;
      op(r, r, o, j == s - 1 ? last(L, vout, tout) : epi(L), true);
      r = o;
    }
    return r;
  }
};

// K3/K4's tiled form: one matrix a block, its ladder in the block's own
// workspace; K4 on 8 x 4 register tiles of 128 x 64 panels where they tile
// D (not at D = 192). Both chosen by measuring (expm_fwd.cu). TC: the
// bf16_3x mode's form 2 (Product<2>) on the same panels.
template <int T, bool DUAL, bool TC = false>
using ExpmTiled = Tiled<T, DUAL, 1, 8, DUAL && T != 3 ? 4 : 2,
                        DUAL && T != 3 ? 16 : 8, TC ? 2 : 0>;

// K6's form: the CL = 8 blocks of a cluster share one chain's workspace,
// each one row band of D / 8 rows (64 T x 64 panels) of every product.
constexpr int STREAM_CL = 8;
template <int T, bool DUAL, int TC = 0>
using StreamTiled = Tiled<T, DUAL, STREAM_CL, T, 2, 8, TC>;

// The bf16_3x form K's product layout, for the design lines: {panel rows
// (wgmma N in form 1), split stages, bytes of a raw k-slice (a ring stage),
// bytes of a split stage, shared memory a block, raw ring stages}.
template <class K>
void product_layout(int* out) {
  using F = Product<K::TC_FORM>;
  out[0] = K::P::PR;
  out[1] = F::STAGES;
  out[2] = K::G::STAGE * (int)sizeof(float2);
  out[3] = F::template split_bytes<typename K::P>();
  out[4] = (int)K::G::SMEM;
  out[5] = K::G::NS;
}

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
            reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                     K::G::RED),
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
