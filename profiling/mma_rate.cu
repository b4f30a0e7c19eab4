// Issue rate of the tensor-core instructions the bf16_3x mode's kernels use,
// measured alone, beside the FP32 FMA rate of the exact kernels. Built and
// timed by profiling/mma_rate.py.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (the resident kernels'
// and PR 11's tiled form): each warp runs ITER rounds of CHAINS independent
// mma (or FMA) chains on register operands, no memory traffic in the loop,
// enough independent instructions to cover the pipeline's latency.
// wgmma.mma_async m64nNk8 TF32 (the tiled kernels' form, expm_common.cuh's
// wgmma_tf32, N = 40-64): each warpgroup runs ITER rounds of WG_BATCH wgmma
// into one accumulator, both operands in shared memory by descriptor (an
// A plane of 64 and a B plane of N 32-deep rows, 128-byte swizzle, the
// four k8 steps in turn), then a commit and a wait, as the tiled kernels
// issue a k-slice. The results are written once so that the compiler keeps
// the work.

#include "../qoc_tpu_torch/csrc/expm_common.cuh"

namespace {

constexpr int CHAINS = 8;

__global__ void mma_tf32_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
  const uint32_t seed = threadIdx.x * 2654435761u + blockIdx.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = (seed ^ (j * 0x9E3779B9u)) & 0x3F8FE000u;
  b[0] = (seed * 3u) & 0x3F8FE000u;
  b[1] = (seed * 5u) & 0x3F8FE000u;
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < CHAINS; ++q) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(c[q][0]), "+f"(c[q][1]), "+f"(c[q][2]), "+f"(c[q][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < CHAINS; ++q) s += c[q][0] + c[q][1] + c[q][2] + c[q][3];
  if (s == 1.2345f) out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_kernel(float* out, int iters) {
  float x[CHAINS];
  const float y = 1.0f + 1e-7f * threadIdx.x, z = 1e-8f * blockIdx.x;
#pragma unroll
  for (int q = 0; q < CHAINS; ++q) x[q] = q;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int q = 0; q < CHAINS; ++q) x[q] = fmaf(x[q], y, z);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < CHAINS; ++q) s += x[q];
  if (s == 1.2345f) out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int WG_BATCH = 24;  // wgmma a round: a k-slice's, per warpgroup

template <int N>
__global__ void wgmma_tf32_kernel(float* out, int iters) {
  using namespace qoc::ex;
  __shared__ __align__(1024) uint32_t planes[(64 + N) * 32 + 256];
  const uint32_t base = (smem_u32(planes) + 1023u) & ~1023u;
  uint32_t* p = planes + (base - smem_u32(planes)) / 4;
  for (int i = threadIdx.x; i < (64 + N) * 32; i += blockDim.x)
    p[i] = (0x3F800000u + (i * 2654435761u & 0x7FE000u)) ^
           (i & 1 ? 0x80000000u : 0u);
  fence_proxy_async();
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) d[j] = 0.0f;
  const uint32_t a = base, b = base + 64 * 128;
  for (int it = 0; it < iters; ++it) {
    reg_fence(d);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < WG_BATCH; ++u) {
      const uint32_t o = 32 * (u & 3);
      wgmma_tf32<N, 1>(d, gmma_desc(a + o), gmma_desc(b + o), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(d);
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) s += d[j];
  if (s == 1.2345f) out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Launches blocks x threads of the kernel for iters rounds on the stream:
// kind 0 mma.sync TF32 (per warp and round CHAINS mma, 2 x 16 x 8 x 8 FLOP
// each), kind 1 FP32 FMA (4 CHAINS FMA a thread, 2 FLOP each), kinds 40,
// 48, 56, 64 wgmma m64nNk8 TF32 with N = kind (per warpgroup and round
// WG_BATCH wgmma, 2 x 64 x N x 8 FLOP each; threads a multiple of 128).
extern "C" int qoc_rate_launch(int kind, float* out, int iters, int blocks,
                               int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: mma_tf32_kernel<<<blocks, threads, 0, s>>>(out, iters); break;
    case 1: ffma_kernel<<<blocks, threads, 0, s>>>(out, iters); break;
    case 40: wgmma_tf32_kernel<40><<<blocks, threads, 0, s>>>(out, iters); break;
    case 48: wgmma_tf32_kernel<48><<<blocks, threads, 0, s>>>(out, iters); break;
    case 56: wgmma_tf32_kernel<56><<<blocks, threads, 0, s>>>(out, iters); break;
    case 64: wgmma_tf32_kernel<64><<<blocks, threads, 0, s>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int qoc_rate_chains() { return CHAINS; }

extern "C" int qoc_rate_wg_batch() { return WG_BATCH; }
