// Issue rate of the tensor-core instruction the bf16_3x mode's kernels use,
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, measured alone, beside
// the FP32 FMA rate of the exact kernels. Built and timed by
// profiling/mma_rate.py.
//
// Each warp runs ITER rounds of CHAINS independent mma (or FMA) chains on
// register operands: no memory traffic in the loop, enough independent
// instructions to cover the pipeline's latency. The result is written once
// so that the compiler keeps the work.

#include <cstdint>
#include <cuda_runtime.h>

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

}  // namespace

// Launches blocks x threads of the kernel (kind 0: mma.sync TF32, kind 1:
// FP32 FMA) for iters rounds on the stream. Per warp and round: CHAINS mma
// (2 x 16 x 8 x 8 FLOP each), or 4 CHAINS FMA per thread (2 FLOP each).
extern "C" int qoc_rate_launch(int kind, float* out, int iters, int blocks,
                               int threads, void* stream) {
  if (kind == 0)
    mma_tf32_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out,
                                                                  iters);
  else
    ffma_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int qoc_rate_chains() { return CHAINS; }
