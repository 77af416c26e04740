// The card's throughput ceilings for the tensor-core instructions that
// bound K2b (wgrad_kernel in train_frame.cu): mma.sync m16n8k8 with TF32
// operands, the one K2b issues, and m16n8k16 with bf16 operands, the one a
// three-pass bf16 product (X of bf16, dY split hi + mid + lo in bf16) would
// issue. Each warp runs `iters` rounds of 8 independent mma.sync on
// register operands, with no memory traffic, so that the time measures the
// instruction's issue rate alone. chip_smoke.py times it to set K2b's
// measured ceilings beside the data sheet's peaks.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int CHAINS = 8;  // independent accumulators a warp

template <bool BF16>
__global__ void mma_peak_kernel(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f800000u + 3 * threadIdx.x + i;
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (BF16)
        mma_bf16(c[j], a, b);
      else
        mma_tf32(c[j], a, b);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the chains live
}

}  // namespace

extern "C" {

// blocks of `threads` threads each run iters x 8 mma.sync a warp: TF32
// m16n8k8 (2 x 16 x 8 x 8 = 2048 flops each), or with bf16 != 0 bf16
// m16n8k16 (4096 flops each). out holds blocks x threads floats.
int pctd_mma_peak(int bf16, int blocks, int threads, int iters, float* out,
                  void* stream) {
  if (blocks <= 0 || threads <= 0 || threads % 32 || iters <= 0 || !out)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    mma_peak_kernel<true><<<blocks, threads, 0, s>>>(out, iters);
  else
    mma_peak_kernel<false><<<blocks, threads, 0, s>>>(out, iters);
  return cudaGetLastError();
}

}  // extern "C"
