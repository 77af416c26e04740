// The rate at which one SM streams weights from L2 into its shared memory
// through bulk async copies (cp.async.bulk) completing on mbarriers: the
// floor under K1's weight ring (train_frame.cu), which streams each
// block's panel through K1_STAGES such stages a slot. Each block reads
// panel b % panels (`bytes` each, contiguous, L2-resident after the first
// pass when panels x bytes is well under the 50 MB L2), chunk by chunk of
// `stage` bytes into a ring of `stages` stages, `reps` times: thread 0
// keeps `stages` copies in flight, every thread waits for each chunk and
// reads one word of it (summed into out, so that the reads stay). The time
// over the bytes copied is the rate; chip_smoke.py runs it with one block
// and with a block on every SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LS_THREADS = 256;
constexpr int LS_MAX_STAGES = 8;

__device__ __forceinline__ unsigned ls_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(LS_THREADS)
l2_stream_kernel(const char* __restrict__ src, long long bytes, int panels,
                 int stage, int stages, int reps, float* out) {
  extern __shared__ __align__(128) char ring[];
  __shared__ __align__(8) unsigned long long full[LS_MAX_STAGES];
  const int t = threadIdx.x;
  const char* panel = src + (long long)(blockIdx.x % panels) * bytes;
  const long long per = (bytes + stage - 1) / stage;
  const long long total = per * reps;
  if (t == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          ls_smem(full + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long i) {
    const int s = (int)(i % stages);
    const long long off = (i % per) * stage;
    const int n = (int)(bytes - off < stage ? bytes - off : stage);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            ls_smem(full + s)),
        "r"(n)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(ls_smem(ring + (size_t)s * stage)),
        "l"(panel + off), "r"(n), "r"(ls_smem(full + s))
        : "memory");
  };
  if (t == 0)
    for (long long i = 0; i < total && i < stages; ++i) issue(i);
  float sum = 0.0f;
  for (long long i = 0; i < total; ++i) {
    const int s = (int)(i % stages);
    const unsigned parity = (unsigned)((i / stages) & 1);
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(ls_smem(full + s)), "r"(parity)
          : "memory");
    } while (!done);
    sum += reinterpret_cast<const float*>(ring + (size_t)s * stage)[t];
    __syncthreads();
    if (t == 0 && i + stages < total) issue(i + stages);
  }
  out[blockIdx.x * LS_THREADS + t] = sum;
}

}  // namespace

extern "C" {

// `blocks` blocks each stream a panel of `bytes` (a multiple of 16) `reps`
// times through `stages` stages of `stage` bytes (a multiple of 16, at
// least 1 KB); out holds blocks x 256 floats.
int pctd_l2_stream(const void* src, int blocks, long long bytes, int panels,
                   int stage, int stages, int reps, float* out,
                   void* stream) {
  if (blocks < 1 || bytes < 16 || bytes % 16 || panels < 1 || stage < 1024 ||
      stage % 16 || stages < 1 || stages > LS_MAX_STAGES || reps < 1)
    return cudaErrorInvalidValue;
  const int smem = stage * stages;
  cudaError_t e = cudaFuncSetAttribute(
      l2_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  l2_stream_kernel<<<blocks, LS_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), bytes, panels, stage, stages, reps, out);
  return cudaGetLastError();
}

}  // extern "C"
