// Device helpers shared by the decode kernels (decoder.cu) and the
// train-frame kernels (train_frame.cu): block size, GRU gate math and the
// f32 matrix-vector products over a block's batch rows.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;  // threads per block

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// torch-order GRU gate: gi/gh point at the r block, stride = hidden size.
__device__ __forceinline__ float gru_gate(const float* gi, const float* gh,
                                          int H, int j, float h) {
  float r = sigmoid_(gi[j] + gh[j]);
  float z = sigmoid_(gi[H + j] + gh[H + j]);
  float n = tanhf(gi[2 * H + j] + r * gh[2 * H + j]);
  return (1.0f - z) * n + z * h;
}

// acc[r] += sum_{i0 <= i < i1} x[r, i] * W[i, j]
template <int R>
__device__ __forceinline__ void dot_range(const float* __restrict__ W, int ldw,
                                          int j, int i0, int i1,
                                          const float* x, int ldx,
                                          float (&acc)[R]) {
  int i = i0;
  for (; i + 8 <= i1; i += 8) {
    float wv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) wv[u] = __ldg(W + (size_t)(i + u) * ldw + j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4 a = *reinterpret_cast<const float4*>(x + r * ldx + i);
      float4 b = *reinterpret_cast<const float4*>(x + r * ldx + i + 4);
      float s = acc[r];
      s = fmaf(a.x, wv[0], s);
      s = fmaf(a.y, wv[1], s);
      s = fmaf(a.z, wv[2], s);
      s = fmaf(a.w, wv[3], s);
      s = fmaf(b.x, wv[4], s);
      s = fmaf(b.y, wv[5], s);
      s = fmaf(b.z, wv[6], s);
      s = fmaf(b.w, wv[7], s);
      acc[r] = s;
    }
  }
  for (; i < i1; ++i) {
    float wi = __ldg(W + (size_t)i * ldw + j);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(x[r * ldx + i], wi, acc[r]);
  }
}

// y[r, j] = b[j] + sum_i x[r, i] * W[i, j] for r < R, j < n; W is (in, n)
// row-major, b may be null. Every thread of the block must call it; the
// caller synchronizes before reading y. Outputs narrower than half the block
// split the input dimension into S slices whose partial sums meet in `red`.
template <int R>
__device__ void matvec(const float* __restrict__ W,
                       const float* __restrict__ b, int in, int n,
                       const float* x, int ldx, float* y, int ldy,
                       float* red) {
  const int t = threadIdx.x;
  int S = NT / n;
  if (S > 8) S = 8;
  if (S <= 1) {
    for (int j = t; j < n; j += NT) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      dot_range<R>(W, n, j, 0, in, x, ldx, acc);
      const float bj = b ? __ldg(b + j) : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) y[r * ldy + j] = acc[r] + bj;
    }
    return;
  }
  const int chunk = pad4((in + S - 1) / S);
  const int s = t / n, j = t - s * n;
  if (s < S) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const int i0 = s * chunk;
    const int i1 = min(in, i0 + chunk);
    if (i0 < i1) dot_range<R>(W, n, j, i0, i1, x, ldx, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) red[(s * R + r) * n + j] = acc[r];
  }
  __syncthreads();
  for (int idx = t; idx < R * n; idx += NT) {
    const int r = idx / n, jj = idx - r * n;
    float v = 0.0f;
    for (int q = 0; q < S; ++q) v += red[(q * R + r) * n + jj];
    y[r * ldy + jj] = v + (b ? __ldg(b + jj) : 0.0f);
  }
  __syncthreads();  // `red` is free again for the next product
}

}  // namespace
