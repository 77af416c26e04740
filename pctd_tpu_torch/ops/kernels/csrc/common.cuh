// Device helpers shared by the decode kernels (decoder.cu) and the
// train-frame kernels (train_frame.cu): block size, GRU gate math, the
// storage-type conversions and the f32 matrix-vector products over a
// block's batch rows (K1's per-row kernel).
//
// Storage types: float, or __nv_bfloat16 for the train-frame kernels' bf16
// mode. A bf16 value converts to f32 exactly and a product of two bf16
// values is exact in f32, so all arithmetic stays f32 and a bf16 kernel
// rounds only where it stores a value of the storage type.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// f32 -> storage type, round to nearest even
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the nearest value of T, kept in f32 (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// read-only load of a T as f32
template <typename T>
__device__ __forceinline__ float ldg_f(const T* p) { return to_f(__ldg(p)); }

// keeps a parameter out of template argument deduction (nullptr biases)
template <typename T>
struct ident {
  using type = T;
};

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

// acc[r] += sum_{i0 <= i < i1} x[r, i] * W[i, j]; W of storage type T
template <int R, typename T>
__device__ __forceinline__ void dot_range(const T* __restrict__ W, int ldw,
                                          int j, int i0, int i1,
                                          const float* x, int ldx,
                                          float (&acc)[R]) {
  int i = i0;
  for (; i + 8 <= i1; i += 8) {
    float wv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) wv[u] = ldg_f(W + (size_t)(i + u) * ldw + j);
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
    float wi = ldg_f(W + (size_t)i * ldw + j);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(x[r * ldx + i], wi, acc[r]);
  }
}

// y[r, j] = b[j] + sum_i x[r, i] * W[i, j] for r < R, j < n; W is (in, n)
// row-major, b may be null, both of storage type T; the f32 sum is rounded
// to the nearest value of O (float: not rounded). Every thread of the block
// must call it; the caller synchronizes before reading y. Outputs narrower
// than half the block split the input dimension into S slices whose partial
// sums meet in `red`.
template <int R, typename O = float, typename T = float>
__device__ void matvec(const T* __restrict__ W,
                       const typename ident<T>::type* __restrict__ b, int in,
                       int n, const float* x, int ldx, float* y, int ldy,
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
      const float bj = b ? ldg_f(b + j) : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) y[r * ldy + j] = round_to<O>(acc[r] + bj);
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
    y[r * ldy + jj] = round_to<O>(v + (b ? ldg_f(b + jj) : 0.0f));
  }
  __syncthreads();  // `red` is free again for the next product
}

}  // namespace
