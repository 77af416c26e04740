// Row-group device code shared by the serving decode kernels K3 and K4
// (decoder.cu) and the teacher-forced frame forward K1 (train_frame.cu): a
// thread-block cluster of C blocks serves a group of DG rows, each block a
// share of every product's output columns in whole 4-column quads (part),
// so that one weight read serves the group; outputs move between the
// blocks through distributed shared memory. group_product runs a block's
// shares of products with weights read from L2.
#pragma once
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DG = 16;                // rows of a group
constexpr int DEC_MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr int XI = 4;  // a summary step's embeddings a thread: DG E <= XI NT

// phases of a row-group launch: all to decode; one alone to time it
constexpr int PH_PROJ = 1, PH_NOTE = 2, PH_DUR = 4, PH_SUMM = 8,
              PH_TIME = 16, PH_ALL = 31, PH_BARRIERS = 32;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax2(int a, int b) { return a > b ? a : b; }
// first index of share c when n items (a multiple of 4) are cut into C
// shares of whole 4-item quads: every share starts 16 bytes into an f32 row
__host__ __device__ inline int part(int n, int C, int c) {
  return 4 * (int)((long long)(n / 4) * c / C);
}

// One part of a group product: out[r][j] = b[j] + sum_{k < in} x[r][k]
// W[k][j] for the group's DG rows, j < n. W points at the part's first
// column of a row-major (in, ldw) weight; b at its bias, or null.
template <typename S>
struct Seg {
  const S* W;
  const S* b;
  int ldw, n, in;
  const float* x;
  int ldx;
  float* out;
  int ldo;
};

template <typename S>
__device__ __forceinline__ Seg<S> seg(const S* W, const S* b, int ldw, int n,
                                      int in, const float* x, int ldx,
                                      float* out, int ldo) {
  return Seg<S>{W, b, ldw, n, in, x, ldx, out, ldo};
}

// A product unit: PJ = 4 neighbouring columns of a part (a part's width
// and first column are multiples of 4, so the unit's weights of one k are
// one 16-byte load in f32, 8 bytes in bf16) for PR of the DG rows, over one
// k-slice. Each x value read from shared memory then feeds PJ FMAs and each
// weight PR: the load path delivers 128 bytes a cycle to an SM, so with one
// scalar column a thread the FMAs would run at a quarter of their rate,
// and 16 rows x 4 columns of sums spill the 128 registers a thread has.
constexpr int PJ = 4;
constexpr int PR = 8;   // rows of a unit: the group's rows in DG / PR halves

// W[0 .. 3] as f32 (16 bytes of f32; 8 bytes of bf16, the bf16 bits in
// the high half of an f32)
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// acc[r][u] += sum_{k0 <= k < k1} x[r][k] W[k][u], k in order, 4 k a round
// (k0 a multiple of 4, x's row stride too: 16-byte loads); the next round's
// weights are loaded while this round's products run. (Two rounds ahead
// measured no faster here and spilled registers.)
template <typename T>
__device__ __forceinline__ void dot_quad(const T* __restrict__ W, int ldw,
                                         int k0, int k1, const float* x,
                                         int ldx, float (&acc)[PR][PJ]) {
  const int n4 = (k1 - k0) >> 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 wv[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wv[kk] = n4 > 0 ? ld4(W + (size_t)(k0 + kk) * ldw) : zero;
  for (int c = 0; c < n4; ++c) {
    const int k = k0 + 4 * c;
    float4 nv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      nv[kk] = c + 1 < n4 ? ld4(W + (size_t)(k + 4 + kk) * ldw) : zero;
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(x + r * ldx + k);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[r][0] = fmaf(av[kk], wv[kk].x, acc[r][0]);
        acc[r][1] = fmaf(av[kk], wv[kk].y, acc[r][1]);
        acc[r][2] = fmaf(av[kk], wv[kk].z, acc[r][2]);
        acc[r][3] = fmaf(av[kk], wv[kk].w, acc[r][3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wv[kk] = nv[kk];
  }
  for (int k = k0 + 4 * n4; k < k1; ++k) {
    const float4 wk = ld4(W + (size_t)k * ldw);
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const float xv = x[r * ldx + k];
      acc[r][0] = fmaf(xv, wk.x, acc[r][0]);
      acc[r][1] = fmaf(xv, wk.y, acc[r][1]);
      acc[r][2] = fmaf(xv, wk.z, acc[r][2]);
      acc[r][3] = fmaf(xv, wk.w, acc[r][3]);
    }
  }
}

// The parts' products over the block's threads: the units of all parts in
// order, `sl` lanes of a warp a unit (sl = 1, 2, 4 or 8, the most that the
// block's threads hold), each lane one k-slice. A slice is a multiple of 4
// k whose count of 16-byte words is odd, so that the lanes of one unit
// read x from different banks. The lanes' sums meet by xor shuffles
// (every lane ends with the same bits) and lane 0 of the unit writes the
// outputs plus the bias. A part's width is a multiple of 4. Every thread
// calls it; it ends synchronized.
template <int NS, typename S>
__device__ __forceinline__ void group_product(const Seg<S> (&sg)[NS]) {
  const int t = threadIdx.x, lane = t & 31;
  constexpr int RH = DG / PR;
  int nq = 0;
#pragma unroll
  for (int i = 0; i < NS; ++i) nq += RH * (sg[i].n / PJ);
  if (nq == 0) return;
  int sl = 1;
  while (sl < 8 && nq * sl * 2 <= NT) sl *= 2;
  const int per_warp = 32 / sl, s = lane % sl;
  const int warps = cdiv(nq, per_warp);
  for (int wq = t >> 5; wq < warps; wq += NT / 32) {
    int p = wq * per_warp + lane / sl;
    const bool live = p < nq;
    // the unit's part, chosen without indexing sg at run time (sg stays in
    // registers); within a part, unit p is row half p / Q, quad p % Q
    Seg<S> g = sg[0];
    int base = 0;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int n = RH * (sg[i].n / PJ);
      if (live && p >= base && p < base + n) {
        g = sg[i];
        p -= base;
      }
      base += n;
    }
    const int Q = imax2(g.n / PJ, 1), r0 = live ? p / Q * PR : 0;
    const int c0 = live ? PJ * (p - r0 / PR * Q) : 0;
    int kc = (cdiv(g.in, sl) + 3) & ~3;
    if (!(kc & 4)) kc += 4;
    const int k0 = min(g.in, s * kc), k1 = live ? min(g.in, k0 + kc) : k0;
    float b[PJ];
#pragma unroll
    for (int u = 0; u < PJ; ++u)
      b[u] = live && s == 0 && g.b ? ldg_f(g.b + c0 + u) : 0.0f;
    float acc[PR][PJ];
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int u = 0; u < PJ; ++u) acc[r][u] = 0.0f;
    dot_quad(g.W + c0, g.ldw, k0, k1, g.x + r0 * g.ldx, g.ldx, acc);
    for (int off = 1; off < sl; off <<= 1)
#pragma unroll
      for (int r = 0; r < PR; ++r)
#pragma unroll
        for (int u = 0; u < PJ; ++u)
          acc[r][u] += __shfl_xor_sync(0xffffffffu, acc[r][u], off);
    if (live && s == 0) {
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        float* o = g.out + (r0 + r) * g.ldo + c0;
#pragma unroll
        for (int u = 0; u < PJ; ++u) o[u] = acc[r][u] + b[u];
      }
    }
  }
  __syncthreads();
}


template <typename Kern>
cudaError_t group_prepare(Kern kern, int bytes, int C) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

inline cudaLaunchConfig_t group_config(int groups, int C, int bytes,
                                       cudaStream_t st,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

inline bool cluster_ok(int C) { return C == 8 || C == 16; }

}  // namespace
