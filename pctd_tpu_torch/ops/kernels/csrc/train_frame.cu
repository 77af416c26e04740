// Teacher-forced frame kernels of the training step for Hopper (sm_90a), in
// two storage types (float and bf16): K1 and K2a in f32 arithmetic on CUDA
// cores, K2b in f32-accurate products on the tensor cores.
//
// train_fwd_kernel (K1) replaces pctd_tpu/ops/pallas/train_frame.py::
//   _fwd_kernel: one frame's 15 note-GRU slots (pitch head and argmax,
//   5-step duration GRU with argmax feedback, predicted-note embedding,
//   teacher-coin token select) and the masked bi-GRU summary of the
//   predicted notes. In loss mode it ends in the masked-CE numerators; in
//   logits-out mode (the JAX package's frame_core) it writes the pitch and
//   duration logits instead and reads no target. On the gradient path it
//   writes every activation the backward reads (TrainStash).
// train_bwd_kernel (K2a) and wgrad_kernel (K2b) replace _bwd_kernel, the
//   hand-written VJP: K2a runs each row's reverse chain (summary bi-GRU,
//   the logit cotangents, duration chain and heads, note-GRU reverse
//   recurrence, embedding / token routes) and writes the per-sample gate
//   cotangents; K2b reduces them against the stash into the 24 weight
//   gradients, X^T dY over rows, slots and duration steps. In loss mode
//   K2a computes the logit cotangents in place from the targets; in
//   logits-out mode it reads them (d_pitch, d_dur), already masked by the
//   caller's loss. K2b is the same in both modes.
// Plain PyTorch versions: frame_recon_plain (loss mode) and
// frame_core_plain (logits out) in train_frame.py beside this file
// (autograd of them for K2; wgrad_plain for K2b alone).
//
// What bounds K1 and K2a on this card: like the serving kernels
// (decoder.cu), they are chains of small dependent matrix-vector products,
// ~45 MFLOP a row a frame each over ~30 MB of weights that every block
// reads from L2; at training batches the f32 FLOP bound is a few ms a step,
// and what the design pays is the per-block weight traffic.
//
// What the design does about it: a block owns R batch rows (1, 2 or 4) and
// keeps per-row state in shared memory, as K3 does; the forward products
// reuse decoder.cu's matvec, the backward's transposed products give each
// weight row to a warp (coalesced row reads, shuffle reduction). Where the
// Pallas backward rebuilt the forward from a stash of slot hiddens, the
// H100's 80 GB lets K1 write every gate and decision it computed (~90 MB a
// frame at B=128), so K2 recomputes nothing and never re-decides an argmax.
// Weight gradients are not accumulated with atomics: K2a writes per-sample
// cotangents and K2b sums them in a fixed order, so a gradient is the same
// bits on every run.
//
// K2b (wgrad_kernel, then wgrad_reduce_kernel) replaces the weight-gradient
// adds of _bwd_kernel (pctd_tpu/ops/pallas/train_frame.py:472-476, the
// wgrad helper, and its uses at :613-729): 16 reductions gW = X^T dY, the
// bias a ones row of X at i = I, over rows, slots and duration steps; 5.9
// GFLOP a frame at B=128 over N = B to 75 B samples. What bounds it on this
// card: its products must be f32-accurate (the JAX dot_general multiplies
// in f32, and the cotangents dY are f32 in both storage types), so the
// floor is the tensor cores at three TF32 passes (3xTF32: 495 / 3 = 165
// TFLOP/s) against 67 TFLOP/s on the CUDA cores; for bf16 X, three bf16
// passes (dY split exactly into hi + mid + lo in bf16: 989 / 3 = 330),
// where this kernel runs two TF32 passes (X is exact in TF32: 247.5); and
// the reductions are very unequal (the duration
// GRU's N = 9,600 on 11 output tiles at B=128, the frame projections' 128
// on 544 tiles), so one block a tile waits on the longest tile's chain,
// which is what held the SIMT kernel this one replaced (PERF.md). What the
// design does: the plan (wgrad_plan in train_frame.py) cuts every task
// into work items (task, 64 x 64 output tile, N-slice of whole 32-sample
// chunks) of about one length within a bounded f32 workspace, longest
// first; a block streams its item's X and dY rows through a 3-stage
// cp.async ring (16-byte copies where a row's base and width are 16-byte
// aligned, 4-byte words otherwise: a bf16 row at an odd element offset
// lands one element in, and the fragment reads skip it) while four warps
// run m16n8k8 TF32 mma.sync on the chunk before it, the operands split
// hi + lo (rounded to nearest TF32) and summed lo.hi + hi.lo + hi.hi (bf16
// X: X.lo + X.hi), each thread's fragment values one vector load from a
// conflict-free shared row, each chunk's sum added to the item's in f32.
// A one-slice task writes its gradients rounded once to T; a cut task
// writes f32 partials, and wgrad_reduce_kernel sums each element's slices
// in slice order and rounds once. No atomics: the same bits on every run.
//
// K1 and K2a are plain f32 FMA (no TF32). Ties of the pitch argmax go to the
// lowest index; a dur bit is logit[1] > logit[0] strictly. The argmax
// decisions and the teacher coins carry no gradient.
//
// The bf16 mode (the JAX kernels' compute dtype bfloat16): every kernel is
// a template on the storage type T of the weights, the inputs, the stashed
// values and the outputs; one source serves both types. The arithmetic
// stays f32 (a bf16 load converts exactly, a product of two bf16 values is
// exact in f32, sums are f32 FMA), and a value is rounded to bf16 exactly
// where the Pallas kernel writes .astype(dtype): the note and duration
// hiddens, the pitch and duration logits (the argmaxes and the CE read the
// rounded values), the predicted-note embedding, the summary hiddens, and
// the duration GRU's feedback rows w_dih[b] + b_dih (a bf16 + bf16 sum).
// The sos projection dur_sos @ w_dih + b_dih, the gate pre-activations and
// the gates stay f32. The stash holds the rounded values in bf16 and the
// f32 gates (ng, dg, sg) in f32; the per-sample cotangents and the CE
// numerators are f32; d_frame_h and d_x_emb are rounded once when stored;
// K2b sums each weight gradient in f32 and rounds it once to bf16. Bounds:
// the bf16 mode of K1 and K2a reads half the weight bytes from L2 and does
// the same f32 FMAs; the card's bf16 tensor-core peak is not used by these
// CUDA-core kernels.
#include <stdint.h>

#include "common.cuh"

// Field order matches CoreWeights and Dims (train_frame.py).
template <typename T>
struct TrainWeightsT {
  const T *w_t2n, *b_t2n, *w_ih_frame, *w_ih_tok, *b_ih, *w_hh, *b_hh,
      *w_pitch, *b_pitch, *w_dhid, *b_dhid, *w_dih, *b_dih, *w_dhh, *b_dhh,
      *w_dout, *b_dout, *w_emb, *b_emb, *dur_sos, *we_ih, *we_hh, *be_ih,
      *be_hh;
  int TH, NH, DH, E, EH, P, W, K, eos, pitch_pad, dur_pad;
};

// Field order matches Stash (train_frame.py); S = K-1 slots, shapes there.
// The gates (ng, dg, sg) are f32 in either storage type.
template <typename T>
struct TrainStashT {
  T* hs;
  float* ng;
  T *tok, *est, *hd;
  float* dg;
  T *dlog, *dtok, *emb_in, *pred, *sh;
  float* sg;
};

// Field order matches Cotangents (train_frame.py).
struct TrainCotangents {
  float *d_gi, *d_gh, *d_est, *d_hd0, *d_gid, *d_ghd, *d_log, *d_sos, *d_emb,
      *d_sgi, *d_sgh, *dh0, *d_gif;
};

// Field order matches WgradTaskC (build.py): a WgradTask (train_frame.py),
// its f32 partial-sum workspace and N-slice count from the plan
// (wgrad_plan), and the bookkeeping train_wgrad fills in. X (stash rows)
// and the gradients gW, gb are of the storage type T, the cotangents DY
// f32. gb is null without a bias row, X null when I = 0, ws null with one
// slice.
template <typename T>
struct WgradTaskT {
  const T* X;
  const float* DY;
  T *gW, *gb;
  float* ws;  // [slices][I + bias][O]
  int N, I, O, n_in;
  long long x_o, x_i, y_o, y_i;
  int slices;
  int tiles_o, tiles, item0, elem0;
};

using bf16 = __nv_bfloat16;

namespace {

constexpr int MAX_TASKS = 20;
// K2b: an output tile of WG_TILE rows of gW (the bias row too) by WG_TILE
// columns, four warps of 32 x 32, up to four blocks an SM (128 registers a
// thread, 4 x 56 KB of shared memory)
constexpr int WG_TILE = 64;
constexpr int WG_CHUNK = 32;   // samples a pipeline stage holds
constexpr int WG_STAGES = 3;   // cp.async ring depth
constexpr int WG_THREADS = 128;
// shared row strides (elements): rows 8 words apart mod 32, so that the
// fragment reads (16 bytes a lane; 8 for bf16 X) hit distinct banks
constexpr int WG_LD_O = WG_TILE + 8;
template <typename T>
__host__ __device__ constexpr int wg_ld_i() {
  return WG_TILE + (sizeof(T) == sizeof(float) ? 8 : 16);
}
constexpr int WG_REDUCE_THREADS = 256;

template <typename T>
struct WgradTable {
  WgradTaskT<T> t[MAX_TASKS];
  int n;
};

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

// y[r, i] (+)= sum_o d[r, o] * W[i, o] for i < I: the transposed product of
// the backward. Warp w takes rows i = w, w + NT/32, ...; lanes stride over o
// (coalesced reads of W's row i) and meet in a shuffle reduction. Rows
// r >= nrows are computed but not written. Every thread of the block calls
// it; the caller synchronizes before reading y.
template <int R, typename T>
__device__ void matvec_t(const T* __restrict__ W, int ldw, int I, int O,
                         const float* d, int ldd, float* y, int ldy,
                         bool accumulate, int nrows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < I; i += NT / 32) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const T* wr = W + (size_t)i * ldw;
    for (int o = lane; o < O; o += 32) {
      const float wv = ldg_f(wr + o);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(d[r * ldd + o], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
      for (int r = 0; r < R && r < nrows; ++r) {
        float* yp = y + (size_t)r * ldy + i;
        *yp = accumulate ? *yp + acc[r] : acc[r];
      }
    }
  }
}

// Backward of one torch-order GRU step for hidden unit j, from the saved
// gates g = [r | z | n | h_n] (stride H): writes the input-gate cotangents
// [dr, dz, dn] to d_gi and the hidden-gate ones [dr, dz, dn * r] to d_gh
// (both stride H) and returns dh * z, the direct share of d h_prev.
__device__ __forceinline__ float gru_bwd(float dh, float h_prev,
                                         const float* g, int H, int j,
                                         float* d_gi, float* d_gh) {
  const float r = g[j], z = g[H + j], n = g[2 * H + j], hn = g[3 * H + j];
  const float dz = dh * (h_prev - n);
  const float dn = dh * (1.0f - z);
  const float dn_pre = dn * (1.0f - n * n);
  const float dz_pre = dz * z * (1.0f - z);
  const float dr_pre = dn_pre * hn * r * (1.0f - r);
  d_gi[j] = dr_pre;
  d_gi[H + j] = dz_pre;
  d_gi[2 * H + j] = dn_pre;
  d_gh[j] = dr_pre;
  d_gh[H + j] = dz_pre;
  d_gh[2 * H + j] = dn_pre * r;
  return dh * z;
}

// logsumexp of a row of n logits, reduced over one warp.
template <typename T>
__device__ __forceinline__ float warp_lse(const T* x, int n, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, to_f(x[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.0f;
  for (int j = lane; j < n; j += 32) s += expf(to_f(x[j]) - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return m + logf(s);
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  return m + logf(expf(a - m) + expf(b - m));
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

struct FwdLayout {
  int lTH, l3NH, lHX, lE, lDH, l3DH, lHS, l3EH, lPR;
  int o_fh, o_gif, o_gh, o_gi, o_hx, o_tok, o_hd, o_ghd, o_lg, o_pred, o_hs,
      o_sg, o_nll, o_gsos, o_red, n_floats, n_ints;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(const TrainWeightsT<T>& w,
                                                int R) {
  FwdLayout L;
  L.lTH = pad4(w.TH);
  L.l3NH = pad4(3 * w.NH);
  L.lHX = pad4(w.NH + w.P);
  L.lE = pad4(w.E);
  L.lDH = pad4(w.DH);
  L.l3DH = pad4(3 * w.DH);
  L.lHS = pad4(2 * w.EH);
  L.l3EH = pad4(3 * w.EH);
  L.lPR = w.K * L.lE;
  int o = 0;
  L.o_fh = o;    o += R * L.lTH;       // frame_h
  L.o_gif = o;   o += R * L.l3NH;      // gi_frame = frame_h @ w_ih_frame + b
  L.o_gh = o;    o += R * L.l3NH;      // h @ w_hh + b_hh
  L.o_gi = o;    o += R * L.l3NH;      // token @ w_ih_tok
  L.o_hx = o;    o += R * L.lHX;       // [h | pitch logits]
  L.o_tok = o;   o += R * L.lE;        // token of the next slot
  L.o_hd = o;    o += R * L.lDH;       // dur hidden
  L.o_ghd = o;   o += R * L.l3DH;      // dur hidden gates
  L.o_lg = o;    o += R * 4;           // dur logit
  L.o_pred = o;  o += R * L.lPR;       // summary inputs (K, E)
  L.o_hs = o;    o += R * L.lHS;       // summary [hf | hb]
  L.o_sg = o;    o += R * 4 * L.l3EH;  // summary [gi_f | gh_f | gi_b | gh_b]
  L.o_nll = o;   o += R * 8;           // CE numerators [pitch | W bits]
  L.o_gsos = o;  o += L.l3DH;          // dur sos gi (shared by the rows)
  L.o_red = o;   o += NT * R;          // split-K partial sums
  L.n_floats = o;
  L.n_ints = R * ((w.K - 1) * (1 + w.W) + 1) + w.K;
  return L;
}

template <typename T>
__host__ inline size_t fwd_smem_bytes(const TrainWeightsT<T>& w, int R) {
  FwdLayout L = fwd_layout(w, R);
  return sizeof(float) * (size_t)L.n_floats + sizeof(int) * (size_t)L.n_ints;
}

template <int R, typename T>
__global__ void __launch_bounds__(NT, 1)
train_fwd_kernel(TrainWeightsT<T> w, int B, const int* __restrict__ coins,
                 const T* __restrict__ frame_h, const T* __restrict__ x_emb,
                 const int* __restrict__ gt_pitch,
                 const int* __restrict__ gt_dur,
                 float* __restrict__ nums_rows, T* __restrict__ pitch_logits,
                 T* __restrict__ dur_logits, T* __restrict__ summary,
                 int* __restrict__ lengths, int* __restrict__ decisions,
                 TrainStashT<T> st, int stash, int logits) {
  // loss mode (logits == 0): gt_pitch, gt_dur -> nums_rows (B, 1+W);
  // logits out: pitch_logits (B, K-1, P) and dur_logits (B, K-1, W, 2),
  // batch-major, and the targets are not read.
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const FwdLayout L = fwd_layout(w, R);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int TH = w.TH, NH = w.NH, NH3 = 3 * w.NH, DH = w.DH, DH3 = 3 * w.DH,
            E = w.E, EH = w.EH, EH3 = 3 * w.EH, P = w.P, W = w.W, K = w.K;
  const int S = K - 1;
  float *fh = sm + L.o_fh, *gif = sm + L.o_gif, *gh = sm + L.o_gh,
        *gi = sm + L.o_gi, *hx = sm + L.o_hx, *tok = sm + L.o_tok,
        *hd = sm + L.o_hd, *ghd = sm + L.o_ghd, *lg = sm + L.o_lg,
        *pred = sm + L.o_pred, *hs = sm + L.o_hs, *sg = sm + L.o_sg,
        *nll = sm + L.o_nll, *gsos = sm + L.o_gsos, *red = sm + L.o_red;
  int* ib = reinterpret_cast<int*>(sm + L.n_floats);
  int* pitch = ib;                    // [R][K-1]
  int* bits = ib + R * S;             // [R][K-1][W]
  int* len = bits + R * S * W;        // [R]
  int* coin = len + R;                // [K]: coin[k] for slot k >= 1
  // stash row (slot k, row r) -> index (k * B + row0 + r)
  auto srow = [&](int k, int r) { return (size_t)k * B + row0 + r; };

  for (int idx = t; idx < R * TH; idx += NT) {
    const int r = idx / TH, j = idx - r * TH;
    fh[r * L.lTH + j] =
        r < nrows ? to_f(frame_h[(size_t)(row0 + r) * TH + j]) : 0.0f;
  }
  for (int idx = t; idx < R * E; idx += NT) {
    const int r = idx / E, e = idx - r * E;
    const float v =
        r < nrows ? to_f(x_emb[(size_t)(row0 + r) * K * E + e]) : 0.0f;
    tok[r * L.lE + e] = v;
    pred[r * L.lPR + e] = v;
  }
  for (int idx = t; idx < R * 8; idx += NT) nll[idx] = 0.0f;
  if (t < R) len[t] = 0;
  if (t >= 1 && t < K) coin[t] = coins[t - 1];
  // gi of the dur GRU's sos token: dur_sos @ w_dih + b_dih
  for (int j = t; j < DH3; j += NT) {
    float v = 0.0f;
    for (int q = 0; q < W; ++q) v = fmaf(ldg_f(w.dur_sos + q),
                                         ldg_f(w.w_dih + q * DH3 + j), v);
    gsos[j] = v + ldg_f(w.b_dih + j);
  }
  __syncthreads();
  matvec<R, T>(w.w_t2n, w.b_t2n, TH, NH, fh, L.lTH, hx, L.lHX, red);
  matvec<R>(w.w_ih_frame, w.b_ih, TH, NH3, fh, L.lTH, gif, L.l3NH, red);
  __syncthreads();
  matvec<R>(w.w_hh, w.b_hh, NH, NH3, hx, L.lHX, gh, L.l3NH, red);
  if (stash) {
    for (int idx = t; idx < nrows * NH; idx += NT) {
      const int r = idx / NH, j = idx - r * NH;
      st.hs[srow(0, r) * NH + j] = from_f<T>(hx[r * L.lHX + j]);
    }
  }
  __syncthreads();

  for (int k = 1; k < K; ++k) {
    // notes-GRU step on gi = gi_frame + token @ w_ih_tok
    matvec<R>(w.w_ih_tok, nullptr, E, NH3, tok, L.lE, gi, L.l3NH, red);
    if (stash) {
      for (int idx = t; idx < nrows * E; idx += NT) {
        const int r = idx / E, e = idx - r * E;
        st.tok[srow(k - 1, r) * E + e] = from_f<T>(tok[r * L.lE + e]);
      }
    }
    __syncthreads();
    for (int idx = t; idx < R * NH; idx += NT) {
      const int r = idx / NH, j = idx - r * NH;
      const float* f = gif + r * L.l3NH;
      const float* a = gi + r * L.l3NH;
      const float* g = gh + r * L.l3NH;
      const float ir = f[j] + a[j], iz = f[NH + j] + a[NH + j],
                  in_ = f[2 * NH + j] + a[2 * NH + j];
      const float rr = sigmoid_(ir + g[j]);
      const float zz = sigmoid_(iz + g[NH + j]);
      const float nn = tanhf(in_ + rr * g[2 * NH + j]);
      const float hv = hx[r * L.lHX + j];
      const float hnew = round_to<T>((1.0f - zz) * nn + zz * hv);
      hx[r * L.lHX + j] = hnew;
      if (stash && r < nrows) {
        float* ngp = st.ng + srow(k - 1, r) * 4 * NH;
        ngp[j] = rr;
        ngp[NH + j] = zz;
        ngp[2 * NH + j] = nn;
        ngp[3 * NH + j] = g[2 * NH + j];
        st.hs[srow(k, r) * NH + j] = from_f<T>(hnew);
      }
    }
    __syncthreads();
    // next slot's hidden gates (none after the last slot) and this slot's
    // pitch logits (after h)
    if (k < K - 1)
      matvec<R>(w.w_hh, w.b_hh, NH, NH3, hx, L.lHX, gh, L.l3NH, red);
    matvec<R, T>(w.w_pitch, w.b_pitch, NH, P, hx, L.lHX, hx + NH, L.lHX,
                 red);
    __syncthreads();
    // pitch argmax (ties to the lowest index) and its CE term, warp r
    if (warp < R) {
      const float* y = hx + warp * L.lHX + NH;
      float best = -INFINITY;
      int bi = P;
      for (int j = lane; j < P; j += 32) {
        const float v = y[j];
        if (v > best) { best = v; bi = j; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      bi = __shfl_sync(0xffffffffu, bi, 0);
      const float lse = logits ? 0.0f : warp_lse(y, P, lane);
      if (lane == 0) {
        if (bi >= P) bi = 0;
        pitch[warp * S + k - 1] = bi;
        if (bi == w.eos && len[warp] == 0) len[warp] = k;
        if (!logits && warp < nrows) {
          const int gt = gt_pitch[(size_t)(row0 + warp) * S + k - 1];
          if (gt != w.pitch_pad) nll[warp * 8] += lse - y[gt];
        }
      }
    }
    if (stash) {
      for (int idx = t; idx < nrows * P; idx += NT) {
        const int r = idx / P, j = idx - r * P;
        st.est[srow(k - 1, r) * P + j] = from_f<T>(hx[r * L.lHX + NH + j]);
      }
    }
    if (logits) {
      for (int idx = t; idx < nrows * P; idx += NT) {
        const int r = idx / P, j = idx - r * P;
        pitch_logits[((size_t)(row0 + r) * S + k - 1) * P + j] =
            from_f<T>(hx[r * L.lHX + NH + j]);
      }
    }
    // dur-hidden init from [h | pitch logits], then its hidden gates
    matvec<R, T>(w.w_dhid, w.b_dhid, NH + P, DH, hx, L.lHX, hd, L.lDH, red);
    __syncthreads();
    matvec<R>(w.w_dhh, w.b_dhh, DH, DH3, hd, L.lDH, ghd, L.l3DH, red);
    if (stash) {
      for (int idx = t; idx < nrows * DH; idx += NT) {
        const int r = idx / DH, j = idx - r * DH;
        st.hd[(srow(k - 1, r) * (W + 1)) * DH + j] =
            from_f<T>(hd[r * L.lDH + j]);
      }
    }
    __syncthreads();
    for (int ws = 0; ws < W; ++ws) {
      for (int idx = t; idx < R * DH; idx += NT) {
        const int r = idx / DH, j = idx - r * DH;
        const float* g = ghd + r * L.l3DH;
        float gi3[3];
        if (ws == 0) {
          gi3[0] = gsos[j]; gi3[1] = gsos[DH + j]; gi3[2] = gsos[2 * DH + j];
        } else {
          // the feedback row w_dih[b] + b_dih, a sum of two values of T
          const int b = bits[(r * S + k - 1) * W + ws - 1];
          const T* row = w.w_dih + b * DH3;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            gi3[c] = round_to<T>(ldg_f(row + c * DH + j) +
                                 ldg_f(w.b_dih + c * DH + j));
        }
        const float rr = sigmoid_(gi3[0] + g[j]);
        const float zz = sigmoid_(gi3[1] + g[DH + j]);
        const float nn = tanhf(gi3[2] + rr * g[2 * DH + j]);
        const float hv = hd[r * L.lDH + j];
        const float hnew = round_to<T>((1.0f - zz) * nn + zz * hv);
        hd[r * L.lDH + j] = hnew;
        if (stash && r < nrows) {
          const size_t q = srow(k - 1, r) * W + ws;
          float* dgp = st.dg + q * 4 * DH;
          dgp[j] = rr;
          dgp[DH + j] = zz;
          dgp[2 * DH + j] = nn;
          dgp[3 * DH + j] = g[2 * DH + j];
          st.hd[(srow(k - 1, r) * (W + 1) + ws + 1) * DH + j] =
              from_f<T>(hnew);
          if (j < W) {
            st.dtok[q * W + j] =
                ws == 0 ? __ldg(w.dur_sos + j)
                        : from_f<T>(j == bits[(r * S + k - 1) * W + ws - 1]
                                        ? 1.0f
                                        : 0.0f);
          }
        }
      }
      __syncthreads();
      matvec<R, T>(w.w_dout, w.b_dout, DH, 2, hd, L.lDH, lg, 4, red);
      if (ws + 1 < W)
        matvec<R>(w.w_dhh, w.b_dhh, DH, DH3, hd, L.lDH, ghd, L.l3DH, red);
      __syncthreads();
      if (t < R) {
        const float l0 = lg[t * 4], l1 = lg[t * 4 + 1];
        const int bit = l1 > l0 ? 1 : 0;
        bits[(t * S + k - 1) * W + ws] = bit;
        if (t < nrows) {
          if (logits) {
            T* o = dur_logits +
                   (((size_t)(row0 + t) * S + k - 1) * W + ws) * 2;
            o[0] = from_f<T>(l0);
            o[1] = from_f<T>(l1);
          } else {
            const int gt =
                gt_dur[((size_t)(row0 + t) * S + k - 1) * W + ws];
            if (gt != w.dur_pad)
              nll[t * 8 + 1 + ws] += lse2(l0, l1) - lg[t * 4 + gt];
          }
          if (stash) {
            T* dl = st.dlog + (srow(k - 1, t) * W + ws) * 2;
            dl[0] = from_f<T>(l0);
            dl[1] = from_f<T>(l1);
          }
        }
      }
      __syncthreads();
    }
    // predicted-note embedding (a row select of the one-hot product) and the
    // teacher-coin select of the next slot's token
    for (int idx = t; idx < R * E; idx += NT) {
      const int r = idx / E, e = idx - r * E;
      const int q = r * S + k - 1;
      float v = ldg_f(w.w_emb + (size_t)pitch[q] * E + e);
      for (int ws = 0; ws < W; ++ws)
        if (bits[q * W + ws]) v += ldg_f(w.w_emb + (size_t)(P + ws) * E + e);
      v = round_to<T>(v + ldg_f(w.b_emb + e));
      pred[r * L.lPR + k * L.lE + e] = v;
      tok[r * L.lE + e] =
          coin[k] != 0 && r < nrows
              ? to_f(x_emb[((size_t)(row0 + r) * K + k) * E + e]) : v;
      if (stash && r < nrows) st.pred[srow(k, r) * E + e] = from_f<T>(v);
    }
    if (stash) {
      for (int idx = t; idx < nrows * (P + W); idx += NT) {
        const int r = idx / (P + W), j = idx - r * (P + W);
        const int q = r * S + k - 1;
        st.emb_in[srow(k - 1, r) * (P + W) + j] = from_f<T>(
            j < P ? (j == pitch[q] ? 1.0f : 0.0f) : (float)bits[q * W + j - P]);
      }
    }
    __syncthreads();
  }
  if (t < R && len[t] == 0) len[t] = K - 1;
  if (stash) {
    for (int idx = t; idx < nrows * E; idx += NT) {
      const int r = idx / E, e = idx - r * E;
      st.pred[srow(0, r) * E + e] = from_f<T>(pred[r * L.lPR + e]);
    }
  }
  for (int idx = t; idx < R * 2 * EH; idx += NT) {
    const int r = idx / (2 * EH), j = idx - r * 2 * EH;
    hs[r * L.lHS + j] = 0.0f;
  }
  __syncthreads();

  // masked bi-GRU over pred: step k runs slot k forward, K-1-k backward
  const int ldg = 4 * L.l3EH;
  for (int k = 0; k < K; ++k) {
    matvec<R>(w.we_ih, w.be_ih, E, EH3, pred + k * L.lE, L.lPR, sg, ldg, red);
    matvec<R>(w.we_hh, w.be_hh, EH, EH3, hs, L.lHS, sg + L.l3EH, ldg, red);
    matvec<R>(w.we_ih + (size_t)E * EH3, w.be_ih + EH3, E, EH3,
              pred + (K - 1 - k) * L.lE, L.lPR, sg + 2 * L.l3EH, ldg, red);
    matvec<R>(w.we_hh + (size_t)EH * EH3, w.be_hh + EH3, EH, EH3, hs + EH,
              L.lHS, sg + 3 * L.l3EH, ldg, red);
    __syncthreads();
    for (int idx = t; idx < R * 2 * EH; idx += NT) {
      const int r = idx / (2 * EH), rem = idx - r * 2 * EH;
      const int d = rem / EH, j = rem - d * EH;
      const int slot = d == 0 ? k : K - 1 - k;
      const float* gi_ = sg + r * ldg + 2 * d * L.l3EH;
      const float* gh_ = gi_ + L.l3EH;
      float* hv = hs + r * L.lHS + d * EH + j;
      const float hp = *hv;
      const float rr = sigmoid_(gi_[j] + gh_[j]);
      const float zz = sigmoid_(gi_[EH + j] + gh_[EH + j]);
      const float nn = tanhf(gi_[2 * EH + j] + rr * gh_[2 * EH + j]);
      if (slot < len[r]) *hv = round_to<T>((1.0f - zz) * nn + zz * hp);
      if (stash && r < nrows) {
        const size_t q = (size_t)d * K + k;
        st.sh[(q * B + row0 + r) * EH + j] = from_f<T>(hp);
        float* sgp = st.sg + (q * B + row0 + r) * 4 * EH;
        sgp[j] = rr;
        sgp[EH + j] = zz;
        sgp[2 * EH + j] = nn;
        sgp[3 * EH + j] = gh_[2 * EH + j];
      }
    }
    __syncthreads();
  }
  for (int idx = t; idx < nrows * 2 * EH; idx += NT) {
    const int r = idx / (2 * EH), j = idx - r * 2 * EH;
    summary[(size_t)(row0 + r) * 2 * EH + j] = from_f<T>(hs[r * L.lHS + j]);
  }
  for (int idx = t; !logits && idx < nrows * (1 + W); idx += NT) {
    const int r = idx / (1 + W), q = idx - r * (1 + W);
    nums_rows[(size_t)(row0 + r) * (1 + W) + q] = nll[r * 8 + q];
  }
  for (int idx = t; idx < nrows * S * (1 + W); idx += NT) {
    const int r = idx / (S * (1 + W)), q = idx - r * S * (1 + W);
    const int k = q / (1 + W), c = q - k * (1 + W);
    decisions[(size_t)(row0 + r) * S * (1 + W) + q] =
        c == 0 ? pitch[r * S + k] : bits[(r * S + k) * W + c - 1];
  }
  if (t < nrows) lengths[row0 + t] = len[t];
}

// ---------------------------------------------------------------------------
// K2a: per-row reverse chain
// ---------------------------------------------------------------------------

struct BwdLayout {
  int lTH, lNH, l3NH, lP, lHX, lE, lDH, l3DH, lHS, l3EH, lPR;
  int o_dpred, o_dh, o_dgi, o_dgh, o_dgif, o_dest, o_dhin, o_dhd, o_dhd2,
      o_dgid, o_dghd, o_dtok, o_dtokn, o_dsum, o_dsh, o_dsg, o_dl, o_dfh, o_g,
      n_floats, n_ints;
};

template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(const TrainWeightsT<T>& w,
                                                int R) {
  BwdLayout L;
  L.lTH = pad4(w.TH);
  L.lNH = pad4(w.NH);
  L.l3NH = pad4(3 * w.NH);
  L.lP = pad4(w.P);
  L.lHX = pad4(w.NH + w.P);
  L.lE = pad4(w.E);
  L.lDH = pad4(w.DH);
  L.l3DH = pad4(3 * w.DH);
  L.lHS = pad4(2 * w.EH);
  L.l3EH = pad4(3 * w.EH);
  L.lPR = w.K * L.lE;
  int o = 0;
  L.o_dpred = o; o += R * L.lPR;       // cotangent of the summary inputs
  L.o_dh = o;    o += R * L.lNH;       // d h flowing down the note chain
  L.o_dgi = o;   o += R * L.l3NH;      // note-GRU input-gate cotangents
  L.o_dgh = o;   o += R * L.l3NH;      // note-GRU hidden-gate cotangents
  L.o_dgif = o;  o += R * L.l3NH;      // d gi_frame (sum over slots)
  L.o_dest = o;  o += R * L.lP;        // d pitch logits
  L.o_dhin = o;  o += R * L.lHX;       // d [h | pitch logits] from dur init
  L.o_dhd = o;   o += R * L.lDH;       // d dur hidden
  L.o_dhd2 = o;  o += R * L.lDH;
  L.o_dgid = o;  o += R * L.l3DH;
  L.o_dghd = o;  o += R * L.l3DH;
  L.o_dtok = o;  o += R * L.lE;        // d token consumed by this slot
  L.o_dtokn = o; o += R * L.lE;        // d token consumed by the next slot
  L.o_dsum = o;  o += R * L.lHS;       // d summary state [hf | hb]
  L.o_dsh = o;   o += R * L.lHS;
  L.o_dsg = o;   o += R * 4 * L.l3EH;  // [d_gi_f | d_gh_f | d_gi_b | d_gh_b]
  L.o_dl = o;    o += R * 4;           // d dur logit
  L.o_dfh = o;   o += R * L.lTH;       // d frame_h, summed in f32
  L.o_g = o;     o += 8;               // d nums
  L.n_floats = o;
  L.n_ints = R + w.K;
  return L;
}

template <typename T>
__host__ inline size_t bwd_smem_bytes(const TrainWeightsT<T>& w, int R) {
  BwdLayout L = bwd_layout(w, R);
  return sizeof(float) * (size_t)L.n_floats + sizeof(int) * (size_t)L.n_ints;
}

template <int R, typename T>
__global__ void __launch_bounds__(NT, 1)
train_bwd_kernel(TrainWeightsT<T> w, int B, const int* __restrict__ coins,
                 const int* __restrict__ gt_pitch,
                 const int* __restrict__ gt_dur,
                 const int* __restrict__ lengths,
                 const float* __restrict__ d_nums,
                 const T* __restrict__ d_pitch, const T* __restrict__ d_dur,
                 const T* __restrict__ d_summ, T* __restrict__ d_frame_h,
                 T* __restrict__ d_x_emb, TrainStashT<T> st,
                 TrainCotangents ct, int logits) {
  // loss mode (logits == 0): the logit cotangents are g * mask * (softmax -
  // onehot) from gt_pitch, gt_dur and d_nums; logits out: they are read
  // from d_pitch (B, K-1, P) and d_dur (B, K-1, W, 2), and the targets and
  // d_nums are not read.
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdLayout L = bwd_layout(w, R);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int TH = w.TH, NH = w.NH, NH3 = 3 * w.NH, DH = w.DH, DH3 = 3 * w.DH,
            E = w.E, EH = w.EH, EH3 = 3 * w.EH, P = w.P, W = w.W, K = w.K;
  const int S = K - 1;
  float *dpred = sm + L.o_dpred, *dh = sm + L.o_dh, *dgi = sm + L.o_dgi,
        *dgh = sm + L.o_dgh, *dgif = sm + L.o_dgif, *dest = sm + L.o_dest,
        *dhin = sm + L.o_dhin, *dhd = sm + L.o_dhd, *dhd2 = sm + L.o_dhd2,
        *dgid = sm + L.o_dgid, *dghd = sm + L.o_dghd, *dtok = sm + L.o_dtok,
        *dtokn = sm + L.o_dtokn, *dsum = sm + L.o_dsum, *dsh = sm + L.o_dsh,
        *dsg = sm + L.o_dsg, *dl = sm + L.o_dl, *dfh = sm + L.o_dfh,
        *g = sm + L.o_g;
  int* len = reinterpret_cast<int*>(sm + L.n_floats);  // [R]
  int* coin = len + R;                                 // [K]
  auto srow = [&](int k, int r) { return (size_t)k * B + row0 + r; };
  const int ldg = 4 * L.l3EH;

  if (t < R) len[t] = t < nrows ? lengths[row0 + t] : 0;
  if (t >= 1 && t < K) coin[t] = coins[t - 1];
  if (t < 1 + W) g[t] = logits ? 0.0f : d_nums[t];
  for (int idx = t; idx < R * 2 * EH; idx += NT) {
    const int r = idx / (2 * EH), j = idx - r * 2 * EH;
    dsum[r * L.lHS + j] =
        r < nrows ? to_f(d_summ[(size_t)(row0 + r) * 2 * EH + j]) : 0.0f;
  }
  for (int idx = t; idx < R * L.lPR; idx += NT) dpred[idx] = 0.0f;
  __syncthreads();

  // ---- summary bi-GRU backward, steps K-1 .. 0
  for (int k = K - 1; k >= 0; --k) {
    for (int idx = t; idx < R * 2 * EH; idx += NT) {
      const int r = idx / (2 * EH), rem = idx - r * 2 * EH;
      const int d = rem / EH, j = rem - d * EH;
      const int slot = d == 0 ? k : K - 1 - k;
      const float m = slot < len[r] ? 1.0f : 0.0f;
      const int rr = r < nrows ? r : 0;
      const size_t q = ((size_t)d * K + k) * B + row0 + rr;
      const float* gates = st.sg + q * 4 * EH;
      const float hp = to_f(st.sh[q * EH + j]);
      float* dgi_ = dsg + r * ldg + 2 * d * L.l3EH;
      float* dgh_ = dgi_ + L.l3EH;
      dsh[r * L.lHS + d * EH + j] =
          gru_bwd(m * dsum[r * L.lHS + d * EH + j], hp, gates, EH, j, dgi_,
                  dgh_);
      if (r < nrows) {
        float* o_gi = ct.d_sgi + (((size_t)d * K + slot) * B + row0 + r) * EH3;
        float* o_gh = ct.d_sgh + q * EH3;
        for (int c = 0; c < 3; ++c) {
          o_gi[c * EH + j] = dgi_[c * EH + j];
          o_gh[c * EH + j] = dgh_[c * EH + j];
        }
      }
    }
    __syncthreads();
    for (int d = 0; d < 2; ++d) {
      const int slot = d == 0 ? k : K - 1 - k;
      matvec_t<R>(w.we_hh + (size_t)d * EH * EH3, EH3, EH, EH3,
                  dsg + 2 * d * L.l3EH + L.l3EH, ldg, dsh + d * EH, L.lHS,
                  true, R);
      matvec_t<R>(w.we_ih + (size_t)d * E * EH3, EH3, E, EH3,
                  dsg + 2 * d * L.l3EH, ldg, dpred + slot * L.lE, L.lPR,
                  true, R);
      __syncthreads();  // both directions may add to one slot (K odd)
    }
    __syncthreads();
    for (int idx = t; idx < R * 2 * EH; idx += NT) {
      const int r = idx / (2 * EH), rem = idx - r * 2 * EH;
      const int d = rem / EH;
      const int slot = d == 0 ? k : K - 1 - k;
      const float m = slot < len[r] ? 1.0f : 0.0f;
      float* ds = dsum + r * L.lHS + rem;
      *ds = (1.0f - m) * *ds + dsh[r * L.lHS + rem];
    }
    __syncthreads();
  }

  // ---- slots K-1 .. 1: CE cotangents, dur chain + heads, note-GRU step
  for (int idx = t; idx < R * NH; idx += NT) {
    const int r = idx / NH, j = idx - r * NH;
    dh[r * L.lNH + j] = 0.0f;
  }
  for (int idx = t; idx < R * NH3; idx += NT) {
    const int r = idx / NH3, j = idx - r * NH3;
    dgif[r * L.l3NH + j] = 0.0f;
  }
  for (int idx = t; idx < R * E; idx += NT) {
    const int r = idx / E, e = idx - r * E;
    dtokn[r * L.lE + e] = 0.0f;
  }
  __syncthreads();
  for (int k = K - 1; k >= 1; --k) {
    // pitch-logit cotangent: given (logits out), or the CE's
    // g0 * mask * (softmax - onehot), warp r (loss mode)
    if (logits) {
      for (int idx = t; idx < R * P; idx += NT) {
        const int r = idx / P, j = idx - r * P;
        dest[r * L.lP + j] =
            r < nrows
                ? to_f(d_pitch[((size_t)(row0 + r) * S + k - 1) * P + j])
                : 0.0f;
      }
    } else if (warp < R) {
      const int r = warp, rr = r < nrows ? r : 0;
      const T* est = st.est + srow(k - 1, rr) * P;
      const int gt = r < nrows ? gt_pitch[(size_t)(row0 + r) * S + k - 1]
                               : w.pitch_pad;
      const float lse = warp_lse(est, P, lane);
      const float gm = gt != w.pitch_pad ? g[0] : 0.0f;
      for (int j = lane; j < P; j += 32)
        dest[r * L.lP + j] =
            gm * (expf(to_f(est[j]) - lse) - (j == gt ? 1.0f : 0.0f));
    }
    for (int idx = t; idx < R * DH; idx += NT) {
      const int r = idx / DH, j = idx - r * DH;
      dhd[r * L.lDH + j] = 0.0f;
    }
    __syncthreads();
    // duration chain backward, steps W-1 .. 0
    for (int ws = W - 1; ws >= 0; --ws) {
      if (t < R) {
        const int r = t, rr = r < nrows ? r : 0;
        float d0 = 0.0f, d1 = 0.0f;
        if (logits) {
          const T* dd =
              d_dur + (((size_t)(row0 + rr) * S + k - 1) * W + ws) * 2;
          if (r < nrows) {
            d0 = to_f(dd[0]);
            d1 = to_f(dd[1]);
          }
        } else {
          const T* lgt = st.dlog + (srow(k - 1, rr) * W + ws) * 2;
          const float lg[2] = {to_f(lgt[0]), to_f(lgt[1])};
          const int gt =
              r < nrows ? gt_dur[((size_t)(row0 + r) * S + k - 1) * W + ws]
                        : w.dur_pad;
          const float lse = lse2(lg[0], lg[1]);
          const float gm = gt != w.dur_pad ? g[1 + ws] : 0.0f;
          d0 = gm * (expf(lg[0] - lse) - (gt == 0 ? 1.0f : 0.0f));
          d1 = gm * (expf(lg[1] - lse) - (gt == 1 ? 1.0f : 0.0f));
        }
        dl[r * 4] = d0;
        dl[r * 4 + 1] = d1;
        if (r < nrows) {
          float* o = ct.d_log + (srow(k - 1, r) * W + ws) * 2;
          o[0] = d0;
          o[1] = d1;
        }
      }
      __syncthreads();
      for (int idx = t; idx < R * DH; idx += NT) {
        const int r = idx / DH, j = idx - r * DH, rr = r < nrows ? r : 0;
        const float dlogit = dl[r * 4] * ldg_f(w.w_dout + j * 2) +
                             dl[r * 4 + 1] * ldg_f(w.w_dout + j * 2 + 1);
        const float dhv = dhd[r * L.lDH + j] + dlogit;
        const size_t q = srow(k - 1, rr) * W + ws;
        const float hp =
            to_f(st.hd[(srow(k - 1, rr) * (W + 1) + ws) * DH + j]);
        dhd2[r * L.lDH + j] =
            gru_bwd(dhv, hp, st.dg + q * 4 * DH, DH, j, dgid + r * L.l3DH,
                    dghd + r * L.l3DH);
        if (r < nrows) {
          for (int c = 0; c < 3; ++c) {
            ct.d_gid[q * DH3 + c * DH + j] = dgid[r * L.l3DH + c * DH + j];
            ct.d_ghd[q * DH3 + c * DH + j] = dghd[r * L.l3DH + c * DH + j];
          }
        }
      }
      __syncthreads();
      matvec_t<R>(w.w_dhh, DH3, DH, DH3, dghd, L.l3DH, dhd2, L.lDH, true, R);
      if (ws == 0)
        matvec_t<R>(w.w_dih, DH3, W, DH3, dgid, L.l3DH,
                    ct.d_sos + srow(k - 1, 0) * W, W, false, nrows);
      __syncthreads();
      for (int idx = t; idx < R * DH; idx += NT) {
        const int r = idx / DH, j = idx - r * DH;
        dhd[r * L.lDH + j] = dhd2[r * L.lDH + j];
      }
      __syncthreads();
    }
    for (int idx = t; idx < nrows * DH; idx += NT) {
      const int r = idx / DH, j = idx - r * DH;
      ct.d_hd0[srow(k - 1, r) * DH + j] = dhd[r * L.lDH + j];
    }
    // dur-hidden init: d [h | est] = d_hd0 @ w_dhid^T
    matvec_t<R>(w.w_dhid, DH, NH + P, DH, dhd, L.lDH, dhin, L.lHX, false, R);
    __syncthreads();
    for (int idx = t; idx < R * P; idx += NT) {
      const int r = idx / P, j = idx - r * P;
      const float v = dest[r * L.lP + j] + dhin[r * L.lHX + NH + j];
      dest[r * L.lP + j] = v;
      if (r < nrows) ct.d_est[srow(k - 1, r) * P + j] = v;
    }
    __syncthreads();
    // injected d h_k = d_dhid_in[:NH] + d_est @ w_pitch^T
    matvec_t<R>(w.w_pitch, P, NH, P, dest, L.lP, dhin, L.lHX, true, R);
    __syncthreads();
    // note-GRU step k backward
    for (int idx = t; idx < R * NH; idx += NT) {
      const int r = idx / NH, j = idx - r * NH, rr = r < nrows ? r : 0;
      const float dhk = dh[r * L.lNH + j] + dhin[r * L.lHX + j];
      const float hp = to_f(st.hs[srow(k - 1, rr) * NH + j]);
      float* dgi_ = dgi + r * L.l3NH;
      float* dgh_ = dgh + r * L.l3NH;
      dh[r * L.lNH + j] = gru_bwd(dhk, hp, st.ng + srow(k - 1, rr) * 4 * NH,
                                  NH, j, dgi_, dgh_);
      for (int c = 0; c < 3; ++c) {
        dgif[r * L.l3NH + c * NH + j] += dgi_[c * NH + j];
        if (r < nrows) {
          ct.d_gi[srow(k - 1, r) * NH3 + c * NH + j] = dgi_[c * NH + j];
          ct.d_gh[srow(k - 1, r) * NH3 + c * NH + j] = dgh_[c * NH + j];
        }
      }
    }
    __syncthreads();
    matvec_t<R>(w.w_hh, NH3, NH, NH3, dgh, L.l3NH, dh, L.lNH, true, R);
    matvec_t<R>(w.w_ih_tok, NH3, E, NH3, dgi, L.l3NH, dtok, L.lE, false, R);
    __syncthreads();
    // slot k's embedding feeds the summary and, unless the coin took the
    // ground truth, the next slot's token
    for (int idx = t; idx < nrows * E; idx += NT) {
      const int r = idx / E, e = idx - r * E;
      const float dn = dtokn[r * L.lE + e];
      ct.d_emb[srow(k - 1, r) * E + e] =
          dpred[r * L.lPR + k * L.lE + e] + (coin[k] != 0 ? 0.0f : dn);
      d_x_emb[((size_t)(row0 + r) * K + k) * E + e] =
          from_f<T>(coin[k] != 0 ? dn : 0.0f);
    }
    __syncthreads();
    for (int idx = t; idx < R * E; idx += NT) {
      const int r = idx / E, e = idx - r * E;
      dtokn[r * L.lE + e] = dtok[r * L.lE + e];
    }
    __syncthreads();
  }
  for (int idx = t; idx < nrows * E; idx += NT) {
    const int r = idx / E, e = idx - r * E;
    d_x_emb[(size_t)(row0 + r) * K * E + e] =
        from_f<T>(dtokn[r * L.lE + e] + dpred[r * L.lPR + e]);
  }
  for (int idx = t; idx < nrows * NH; idx += NT) {
    const int r = idx / NH, j = idx - r * NH;
    ct.dh0[(size_t)(row0 + r) * NH + j] = dh[r * L.lNH + j];
  }
  for (int idx = t; idx < nrows * NH3; idx += NT) {
    const int r = idx / NH3, j = idx - r * NH3;
    ct.d_gif[(size_t)(row0 + r) * NH3 + j] = dgif[r * L.l3NH + j];
  }
  // d frame_h = dh0 @ w_t2n^T + d_gi_frame @ w_ih_frame^T, summed in f32
  // and rounded once to T
  matvec_t<R>(w.w_t2n, NH, TH, NH, dh, L.lNH, dfh, L.lTH, false, R);
  __syncthreads();
  matvec_t<R>(w.w_ih_frame, NH3, TH, NH3, dgif, L.l3NH, dfh, L.lTH, true, R);
  __syncthreads();
  for (int idx = t; idx < nrows * TH; idx += NT) {
    const int r = idx / TH, j = idx - r * TH;
    d_frame_h[(size_t)(row0 + r) * TH + j] = from_f<T>(dfh[r * L.lTH + j]);
  }
}

// ---------------------------------------------------------------------------
// K2b: weight gradients, gW = X^T dY and gb = 1^T dY per task
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (nearest, ties away from zero, as cvt.rna.tf32.f32),
// as f32 bits: half of the 13 dropped mantissa bits added, then masked off
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// c += a b: one m16n8k8 TF32 product, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand's rows in a tile: sample n's row starts at element
// (n / n_in) * outer + (n % n_in) * inner + col0 of base and holds len
// elements of es bytes; and this thread's share of the copies: segment
// `lane` of rows r0, r0 + step, ... of each chunk.
struct WgRows {
  const char* base;
  long long outer, inner;
  int col0, len, es;
  bool vec;   // 16-byte copies: base, strides and width 16-byte aligned
  bool fast;  // vec, n_in = 1: a row is base + n * outer, one copy a lane
  int lanes, lane, r0, step;
};

// threads that share a row's copies: the least power of two >= copies, at
// most a warp
__device__ __forceinline__ int lanes_for(int copies) {
  int p = 1;
  while (p < copies && p < 32) p <<= 1;
  return p;
}

__device__ __forceinline__ WgRows wg_rows(const void* base, long long outer,
                                          long long inner, int width,
                                          int n_in, int col0, int es) {
  WgRows r;
  r.base = static_cast<const char*>(base);
  r.outer = outer;
  r.inner = inner;
  r.col0 = col0;
  r.len = max(0, min(WG_TILE, width - col0));
  r.es = es;
  r.vec = ((reinterpret_cast<uintptr_t>(base) |
            static_cast<uintptr_t>(outer * es) |
            static_cast<uintptr_t>(inner * es) |
            static_cast<uintptr_t>(width * es)) & 15) == 0;
  r.fast = r.vec && n_in == 1;
  r.lanes = lanes_for(r.vec ? r.len * es / 16 : (r.len * es + 5) / 4);
  r.lane = threadIdx.x % r.lanes;
  r.r0 = threadIdx.x / r.lanes;
  r.step = WG_THREADS / r.lanes;
  return r;
}

// Issues the cp.async copies of one chunk's sample rows [nbase, nbase +
// WG_CHUNK) of an operand into dst (WG_CHUNK shared rows of ld elements);
// rows at or past n_end are zero-filled. A fast operand's row is one
// 16-byte copy a lane at base + n * outer. Otherwise each row's offset is
// computed once (one division by n_in); a row of 16-byte aligned base and
// width goes in 16-byte copies, any other in 4-byte words from the word
// holding its first element, so a bf16 row at an odd element offset lands
// one element into its shared row: that shift goes to shift[row] when
// shift is given.
__device__ __forceinline__ void wg_load_rows(const WgRows& op, char* dst,
                                             int ld, int* shift, int nbase,
                                             int n_end, int n_in) {
  const int bytes = op.len * op.es;
  if (op.fast) {
    if (op.lane * 16 >= bytes) return;
    const char* src = op.base + (long long)op.col0 * op.es + op.lane * 16;
    const long long row_bytes = op.outer * op.es;
    for (int r = op.r0; r < WG_CHUNK; r += op.step) {
      const int n = nbase + r;
      cp_async16(dst + (r * ld * op.es + op.lane * 16),
                 n < n_end ? src + n * row_bytes : op.base,
                 n < n_end ? 16 : 0);
    }
    return;
  }
  for (int r = op.r0; r < WG_CHUNK; r += op.step) {
    const int n = nbase + r;
    char* d = dst + r * ld * op.es;
    int sh = 0;
    if (n < n_end) {
      const int q = n_in == 1 ? n : n / n_in;
      const char* src =
          op.base + ((long long)q * op.outer +
                     (long long)(n - q * n_in) * op.inner + op.col0) * op.es;
      if (op.vec) {
        for (int c = op.lane; c < bytes / 16; c += op.lanes)
          cp_async16(d + 16 * c, src + 16 * c, 16);
      } else {
        const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
        const char* w = src - lead;
        for (int c = op.lane; c < (lead + bytes + 3) / 4; c += op.lanes)
          cp_async4(d + 4 * c, w + 4 * c, 4);
        sh = lead / op.es;
      }
    } else {
      const char* z = reinterpret_cast<const char*>(
          reinterpret_cast<uintptr_t>(op.base) & ~static_cast<uintptr_t>(15));
      if (op.vec) {
        for (int c = op.lane; c < bytes / 16; c += op.lanes)
          cp_async16(d + 16 * c, z, 0);
      } else {
        for (int c = op.lane; c < (bytes + 3) / 4; c += op.lanes)
          cp_async4(d + 4 * c, z, 0);
      }
    }
    if (shift && op.lane == 0) shift[r] = sh;
  }
}

// Four consecutive values of a shared row as f32 (a 16-byte load for f32,
// 8 bytes for bf16; p 16- or 8-byte aligned)
__device__ __forceinline__ float4 wg_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 wg_ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The warp's 32 x 32 piece of the tile over one chunk: four k = 8 steps of
// m16n8k8 TF32 products, f32-accurate. An f32 operand is split into
// hi = tf32(x) and lo = tf32(x - hi) and a product summed as lo.hi + hi.lo
// + hi.hi (3xTF32); a bf16 X is exact in TF32, so X.lo + X.hi (2xTF32).
// Which gW row and column a fragment lane holds is chosen so that each
// thread's values sit side by side in shared memory: lane (g, t)'s A rows
// of block mi, halves h = 0, 1, are the piece's rows 4g + 2mi + h, and its
// B column of block ni is the piece's column 4g + ni; so a k row's A and
// B values are one vector load each. (The accumulator's element q of block
// (mi, ni) is then row 4g + 2mi + q / 2, column 4 (2t + q % 2) + ni.)
// amode says where each A value comes from: 0 zero, 1 shared X, 2 the bias
// row's ones; sh, the shift of a bf16 row at an odd offset. Dense: every
// A value comes from X and no row is shifted, and the warp's piece lies
// inside the tile, so the chunk is one branch-free block.
template <typename T, bool Dense>
__device__ __forceinline__ void wg_chunk(const T* xs, const float* ds,
                                         const int* sh, int wm, int wn,
                                         int g, int t, int mcnt, int ncnt,
                                         const int (&amode)[4],
                                         float (&acc)[2][4][4]) {
  constexpr bool split_x = sizeof(T) == sizeof(float);
#pragma unroll
  for (int kk = 0; kk < WG_CHUNK; kk += 8) {
    const int ka = kk + t, kb = ka + 4;
    float xa[4], xb[4];  // A values at rows 4g + j (j = 2mi + h), k = ka, kb
    if (Dense) {
      const float4 va = wg_ld4(xs + ka * wg_ld_i<T>() + wm + 4 * g);
      const float4 vb = wg_ld4(xs + kb * wg_ld_i<T>() + wm + 4 * g);
      xa[0] = va.x; xa[1] = va.y; xa[2] = va.z; xa[3] = va.w;
      xb[0] = vb.x; xb[1] = vb.y; xb[2] = vb.z; xb[3] = vb.w;
    } else {
      const T* pa = xs + ka * wg_ld_i<T>() + sh[ka] + wm + 4 * g;
      const T* pb = xs + kb * wg_ld_i<T>() + sh[kb] + wm + 4 * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float one = amode[j] == 2 ? 1.0f : 0.0f;
        xa[j] = amode[j] == 1 ? to_f(pa[j]) : one;
        xb[j] = amode[j] == 1 ? to_f(pb[j]) : one;
      }
    }
    const float4 da = wg_ld4(ds + ka * WG_LD_O + wn + 4 * g);
    const float4 db = wg_ld4(ds + kb * WG_LD_O + wn + 4 * g);
    const float ya[4] = {da.x, da.y, da.z, da.w};
    const float yb[4] = {db.x, db.y, db.z, db.w};
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      // a0 (row g, k = t), a1 (row g + 8, k = t), a2, a3 (k = t + 4)
      const float v[4] = {xa[2 * mi], xa[2 * mi + 1], xb[2 * mi],
                          xb[2 * mi + 1]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (split_x) {
          ah[mi][q] = tf32_rna(v[q]);
          al[mi][q] = tf32_rna(v[q] - __uint_as_float(ah[mi][q]));
        } else {
          ah[mi][q] = __float_as_uint(v[q]);
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      // b0 (k = t, column g), b1 (k = t + 4)
      const float b[2] = {ya[ni], yb[ni]};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        bh[ni][q] = tf32_rna(b[q]);
        bl[ni][q] = tf32_rna(b[q] - __uint_as_float(bh[ni][q]));
      }
    }
    // pass by pass over the eight accumulators, so that an mma never waits
    // on the one just issued
#pragma unroll
    for (int p = split_x ? 0 : 1; p < 3; ++p) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (!Dense && (mi >= mcnt || ni >= ncnt)) continue;
          if (p == 0)
            mma_tf32(acc[mi][ni], al[mi], bh[ni]);
          else if (p == 1)
            mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
          else
            mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
        }
      }
    }
  }
}

template <typename T>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return (size_t)WG_STAGES * WG_CHUNK *
         (WG_LD_O * sizeof(float) + wg_ld_i<T>() * sizeof(T) + sizeof(int));
}

// the epilogue's f32 tile in shared memory (over the ring): row stride
constexpr int WG_LD_E = WG_TILE + 4;
static_assert(WG_TILE * WG_LD_E * sizeof(float) <=
                  WG_STAGES * WG_CHUNK * WG_LD_O * sizeof(float),
              "the epilogue tile must fit in the dY ring");

// Pass 1: one work item a block (task, output tile, N-slice of whole
// chunks, as wgrad_plan in train_frame.py cuts them): the tile's X^T dY
// over the slice's samples, the X and dY rows streamed through a
// WG_STAGES-deep cp.async ring. A one-slice task's item writes gW / gb
// rounded once to T; the others write f32 partials to the task's ws.
template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 4)
wgrad_kernel(const __grid_constant__ WgradTable<T> tab) {
  extern __shared__ float4 smem4[];
  float* Ds = reinterpret_cast<float*>(smem4);  // [stage][chunk][WG_LD_O]
  T* Xs = reinterpret_cast<T*>(Ds + WG_STAGES * WG_CHUNK * WG_LD_O);
  int* Sh = reinterpret_cast<int*>(Xs + WG_STAGES * WG_CHUNK * wg_ld_i<T>());
  int ti = 0;
  while (ti + 1 < tab.n && (int)blockIdx.x >= tab.t[ti + 1].item0) ++ti;
  const WgradTaskT<T>& tk = tab.t[ti];
  const int local = blockIdx.x - tk.item0;
  const int slice = local / tk.tiles, tile = local - slice * tk.tiles;
  const int i0 = tile / tk.tiles_o * WG_TILE;
  const int o0 = tile % tk.tiles_o * WG_TILE;
  const int chunks = (tk.N + WG_CHUNK - 1) / WG_CHUNK;
  const int c0 = (int)((long long)slice * chunks / tk.slices);
  const int c1 = (int)((long long)(slice + 1) * chunks / tk.slices);
  const int n_end = min(c1 * WG_CHUNK, tk.N);
  const bool bias = tk.gb != nullptr;
  const int rows = tk.I + (bias ? 1 : 0);
  const int rows_tile = min(WG_TILE, rows - i0);
  const WgRows xr = wg_rows(tk.X, tk.x_o, tk.x_i, tk.I, tk.n_in, i0,
                            sizeof(T));
  const WgRows dr = wg_rows(tk.DY, tk.y_o, tk.y_i, tk.O, tk.n_in, o0,
                            sizeof(float));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  // the A blocks mi (piece rows = 2 mi + h mod 4) and B blocks ni (piece
  // columns = ni mod 4) holding any row / column inside the tile
  const int mcnt = max(0, min(2, (rows_tile - wm + 1) / 2));
  const int ncnt = max(0, min(4, dr.len - wn));
  const bool dense = rows_tile >= wm + 32 && dr.len >= wn + 32 &&
                     xr.len >= wm + 32 && (sizeof(T) == 4 || xr.vec);
  int amode[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = wm + 4 * g + j;
    amode[j] = m < xr.len ? 1 : (bias && i0 + m == tk.I ? 2 : 0);
  }
  float acc[2][4][4];
#pragma unroll
  for (int q = 0; q < 32; ++q) (&acc[0][0][0])[q] = 0.0f;
  if (xr.fast)  // its rows are never shifted
    for (int q = threadIdx.x; q < WG_STAGES * WG_CHUNK; q += WG_THREADS)
      Sh[q] = 0;

  const int nk = c1 - c0;
  auto load = [&](int c) {
    const int b = c % WG_STAGES, nbase = (c0 + c) * WG_CHUNK;
    wg_load_rows(xr, reinterpret_cast<char*>(Xs + b * WG_CHUNK * wg_ld_i<T>()),
                 wg_ld_i<T>(), Sh + b * WG_CHUNK, nbase, n_end, tk.n_in);
    wg_load_rows(dr, reinterpret_cast<char*>(Ds + b * WG_CHUNK * WG_LD_O),
                 WG_LD_O, nullptr, nbase, n_end, tk.n_in);
  };
#pragma unroll
  for (int c = 0; c < WG_STAGES - 1; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<WG_STAGES - 2>();  // chunk c's copies have landed
    __syncthreads();                 // ... all of them; chunk c-1 is read
    if (c + WG_STAGES - 1 < nk) load(c + WG_STAGES - 1);
    cp_async_commit();
    const int b = c % WG_STAGES;
    if (mcnt > 0 && ncnt > 0) {
      // the chunk's products summed in a fresh fragment, then added to the
      // item's sum in f32 (round to nearest): the tensor cores' own f32
      // accumulation rounds less exactly, and over an item's hundreds of
      // products its error would grow with their number
      float part[2][4][4];
#pragma unroll
      for (int q = 0; q < 32; ++q) (&part[0][0][0])[q] = 0.0f;
      const T* xs = Xs + b * WG_CHUNK * wg_ld_i<T>();
      const float* ds = Ds + b * WG_CHUNK * WG_LD_O;
      if (dense)
        wg_chunk<T, true>(xs, ds, Sh + b * WG_CHUNK, wm, wn, g, t, mcnt,
                          ncnt, amode, part);
      else
        wg_chunk<T, false>(xs, ds, Sh + b * WG_CHUNK, wm, wn, g, t, mcnt,
                           ncnt, amode, part);
#pragma unroll
      for (int q = 0; q < 32; ++q) (&acc[0][0][0])[q] += (&part[0][0][0])[q];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tile goes through it

  float* Es = Ds;  // [WG_TILE][WG_LD_E]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        Es[(wm + 4 * g + 2 * mi + (q >> 1)) * WG_LD_E + wn +
           4 * (2 * t + (q & 1)) + ni] = acc[mi][ni][q];
  __syncthreads();
  float* part = tk.slices > 1 ? tk.ws + (size_t)slice * rows * tk.O : nullptr;
  for (int e = threadIdx.x; e < rows_tile * WG_TILE; e += WG_THREADS) {
    const int r = e / WG_TILE, col = e % WG_TILE;
    if (col >= dr.len) continue;
    const int i = i0 + r, o = o0 + col;
    const float v = Es[r * WG_LD_E + col];
    if (part)
      part[(size_t)i * tk.O + o] = v;
    else if (i < tk.I)
      tk.gW[(size_t)i * tk.O + o] = from_f<T>(v);
    else
      tk.gb[o] = from_f<T>(v);
  }
}

// Pass 2: each element of a cut task, its slices' partials summed in slice
// order in f32 and rounded once to T.
template <typename T>
__global__ void __launch_bounds__(WG_REDUCE_THREADS)
wgrad_reduce_kernel(const __grid_constant__ WgradTable<T> tab, int total) {
  for (int q = blockIdx.x * WG_REDUCE_THREADS + threadIdx.x; q < total;
       q += gridDim.x * WG_REDUCE_THREADS) {
    int ti = 0;
    while (ti + 1 < tab.n && q >= tab.t[ti + 1].elem0) ++ti;
    const WgradTaskT<T>& tk = tab.t[ti];
    const int e = q - tk.elem0;
    const size_t plane = (size_t)(tk.I + (tk.gb ? 1 : 0)) * tk.O;
    float s = tk.ws[e];
    for (int j = 1; j < tk.slices; ++j) s += tk.ws[j * plane + e];
    if (e < tk.I * tk.O)
      tk.gW[e] = from_f<T>(s);
    else
      tk.gb[e - tk.I * tk.O] = from_f<T>(s);
  }
}

template <typename Kern>
cudaError_t prepare_train(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K1 in either mode (see train_fwd_kernel).
template <typename T>
cudaError_t train_fwd(const TrainWeightsT<T>* w, int B, int R,
                      const int* coins, const T* frame_h, const T* x_emb,
                      const int* gt_pitch, const int* gt_dur,
                      float* nums_rows, T* pitch_logits, T* dur_logits,
                      T* summary, int* lengths, int* decisions,
                      const TrainStashT<T>* stash, int logits, void* stream) {
  if (B <= 0 || !(R == 1 || R == 2 || R == 4)) return cudaErrorInvalidValue;
  const size_t bytes = fwd_smem_bytes(*w, R);
  const dim3 grid((B + R - 1) / R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TrainStashT<T> st = {};
  if (stash) st = *stash;
  const int on = stash != nullptr;
  cudaError_t e = cudaSuccess;
#define PCTD_FWD(RR)                                                         \
  e = prepare_train(train_fwd_kernel<RR, T>, bytes);                         \
  if (e == cudaSuccess)                                                      \
    train_fwd_kernel<RR, T><<<grid, NT, bytes, s>>>(                         \
        *w, B, coins, frame_h, x_emb, gt_pitch, gt_dur, nums_rows,           \
        pitch_logits, dur_logits, summary, lengths, decisions, st, on,       \
        logits);
  switch (R) {
    case 1: PCTD_FWD(1) break;
    case 2: PCTD_FWD(2) break;
    default: PCTD_FWD(4) break;
  }
#undef PCTD_FWD
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K2a in either mode (see train_bwd_kernel).
template <typename T>
cudaError_t train_bwd(const TrainWeightsT<T>* w, int B, int R,
                      const int* coins, const int* gt_pitch,
                      const int* gt_dur, const int* lengths,
                      const float* d_nums, const T* d_pitch, const T* d_dur,
                      const T* d_summ, T* d_frame_h, T* d_x_emb,
                      const TrainStashT<T>* stash,
                      const TrainCotangents* cot, int logits, void* stream) {
  if (B <= 0 || !(R == 1 || R == 2 || R == 4) || !stash || !cot)
    return cudaErrorInvalidValue;
  const size_t bytes = bwd_smem_bytes(*w, R);
  const dim3 grid((B + R - 1) / R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
#define PCTD_BWD(RR)                                                         \
  e = prepare_train(train_bwd_kernel<RR, T>, bytes);                         \
  if (e == cudaSuccess)                                                      \
    train_bwd_kernel<RR, T><<<grid, NT, bytes, s>>>(                         \
        *w, B, coins, gt_pitch, gt_dur, lengths, d_nums, d_pitch, d_dur,     \
        d_summ, d_frame_h, d_x_emb, *stash, *cot, logits);
  switch (R) {
    case 1: PCTD_BWD(1) break;
    case 2: PCTD_BWD(2) break;
    default: PCTD_BWD(4) break;
  }
#undef PCTD_BWD
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K2b over n_tasks reductions in table order (see wgrad_kernel), with each
// task's slice count and workspace from the plan; a second launch sums the
// cut tasks' slices.
template <typename T>
cudaError_t train_wgrad(const WgradTaskT<T>* tasks, int n_tasks,
                        void* stream) {
  if (n_tasks <= 0 || n_tasks > MAX_TASKS) return cudaErrorInvalidValue;
  WgradTable<T> tab = {};
  long long items = 0, elems = 0;
  for (int i = 0; i < n_tasks; ++i) {
    WgradTaskT<T> t = tasks[i];
    const int rows = t.I + (t.gb ? 1 : 0);
    if (t.N <= 0 || t.O <= 0 || t.I < 0 || rows <= 0 || t.n_in <= 0 ||
        (t.I > 0 && !t.X) || t.slices < 1 ||
        t.slices > (t.N + WG_CHUNK - 1) / WG_CHUNK ||
        (t.slices > 1) != (t.ws != nullptr))
      return cudaErrorInvalidValue;
    t.tiles_o = (t.O + WG_TILE - 1) / WG_TILE;
    t.tiles = (rows + WG_TILE - 1) / WG_TILE * t.tiles_o;
    t.item0 = (int)items;
    t.elem0 = (int)elems;
    items += (long long)t.tiles * t.slices;
    if (t.slices > 1) elems += (long long)rows * t.O;
    tab.t[i] = t;
  }
  if (items > 0x7fffffff || elems > 0x7fffffff) return cudaErrorInvalidValue;
  tab.n = n_tasks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = wg_smem_bytes<T>();
  cudaError_t e = prepare_train(wgrad_kernel<T>, bytes);
  if (e == cudaSuccess)  // all of the SM's 228 KB to shared memory: 4 blocks
    e = cudaFuncSetAttribute(wgrad_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  wgrad_kernel<T><<<(unsigned)items, WG_THREADS, bytes, s>>>(tab);
  e = cudaGetLastError();
  if (e != cudaSuccess || elems == 0) return e;
  const long long blocks = (elems + WG_REDUCE_THREADS - 1) / WG_REDUCE_THREADS;
  wgrad_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                           WG_REDUCE_THREADS, 0, s>>>(tab, (int)elems);
  return cudaGetLastError();
}

}  // namespace

// The C entry points: one per kernel, mode and storage type (suffix _bf16
// for bfloat16; float otherwise). Shared memory does not depend on the
// storage type (a block keeps its state in f32).
#define PCTD_TRAIN_ENTRIES(T, SFX)                                           \
  /* K1, loss mode: CE numerators per row. */                                \
  int pctd_train_fwd##SFX(const TrainWeightsT<T>* w, int B,                  \
                          int rows_per_block, const int* coins,              \
                          const T* frame_h, const T* x_emb,                  \
                          const int* gt_pitch, const int* gt_dur,            \
                          float* nums_rows, T* summary, int* lengths,        \
                          int* decisions, const TrainStashT<T>* stash,       \
                          void* stream) {                                    \
    return train_fwd<T>(w, B, rows_per_block, coins, frame_h, x_emb,         \
                        gt_pitch, gt_dur, nums_rows, nullptr, nullptr,       \
                        summary, lengths, decisions, stash, 0, stream);      \
  }                                                                          \
  /* K1, logits out. */                                                      \
  int pctd_train_fwd_logits##SFX(                                            \
      const TrainWeightsT<T>* w, int B, int rows_per_block,                  \
      const int* coins, const T* frame_h, const T* x_emb, T* pitch_logits,   \
      T* dur_logits, T* summary, int* lengths, int* decisions,               \
      const TrainStashT<T>* stash, void* stream) {                           \
    return train_fwd<T>(w, B, rows_per_block, coins, frame_h, x_emb,         \
                        nullptr, nullptr, nullptr, pitch_logits, dur_logits, \
                        summary, lengths, decisions, stash, 1, stream);      \
  }                                                                          \
  /* K2a, loss mode: the CE cotangents from the targets and d_nums. */       \
  int pctd_train_bwd##SFX(const TrainWeightsT<T>* w, int B,                  \
                          int rows_per_block, const int* coins,              \
                          const int* gt_pitch, const int* gt_dur,            \
                          const int* lengths, const float* d_nums,           \
                          const T* d_summ, T* d_frame_h, T* d_x_emb,         \
                          const TrainStashT<T>* stash,                       \
                          const TrainCotangents* cot, void* stream) {        \
    return train_bwd<T>(w, B, rows_per_block, coins, gt_pitch, gt_dur,       \
                        lengths, d_nums, nullptr, nullptr, d_summ,           \
                        d_frame_h, d_x_emb, stash, cot, 0, stream);          \
  }                                                                          \
  /* K2a, logits out: the logit cotangents d_pitch and d_dur given. */       \
  int pctd_train_bwd_logits##SFX(                                            \
      const TrainWeightsT<T>* w, int B, int rows_per_block,                  \
      const int* coins, const int* lengths, const T* d_pitch,                \
      const T* d_dur, const T* d_summ, T* d_frame_h, T* d_x_emb,             \
      const TrainStashT<T>* stash, const TrainCotangents* cot,               \
      void* stream) {                                                        \
    return train_bwd<T>(w, B, rows_per_block, coins, nullptr, nullptr,       \
                        lengths, nullptr, d_pitch, d_dur, d_summ, d_frame_h, \
                        d_x_emb, stash, cot, 1, stream);                     \
  }                                                                          \
  /* K2b. */                                                                 \
  int pctd_train_wgrad##SFX(const WgradTaskT<T>* tasks, int n_tasks,         \
                            void* stream) {                                  \
    return train_wgrad<T>(tasks, n_tasks, stream);                           \
  }

// The float entry points are compiled here, the bf16 ones in
// train_frame_bf16.cu, which includes this file: the two instantiations
// build in parallel.
extern "C" {

#ifndef PCTD_TRAIN_BF16
int pctd_train_smem_bytes(const TrainWeightsT<float>* w, int rows_per_block,
                          int backward) {
  return (int)(backward ? bwd_smem_bytes(*w, rows_per_block)
                        : fwd_smem_bytes(*w, rows_per_block));
}

PCTD_TRAIN_ENTRIES(float, )
#else
PCTD_TRAIN_ENTRIES(bf16, _bf16)
#endif

}  // extern "C"
