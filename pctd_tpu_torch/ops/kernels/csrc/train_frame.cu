// Teacher-forced frame kernels of the training step for Hopper (sm_90a),
// f32 arithmetic on CUDA cores, in two storage types (float and bf16).
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
// (autograd of them for K2).
//
// What bounds them on this card: like the serving kernels (decoder.cu),
// K1 and K2a are chains of small dependent matrix-vector products, ~45
// MFLOP a row a frame each over ~30 MB of weights that every block reads
// from L2; at training batches the f32 FLOP bound is a few ms a step, and
// what the design pays is the per-block weight traffic. K2b is a plain
// f32 reduction of ~6 GFLOP a frame at B=128, bound by operations.
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
// Arithmetic is plain f32 FMA (no TF32). Ties of the pitch argmax go to the
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
// the bf16 mode reads half the weight bytes from L2 and does the same f32
// FMAs; the card's bf16 tensor-core peak is not used by these CUDA-core
// kernels.
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

// Field order matches WgradTask (train_frame.py) plus the tile bookkeeping.
// X (stash rows) and the gradients gW, gb are of the storage type T, the
// cotangents DY f32.
template <typename T>
struct WgradTaskT {
  const T* X;
  const float* DY;
  T *gW, *gb;
  int N, I, O, n_in;
  long long x_o, x_i, y_o, y_i;
  int tiles_o, tile0;
};

using bf16 = __nv_bfloat16;

namespace {

constexpr int MAX_TASKS = 20;
constexpr int WG_TILE = 64;   // wgrad output tile (rows of gW x columns)
constexpr int WG_CHUNK = 16;  // samples a tile step reads
constexpr int WG_THREADS = 256;

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

__device__ __forceinline__ size_t sample_row(int n, int n_in, long long o,
                                             long long i) {
  return (size_t)((n / n_in) * o + (n % n_in) * i);
}

template <typename Ts>
__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const __grid_constant__ WgradTable<Ts> tab) {
  __shared__ __align__(16) float Xs[WG_CHUNK][WG_TILE];
  __shared__ __align__(16) float Ds[WG_CHUNK][WG_TILE];
  int ti = 0;
  while (ti + 1 < tab.n && (int)blockIdx.x >= tab.t[ti + 1].tile0) ++ti;
  const WgradTaskT<Ts>& T = tab.t[ti];
  const int local = blockIdx.x - T.tile0;
  const int i0 = (local / T.tiles_o) * WG_TILE;
  const int o0 = (local % T.tiles_o) * WG_TILE;
  const bool bias = T.gb != nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  for (int n0 = 0; n0 < T.N; n0 += WG_CHUNK) {
    for (int q = threadIdx.x; q < WG_CHUNK * WG_TILE; q += WG_THREADS) {
      const int nn = q / WG_TILE, c = q - nn * WG_TILE;
      const int n = n0 + nn, i = i0 + c, o = o0 + c;
      float xv = 0.0f, dv = 0.0f;
      if (n < T.N) {
        if (i < T.I)
          xv = to_f(T.X[sample_row(n, T.n_in, T.x_o, T.x_i) + i]);
        else if (i == T.I && bias)
          xv = 1.0f;
        if (o < T.O) dv = T.DY[sample_row(n, T.n_in, T.y_o, T.y_i) + o];
      }
      Xs[nn][c] = xv;
      Ds[nn][c] = dv;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < WG_CHUNK; ++nn) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[nn][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ds[nn][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + tx * 4 + q;
      if (o >= T.O) continue;
      if (i < T.I)
        T.gW[(size_t)i * T.O + o] = from_f<Ts>(acc[p][q]);
      else if (i == T.I && bias)
        T.gb[o] = from_f<Ts>(acc[p][q]);
    }
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

// K2b over n_tasks reductions (see wgrad_kernel).
template <typename T>
cudaError_t train_wgrad(const WgradTaskT<T>* tasks, int n_tasks,
                        void* stream) {
  if (n_tasks <= 0 || n_tasks > MAX_TASKS) return cudaErrorInvalidValue;
  WgradTable<T> tab = {};
  int tiles = 0;
  for (int i = 0; i < n_tasks; ++i) {
    WgradTaskT<T> t = tasks[i];
    if (t.N <= 0 || t.O <= 0 || t.I < 0 || t.n_in <= 0)
      return cudaErrorInvalidValue;
    const int rows = t.I + (t.gb ? 1 : 0);
    t.tiles_o = (t.O + WG_TILE - 1) / WG_TILE;
    t.tile0 = tiles;
    tiles += ((rows + WG_TILE - 1) / WG_TILE) * t.tiles_o;
    tab.t[i] = t;
  }
  tab.n = n_tasks;
  wgrad_kernel<T><<<tiles, WG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tab);
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
