// Argmax PianoTree decode kernels for Hopper (sm_90a), f32 on CUDA cores.
//
// frame_kernel (K3) replaces pctd_tpu/ops/pallas/ar_decoder.py::_frame_kernel:
//   one frame's 15-slot note chain with argmax feedback, the 5-bit duration
//   chain of every slot, and the masked bi-GRU summary of the predicted notes.
// full_kernel (K4) replaces pctd_tpu/ops/pallas/full_decoder.py::_full_kernel:
//   the whole T-frame decode, time GRU included, straight to the grid.
// Both run the same device functions for the slot chain and the summary
// (frame_body), as the Pallas pair shares _slot_chain/_summary_from_raws.
// Their plain PyTorch versions are frame_decode_plain and
// decode_grid_full_plain (ar_decoder.py, full_decoder.py beside this file).
//
// What bounds them on this card: the decode is a chain of small dependent
// matrix-vector products (per row and frame: 15 slots x [512 -> 1536 and
// 512 -> 388 products + 5 dur steps of 64 -> 194], a 16-step bi-GRU on 128,
// and for K4 a 1024 -> 3072 time GRU), ~50 MFLOP a row a frame over ~30 MB of
// weights. At serving batches the FLOP bound (f32 FMA, 67 TFLOP/s) is a few
// ms; what this design pays instead is weight traffic from L2: each block
// reads every weight once per frame, whatever its row count.
//
// What the design does about it: rows are independent, so a block owns R
// batch rows (R in {1, 2, 4}) and walks frames, slots and dur steps in a
// loop, keeping all per-row state in shared memory. Each weight element it
// reads from L2 feeds R FMAs (R accumulators per thread), and weights are read
// row-major (in, out), neighbouring threads on neighbouring columns, so the
// loads coalesce; narrow products split the input dimension across thread
// groups so more threads issue loads. More rows per block cut L2 traffic,
// more blocks use more SMs; the wrapper picks R from the batch.
//
// Arithmetic is plain f32 (no TF32, no reduced precision): every argmax feeds
// back, so the logits that decide it stay f32. Ties go to the lowest pitch
// index, and a dur bit is logit[1] > logit[0] strictly, as in the JAX package.
// The weight folds and combined-column layouts are the JAX serving path's
// (see ar_decoder.py), so kernel, plain version and JAX package compute the
// same regroupings.
#include "common.cuh"

// Field order matches FoldedWeights and build.Dims (ar_decoder.py, build.py).
struct DecoderWeights {
  const float *w_frame, *b_frame, *b_raw_gi, *w_hh, *b_hh, *w_slot, *b_slot,
      *w_pitch_gi, *w_dur_gi, *gi_tok_sos, *gi_d, *w_dcomb, *b_dcomb, *w_emb,
      *b_emb, *we_ih, *we_hh, *be_ih, *be_hh, *wt_tok, *wt_hh, *bt_hh;
  int TH, NH, DH, E, EH, P, W, K, T, eos;
};

namespace {

// Shared-memory layout of one block, in floats (ints after the floats).
// Every row stride is a multiple of 4 floats so float4 reads stay aligned.
struct Layout {
  int lTH, lHS, l3TH, lYF, l3NH, lSL, lDH, lDC, lE, l3EH;
  int o_htime, o_hs, o_git, o_ght, o_yf, o_gh, o_acc, o_Y, o_hd, o_X, o_xs,
      o_sg, o_red, n_floats, n_ints;
};

__host__ __device__ inline Layout make_layout(const DecoderWeights& w, int R) {
  Layout L;
  L.lTH = pad4(w.TH);
  L.lHS = pad4(2 * w.EH);
  L.l3TH = pad4(3 * w.TH);
  L.lYF = pad4(4 * w.NH);
  L.l3NH = pad4(3 * w.NH);
  L.lSL = pad4(w.P + w.DH + 2 + 3 * w.DH);
  L.lDH = pad4(w.DH);
  L.lDC = pad4(2 + 3 * w.DH);
  L.lE = pad4(w.E);
  L.l3EH = pad4(3 * w.EH);
  int o = 0;
  L.o_htime = o;  o += R * L.lTH;   // time hidden (persistent)
  L.o_hs = o;     o += R * L.lHS;   // [hf | hb] summary = next time token
  // union: the time-GRU phase and the frame phase never overlap
  int u = o;
  L.o_git = u;
  L.o_ght = u + R * L.l3TH;
  int time_end = u + 2 * R * L.l3TH;
  int f = u;
  L.o_yf = f;   f += R * L.lYF;      // [hid/h | gi_frame]
  L.o_gh = f;   f += R * L.l3NH;     // notes-GRU hidden gates
  L.o_acc = f;  f += R * L.l3NH;     // folded token feedback (gi_tok)
  L.o_Y = f;    f += R * L.lSL;      // [pitch logits | h_d0 | X0]
  L.o_hd = f;   f += R * L.lDH;      // dur hidden
  L.o_X = f;    f += R * L.lDC;      // [dur logit | dur gates]
  L.o_xs = f;   f += R * 2 * L.lE;   // summary inputs [fwd | bwd]
  L.o_sg = f;   f += R * 4 * L.l3EH; // summary [gi_f | gh_f | gi_b | gh_b]
  o = time_end > f ? time_end : f;
  L.o_red = o;  o += NT * R;         // split-K partial sums
  L.n_floats = o;
  L.n_ints = R * ((w.K - 1) * (1 + w.W) + 1);
  return L;
}

__host__ inline size_t smem_bytes(const DecoderWeights& w, int R) {
  Layout L = make_layout(w, R);
  return sizeof(float) * (size_t)L.n_floats + sizeof(int) * (size_t)L.n_ints;
}

struct Smem {
  float *h_time, *hs, *git, *ght, *yf, *gh, *acc, *Y, *hd, *X, *xs, *sg, *red;
  int *pitch, *bits, *len;
};

__device__ inline Smem carve(const Layout& L, float* base, int R,
                             const DecoderWeights& w) {
  Smem s;
  s.h_time = base + L.o_htime;
  s.hs = base + L.o_hs;
  s.git = base + L.o_git;
  s.ght = base + L.o_ght;
  s.yf = base + L.o_yf;
  s.gh = base + L.o_gh;
  s.acc = base + L.o_acc;
  s.Y = base + L.o_Y;
  s.hd = base + L.o_hd;
  s.X = base + L.o_X;
  s.xs = base + L.o_xs;
  s.sg = base + L.o_sg;
  s.red = base + L.o_red;
  int* ib = reinterpret_cast<int*>(base + L.n_floats);
  s.pitch = ib;                         // [R][K-1]
  s.bits = ib + R * (w.K - 1);          // [R][K-1][W]
  s.len = s.bits + R * (w.K - 1) * w.W; // [R]
  return s;
}

// One frame from s.yf = [hid | gi_frame + b_raw_gi]: the serial slot chain
// (pitch/bits/len into shared ints) and the masked bi-GRU summary into s.hs.
// sos_emb holds this block's rows (nrows valid).
template <int R>
__device__ void frame_body(const DecoderWeights& w, const Layout& L,
                           const Smem& s, const float* sos_emb, int nrows) {
  const int t = threadIdx.x;
  const int NH = w.NH, NH3 = 3 * w.NH, DH = w.DH, P = w.P, W = w.W,
            K = w.K, E = w.E, EH = w.EH, EH3 = 3 * w.EH;
  const int SL = P + DH + 2 + 3 * DH, DC = 2 + 3 * DH;
  float* h = s.yf;              // slot hidden, row stride lYF
  const float* gif = s.yf + NH; // frame share of the notes-GRU gi

  for (int idx = t; idx < R * NH3; idx += NT) {
    const int r = idx / NH3, j = idx - r * NH3;
    s.acc[r * L.l3NH + j] = __ldg(w.gi_tok_sos + j);
  }
  if (t < R) s.len[t] = 0;
  matvec<R>(w.w_hh, w.b_hh, NH, NH3, h, L.lYF, s.gh, L.l3NH, s.red);
  __syncthreads();

  for (int k = 1; k < K; ++k) {
    // notes-GRU step: h = gates(gi_frame + gi_tok, gh, h)
    for (int idx = t; idx < R * NH; idx += NT) {
      const int r = idx / NH, j = idx - r * NH;
      const float* g = gif + r * L.lYF;
      const float* a = s.acc + r * L.l3NH;
      const float* hh = s.gh + r * L.l3NH;
      float ir = g[j] + a[j], iz = g[NH + j] + a[NH + j],
            in_ = g[2 * NH + j] + a[2 * NH + j];
      float rr = sigmoid_(ir + hh[j]);
      float zz = sigmoid_(iz + hh[NH + j]);
      float nn = tanhf(in_ + rr * hh[2 * NH + j]);
      float hv = h[r * L.lYF + j];
      h[r * L.lYF + j] = (1.0f - zz) * nn + zz * hv;
    }
    __syncthreads();
    // [pitch logits | dur-hid init | first dur projection], then the next
    // slot's hidden gates
    matvec<R>(w.w_slot, w.b_slot, NH, SL, h, L.lYF, s.Y, L.lSL, s.red);
    matvec<R>(w.w_hh, w.b_hh, NH, NH3, h, L.lYF, s.gh, L.l3NH, s.red);
    __syncthreads();
    // pitch argmax (warp r takes row r; ties to the lowest index) and the
    // first dur step's gates from the sos gi
    const int warp = t >> 5, lane = t & 31;
    if (warp < R) {
      const float* y = s.Y + warp * L.lSL;
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
      if (lane == 0) {
        if (bi >= P) bi = 0;
        s.pitch[warp * (K - 1) + k - 1] = bi;
        if (bi == w.eos && s.len[warp] == 0) s.len[warp] = k;
      }
    }
    for (int idx = t; idx < R * DH; idx += NT) {
      const int r = idx / DH, j = idx - r * DH;
      const float* y = s.Y + r * L.lSL;
      s.hd[r * L.lDH + j] = gru_gate(w.gi_d, y + P + DH + 2, DH, j, y[P + j]);
    }
    __syncthreads();
    // token feedback seeded with the pitch row (a row select of the
    // one-hot product)
    for (int idx = t; idx < R * NH3; idx += NT) {
      const int r = idx / NH3, j = idx - r * NH3;
      const int pi = s.pitch[r * (K - 1) + k - 1];
      s.acc[r * L.l3NH + j] = __ldg(w.w_pitch_gi + (size_t)pi * NH3 + j);
    }
    for (int ws = 0; ws < W; ++ws) {
      matvec<R>(w.w_dcomb, w.b_dcomb, DH, DC, s.hd, L.lDH, s.X, L.lDC,
                s.red);
      __syncthreads();
      for (int idx = t; idx < R * NH3; idx += NT) {
        const int r = idx / NH3, j = idx - r * NH3;
        const float* x = s.X + r * L.lDC;
        const float bitf = x[1] > x[0] ? 1.0f : 0.0f;
        s.acc[r * L.l3NH + j] += bitf * __ldg(w.w_dur_gi + ws * NH3 + j);
      }
      if (t < R) {
        const float* x = s.X + t * L.lDC;
        s.bits[(t * (K - 1) + k - 1) * W + ws] = x[1] > x[0] ? 1 : 0;
      }
      if (ws + 1 < W) {
        for (int idx = t; idx < R * DH; idx += NT) {
          const int r = idx / DH, j = idx - r * DH;
          const float* x = s.X + r * L.lDC;
          const float* gid = w.gi_d + (x[1] > x[0] ? 2 : 1) * 3 * DH;
          s.hd[r * L.lDH + j] =
              gru_gate(gid, x + 2, DH, j, s.hd[r * L.lDH + j]);
        }
      }
      __syncthreads();
    }
  }
  if (t < R && s.len[t] == 0) s.len[t] = K - 1;
  for (int idx = t; idx < R * 2 * EH; idx += NT) {
    const int r = idx / (2 * EH), j = idx - r * 2 * EH;
    s.hs[r * L.lHS + j] = 0.0f;
  }
  __syncthreads();

  // masked bi-GRU over [sos | 15 predicted notes]: step k runs slot k
  // forward and slot K-1-k backward
  for (int k = 0; k < K; ++k) {
    for (int idx = t; idx < R * 2 * E; idx += NT) {
      const int r = idx / (2 * E), rem = idx - r * 2 * E;
      const int d = rem / E, e = rem - d * E;
      const int slot = d == 0 ? k : K - 1 - k;
      float v;
      if (slot == 0) {
        v = r < nrows ? sos_emb[r * E + e] : 0.0f;
      } else {
        const int q = r * (K - 1) + slot - 1;
        v = __ldg(w.w_emb + (size_t)s.pitch[q] * E + e);
        for (int ws = 0; ws < W; ++ws)
          if (s.bits[q * W + ws]) v += __ldg(w.w_emb + (size_t)(P + ws) * E + e);
        v += __ldg(w.b_emb + e);
      }
      s.xs[r * 2 * L.lE + d * L.lE + e] = v;
    }
    __syncthreads();
    const int ldg = 4 * L.l3EH;
    matvec<R>(w.we_ih, w.be_ih, E, EH3, s.xs, 2 * L.lE, s.sg, ldg, s.red);
    matvec<R>(w.we_hh, w.be_hh, EH, EH3, s.hs, L.lHS, s.sg + L.l3EH, ldg,
              s.red);
    matvec<R>(w.we_ih + (size_t)E * EH3, w.be_ih + EH3, E, EH3, s.xs + L.lE,
              2 * L.lE, s.sg + 2 * L.l3EH, ldg, s.red);
    matvec<R>(w.we_hh + (size_t)EH * EH3, w.be_hh + EH3, EH, EH3,
              s.hs + EH, L.lHS, s.sg + 3 * L.l3EH, ldg, s.red);
    __syncthreads();
    for (int idx = t; idx < R * 2 * EH; idx += NT) {
      const int r = idx / (2 * EH), rem = idx - r * 2 * EH;
      const int d = rem / EH, j = rem - d * EH;
      const int slot = d == 0 ? k : K - 1 - k;
      if (slot < s.len[r]) {
        const float* g = s.sg + r * ldg + 2 * d * L.l3EH;
        float* hv = s.hs + r * L.lHS + d * EH + j;
        *hv = gru_gate(g, g + L.l3EH, EH, j, *hv);
      }
    }
    __syncthreads();
  }
}

// s.yf = h_time @ w_frame + b_frame, then the token-bias share of gi.
template <int R>
__device__ void frame_projection(const DecoderWeights& w, const Layout& L,
                                 const Smem& s) {
  const int NH = w.NH, NH3 = 3 * w.NH;
  matvec<R>(w.w_frame, w.b_frame, w.TH, 4 * NH, s.h_time, L.lTH, s.yf, L.lYF,
            s.red);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * NH3; idx += NT) {
    const int r = idx / NH3, j = idx - r * NH3;
    s.yf[r * L.lYF + NH + j] += __ldg(w.b_raw_gi + j);
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
frame_kernel(DecoderWeights w, int B, const float* __restrict__ h_time,
             const float* __restrict__ sos_emb, int* __restrict__ pitch_idx,
             int* __restrict__ dur_bits, float* __restrict__ summary,
             int* __restrict__ lengths) {
  extern __shared__ float4 smem4[];
  const Layout L = make_layout(w, R);
  const Smem s = carve(L, reinterpret_cast<float*>(smem4), R, w);
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int TH = w.TH, K = w.K, W = w.W, EH2 = 2 * w.EH;
  for (int idx = threadIdx.x; idx < R * TH; idx += NT) {
    const int r = idx / TH, j = idx - r * TH;
    s.h_time[r * L.lTH + j] =
        r < nrows ? h_time[(size_t)(row0 + r) * TH + j] : 0.0f;
  }
  __syncthreads();
  frame_projection<R>(w, L, s);
  frame_body<R>(w, L, s, sos_emb + (size_t)row0 * w.E, nrows);
  for (int idx = threadIdx.x; idx < nrows * (K - 1); idx += NT) {
    const int r = idx / (K - 1), k = idx - r * (K - 1);
    pitch_idx[(size_t)(row0 + r) * (K - 1) + k] = s.pitch[r * (K - 1) + k];
  }
  for (int idx = threadIdx.x; idx < nrows * (K - 1) * W; idx += NT) {
    const int r = idx / ((K - 1) * W), q = idx - r * (K - 1) * W;
    dur_bits[(size_t)(row0 + r) * (K - 1) * W + q] = s.bits[r * (K - 1) * W + q];
  }
  for (int idx = threadIdx.x; idx < nrows * EH2; idx += NT) {
    const int r = idx / EH2, j = idx - r * EH2;
    summary[(size_t)(row0 + r) * EH2 + j] = s.hs[r * L.lHS + j];
  }
  if (threadIdx.x < nrows) lengths[row0 + threadIdx.x] = s.len[threadIdx.x];
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
full_kernel(DecoderWeights w, int B, const float* __restrict__ h0,
            const float* __restrict__ gi_z, const float* __restrict__ token0,
            const float* __restrict__ sos_emb, int* __restrict__ grid) {
  extern __shared__ float4 smem4[];
  const Layout L = make_layout(w, R);
  const Smem s = carve(L, reinterpret_cast<float*>(smem4), R, w);
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int TH = w.TH, TH3 = 3 * w.TH, K = w.K, W = w.W, EH2 = 2 * w.EH;
  const int cell = 1 + W;
  for (int idx = t; idx < R * TH; idx += NT) {
    const int r = idx / TH, j = idx - r * TH;
    s.h_time[r * L.lTH + j] = r < nrows ? h0[(size_t)(row0 + r) * TH + j] : 0.0f;
  }
  for (int idx = t; idx < R * EH2; idx += NT) {
    const int r = idx / EH2, j = idx - r * EH2;
    s.hs[r * L.lHS + j] = r < nrows ? token0[(size_t)(row0 + r) * EH2 + j] : 0.0f;
  }
  __syncthreads();
  for (int ti = 0; ti < w.T; ++ti) {
    // time GRU: gi = gi_z + token @ wt_tok, gh = h @ wt_hh + bt_hh
    matvec<R>(w.wt_tok, nullptr, EH2, TH3, s.hs, L.lHS, s.git, L.l3TH, s.red);
    matvec<R>(w.wt_hh, w.bt_hh, TH, TH3, s.h_time, L.lTH, s.ght, L.l3TH,
              s.red);
    __syncthreads();
    for (int idx = t; idx < R * TH; idx += NT) {
      const int r = idx / TH, j = idx - r * TH;
      const float* gz = gi_z + (size_t)(row0 + (r < nrows ? r : 0)) * TH3;
      const float zr = r < nrows ? 1.0f : 0.0f;
      const float* gt = s.git + r * L.l3TH;
      const float* gh = s.ght + r * L.l3TH;
      float ir = zr * gz[j] + gt[j], iz = zr * gz[TH + j] + gt[TH + j],
            in_ = zr * gz[2 * TH + j] + gt[2 * TH + j];
      float rr = sigmoid_(ir + gh[j]);
      float zz = sigmoid_(iz + gh[TH + j]);
      float nn = tanhf(in_ + rr * gh[2 * TH + j]);
      float hv = s.h_time[r * L.lTH + j];
      s.h_time[r * L.lTH + j] = (1.0f - zz) * nn + zz * hv;
    }
    __syncthreads();
    frame_projection<R>(w, L, s);
    frame_body<R>(w, L, s, sos_emb + (size_t)row0 * w.E, nrows);
    // grid (B, T, K-1, 1+W) = [pitch | dur bits] per slot
    for (int idx = t; idx < nrows * (K - 1) * cell; idx += NT) {
      const int r = idx / ((K - 1) * cell), q = idx - r * (K - 1) * cell;
      const int k = q / cell, c = q - k * cell;
      const int v = c == 0 ? s.pitch[r * (K - 1) + k]
                           : s.bits[(r * (K - 1) + k) * W + c - 1];
      grid[(((size_t)(row0 + r) * w.T + ti) * (K - 1) + k) * cell + c] = v;
    }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* pctd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pctd_smem_bytes(const DecoderWeights* w, int rows_per_block) {
  return (int)smem_bytes(*w, rows_per_block);
}

int pctd_frame_decode(const DecoderWeights* w, int B, int rows_per_block,
                      const float* h_time, const float* sos_emb,
                      int* pitch_idx, int* dur_bits, float* summary,
                      int* lengths, void* stream) {
  const int R = rows_per_block;
  if (B <= 0 || !(R == 1 || R == 2 || R == 4)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(*w, R);
  const dim3 grid((B + R - 1) / R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  switch (R) {
    case 1:
      e = prepare(frame_kernel<1>, bytes);
      if (e == cudaSuccess)
        frame_kernel<1><<<grid, NT, bytes, st>>>(*w, B, h_time, sos_emb,
                                                 pitch_idx, dur_bits, summary,
                                                 lengths);
      break;
    case 2:
      e = prepare(frame_kernel<2>, bytes);
      if (e == cudaSuccess)
        frame_kernel<2><<<grid, NT, bytes, st>>>(*w, B, h_time, sos_emb,
                                                 pitch_idx, dur_bits, summary,
                                                 lengths);
      break;
    default:
      e = prepare(frame_kernel<4>, bytes);
      if (e == cudaSuccess)
        frame_kernel<4><<<grid, NT, bytes, st>>>(*w, B, h_time, sos_emb,
                                                 pitch_idx, dur_bits, summary,
                                                 lengths);
      break;
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

int pctd_full_decode(const DecoderWeights* w, int B, int rows_per_block,
                     const float* h0, const float* gi_z, const float* token0,
                     const float* sos_emb, int* grid_out, void* stream) {
  const int R = rows_per_block;
  if (B <= 0 || !(R == 1 || R == 2 || R == 4)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(*w, R);
  const dim3 grid((B + R - 1) / R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  switch (R) {
    case 1:
      e = prepare(full_kernel<1>, bytes);
      if (e == cudaSuccess)
        full_kernel<1><<<grid, NT, bytes, st>>>(*w, B, h0, gi_z, token0,
                                                sos_emb, grid_out);
      break;
    case 2:
      e = prepare(full_kernel<2>, bytes);
      if (e == cudaSuccess)
        full_kernel<2><<<grid, NT, bytes, st>>>(*w, B, h0, gi_z, token0,
                                                sos_emb, grid_out);
      break;
    default:
      e = prepare(full_kernel<4>, bytes);
      if (e == cudaSuccess)
        full_kernel<4><<<grid, NT, bytes, st>>>(*w, B, h0, gi_z, token0,
                                                sos_emb, grid_out);
      break;
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
