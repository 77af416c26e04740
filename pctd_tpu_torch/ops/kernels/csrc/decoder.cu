// Argmax PianoTree decode kernels for Hopper (sm_90a), f32 on CUDA cores.
//
// K3 replaces pctd_tpu/ops/pallas/ar_decoder.py::_frame_kernel: one frame's
//   15-slot note chain with argmax feedback, the 5-bit duration chain of
//   every slot, and the masked bi-GRU summary of the predicted notes. It is
//   a template on the storage type S of the weights, the time hidden, the
//   sos embedding and the summary: float, or __nv_bfloat16 for the bf16 mode
//   (compiled in decoder_bf16.cu).
// K4 replaces pctd_tpu/ops/pallas/full_decoder.py::_full_kernel: the whole
//   T-frame decode, time GRU included, straight to the grid (float only).
// Both run the same device functions for the frame (the projection, the
// slot chain and the summary), as the Pallas pair shares
// _slot_chain/_summary_from_raws. Their plain PyTorch versions are
// frame_decode_plain and decode_grid_full_plain (ar_decoder.py,
// full_decoder.py beside this file).
//
// What bounds them on this card: the decode is a chain of small dependent
// matrix-vector products (per row and frame: 16 products 512 -> 1536 with
// w_hh, 15 of 512 -> 388 with w_slot, 75 duration steps 64 -> 194, a
// 16-step bi-GRU on 128, and for K4 a 1024 -> 3072 time GRU), ~45 MFLOP a
// row a frame over ~30 MB of weights, ~87 MB read a row a frame (103 MB in
// K4) counting each weight as often as the chain reads it. The FLOP bound
// is a few hundredths of a ms at serving batches. A block that reads every
// weight for its own few rows is bound by that L2 stream (the per-row
// design these kernels replaced; PERF.md keeps its times); a cluster that
// shares each read among 16 rows is bound by its serial chain instead: each
// slot's products wait on dependent rounds of weight loads, and every
// exchange waits on a cluster barrier.
//
// Row groups (frame_group_kernel, K3; full_group_kernel, K4). A
// thread-block cluster of C blocks (16, or 8 where the launch would
// not fit the card at once; the plan is build.decode_plan) decodes a group
// of DG = 16 rows, so every weight element read from L2 feeds 16 FMAs.
// Each block owns a 1/C share of every product's output columns: NH / C
// notes-GRU units (their w_hh columns and gate math), SL / C columns of
// w_slot, TH / C time-GRU units (K4), and, per summary direction, EH / (C /
// 2) units on half of the cluster's blocks. A block multiplies the group's
// whole input (its 16 rows, in shared memory) by its columns, splitting k
// over threads so that ~all 512 take part (group_product), and pushes the
// outputs that other blocks need into their shared memory (distributed
// shared memory), then a cluster barrier: the new hidden state into every
// block; a slot's logits and duration projections into the block that owns
// the row (row r: block r % C), which runs the pitch argmax and the 5-step
// duration chain (w_dcomb staged in shared memory) and pushes
// the decisions into every block; each block then folds the token feedback
// of its own columns. Three cluster barriers a slot, one a summary step.
//
// The summary bi-GRU (group_summary) is bound by its 16 serial steps. Only
// h @ we_hh depends on the step before; a step that also gathered its note
// embeddings and multiplied [x | h] by [we_ih | we_hh] read from L2 would
// wait on dependent rounds of L2 loads and two block barriers besides its
// cluster barrier. So it runs as K1's summary does (train_frame.cu): each
// block first computes the input projections of a chunk of steps (x @
// we_ih + be_ih, its columns of we_ih staged in shared memory, the
// embeddings of Kx steps a product, all off the serial path), then runs
// the chunk's steps on we_hh alone, staged in the same place: a 16-row
// product from shared memory, the gate, the new hidden into the
// direction's blocks and one cluster barrier a step. The chunk is as many
// steps as the block's memory holds once the note chain is over (its
// region and w_dcomb's, which K4 stages again each frame by asynchronous
// copies behind the time step; group_layout): in K4 all 16 in clusters of
// 16, 8 in clusters of 8. What bounds it then is the shared-memory
// bandwidth and latency of those products (each lane's k-slice is fixed:
// the products keep group_product's lanes and k-slices, so the sums are
// the same bits as one product of a step's x @ we_ih and h @ we_hh) and
// the cluster barriers.
//
// The layout lives in static shared memory, and each phase carves the
// pointers it uses from it (group_carve): held in registers for the whole
// launch, the layout and pointers get spilled to local memory, which the
// ~28 KB of L1 beside the block's shared memory does not hold, so every
// phase would wait on their reloads from L2.
//
// Arithmetic is plain f32 FMA (no TF32, no reduced precision): every argmax
// feeds back, so the logits that decide it stay f32; sums run in a fixed
// order, so two launches give the same bits. Ties go to the lowest pitch
// index, and a dur bit is logit[1] > logit[0] strictly, as in the JAX
// package. The weight folds and combined-column layouts are the JAX serving
// path's (see ar_decoder.py), so kernel, plain version and JAX package
// compute the same regroupings.
//
// K3's bf16 mode is the Pallas kernel run on bf16 params and inputs: every
// product there is a dot with preferred_element_type=f32, and an f32 value
// times a bf16 weight is f32, so the arithmetic and all per-row state stay
// f32 (a bf16 load converts exactly; each FMA is as in the float mode). The
// two folded constants are f32 in either mode (gi_tok_sos, and gi_d: the
// f32 sos row and the dur-GRU feedback rows w_dih[b] + b_dih, which the
// wrapper rounds to bf16 as the Pallas bf16 + bf16 sum does). The one
// rounding inside the kernel is the summary, stored as bf16.
#include <cooperative_groups.h>

#include "common.cuh"
#include "group.cuh"

namespace cg = cooperative_groups;

// Field order matches FoldedWeights and build.Dims (ar_decoder.py, build.py).
// S is the storage type of the weights; gi_tok_sos and gi_d are f32 in either.
template <typename S>
struct DecoderWeightsT {
  const S *w_frame, *b_frame, *b_raw_gi, *w_hh, *b_hh, *w_slot, *b_slot,
      *w_pitch_gi, *w_dur_gi;
  const float *gi_tok_sos, *gi_d;
  const S *w_dcomb, *b_dcomb, *w_emb, *b_emb, *we_ih, *we_hh, *be_ih, *be_hh,
      *wt_tok, *wt_hh, *bt_hh;
  int TH, NH, DH, E, EH, P, W, K, T, eos;
};
using DecoderWeights = DecoderWeightsT<float>;

// the dynamic shared memory of a row-group block
extern __shared__ float4 group_smem[];

namespace {

// The lanes a unit of a summary product: group_product's rule for a step's
// six segments together (x @ we_ih and h @ we_hh, three gates of SU
// columns each), for the hoisted products and the recurrent ones alike, so
// that the k order of every sum is the step's and not the batching's.
__host__ __device__ inline int summary_lanes(int SU) {
  const int nq = 6 * (DG / PR) * (SU / PJ);
  int sl = 1;
  while (sl < 8 && nq * sl * 2 <= NT) sl *= 2;
  return sl;
}

// group_product's k-slice of a lane: a multiple of 4 whose count of 16-byte
// words is odd
__host__ __device__ inline int slice_width(int in, int sl) {
  int kc = (cdiv(in, sl) + 3) & ~3;
  if (!(kc & 4)) kc += 4;
  return kc;
}

constexpr int SPAD_MAX = 7 * 128;  // bytes between a staged weight's slices
constexpr int XB = 8;    // a batch's embeddings a thread
constexpr int WMAX = 8;  // duration bits a note: a byte of mask
// dynamic shared memory a block: the layout takes the static part (see the
// note at the top)
constexpr int GROUP_MAX_SMEM = DEC_MAX_SMEM - 256;

// Shared memory of a row-group block, offsets in bytes. Kept for the
// launch: ht, tok (K4), the owned rows' slot projections Y, the staged
// constants (w_dur_gi's columns, w_emb's bit rows and b_emb, b_dcomb,
// gi_d), the owned rows' decisions and the group's lengths, pitches and
// bits. Written by other blocks: ht (K4), tok (K4), hf, Y, pitch, bits, and
// the summary planes hsd. Then one region, phase by phase (a cluster
// barrier separates the phases, so no block writes into a region that
// another still reads): the note chain's (the notes hidden hf, its locals
// gif, gh, acc, ys, hd, X, red, or K4's time gates tg over them, then
// w_dcomb in the weights' storage type), then, from the chain's last
// barrier on, the summary's: the direction's two hidden planes, this
// block's biases, its staged summary weights (we_ih, then we_hh), the
// hoisted input projections of Kc steps, and a batch of Kx steps'
// embeddings (or, in a recurrent step, its hidden gates). w_dcomb is staged
// again each frame.
struct GLayout {
  int C, nro, U, TU, SU, SLc, Kc, Kx;
  int lTH, lHS, lNH, lSL, lDH, lDC, lE, lEH, lU3, lT6, lS3, lSLc;
  int o_ht, o_tok, o_Y, o_wdg, o_emb, o_dc, o_own, o_pitch, o_bits;
  int o_hf, o_gif, o_gh, o_acc, o_ys, o_hd, o_X, o_red, o_tg, o_wd;
  int o_hsd, o_sb, o_mask, o_ws, o_gis, o_xs, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

template <typename S>
__host__ __device__ inline GLayout group_layout(const DecoderWeightsT<S>& w,
                                                int C, bool full) {
  GLayout L;
  const int SL = w.P + w.DH + 2 + 3 * w.DH, DC = 2 + 3 * w.DH, S1 = w.K - 1;
  const int ts = (int)sizeof(S);
  L.C = C;
  L.nro = DG / C;
  L.U = 4 * cdiv(w.NH / 4, C);   // the largest share of each partition
  L.TU = 4 * cdiv(w.TH / 4, C);
  L.SU = 4 * cdiv(w.EH / 4, C / 2);
  L.SLc = 4 * cdiv(SL / 4, C);
  L.lTH = pad4(w.TH);
  L.lHS = pad4(2 * w.EH);
  L.lNH = pad4(w.NH);
  L.lSL = pad4(SL);
  L.lDH = pad4(w.DH);
  L.lDC = pad4(DC);
  L.lE = pad4(w.E);
  L.lEH = pad4(w.EH);
  L.lU3 = pad4(3 * L.U);
  L.lT6 = pad4(6 * L.TU);
  L.lS3 = pad4(3 * L.SU);
  L.lSLc = pad4(L.SLc);
  int b = 0;
  L.o_ht = b;    b += 4 * DG * L.lTH;     // time hidden of the group's rows
  L.o_tok = b;                            // K4: summary token [hf | hb]
  if (full) b += 4 * DG * L.lHS;
  L.o_Y = b;     b += 4 * L.nro * L.lSL;  // owned rows' slot projections
  L.o_wdg = b;   b += 4 * w.W * L.lU3;    // w_dur_gi, this block's columns
  L.o_emb = b;   b += 4 * (w.W + 1) * L.lE;  // w_emb's bit rows, then b_emb
  L.o_dc = b;    b += 4 * (L.lDC + 9 * L.lDH);  // b_dcomb, gi_d's 3 x 3 rows
  L.o_own = b;   b += 4 * (L.nro * (1 + w.W) + DG);  // owned decisions, len
  L.o_pitch = b; b += 2 * DG * S1;                   // short [DG][K-1]
  L.o_bits = b;  b += DG * S1 * w.W;                 // uchar [DG][K-1][W]
  const int region = b = align16(b);
  L.o_hf = b;    b += 4 * DG * L.lNH;     // notes hidden
  int u = b;                              // the note chain's locals
  L.o_gif = u;   u += 4 * DG * L.lU3;     // frame share of gi (own units)
  L.o_gh = u;    u += 4 * DG * L.lU3;     // hidden gates (own units)
  L.o_acc = u;   u += 4 * DG * L.lU3;     // folded token feedback (own units)
  L.o_ys = u;    u += 4 * DG * L.lSLc;    // own w_slot columns
  L.o_hd = u;    u += 4 * L.nro * L.lDH;  // owned rows' dur hidden
  L.o_X = u;     u += 4 * L.nro * L.lDC;  // owned rows' [dur logits | gates]
  L.o_red = u;   u += 4 * L.nro * NT;     // dur_product's partial sums
  L.o_tg = b;                             // K4: time gates [gi | gh]
  if (full) u = imax2(u, b + 4 * DG * L.lT6);
  L.o_wd = align16(u);
  const int chain_end = L.o_wd + w.DH * DC * ts;
  b = region;                             // the summary
  L.o_hsd = b;   b += 4 * 2 * DG * L.lEH;  // two planes of a direction's hidden
  L.o_sb = b;    b += 4 * 2 * L.lS3;      // be_ih, be_hh (own units)
  L.o_mask = b;  b += align16(DG * S1);   // uchar [DG][K-1]: a note's bits
  L.o_ws = b;    b += align16(imax2(w.E, w.EH) * 3 * L.SU * ts + SPAD_MAX);
  L.o_gis = b;
  // Kc: the steps hoisted before their recurrence, as many as the rest of
  // the block's memory holds beside one step's embeddings, evened over the
  // chunks; Kx: the steps whose embeddings a hoisted product takes, as many
  // as the rest holds and a thread's XB registers build
  const int gstep = 4 * DG * L.lS3, xstep = 4 * DG * L.lE;
  const int room = GROUP_MAX_SMEM - b;
  int kc = (room - imax2(xstep, gstep)) / gstep, kx = 0;
  if (kc > w.K) kc = w.K;
  if (kc >= 1) {
    kc = cdiv(w.K, cdiv(w.K, kc));
    kx = (room - kc * gstep) / xstep;
    if (kx * DG * w.E > XB * NT) kx = XB * NT / (DG * w.E);
    if (kx > kc) kx = kc;
  }
  L.Kc = kc < 0 ? 0 : kc;
  L.Kx = kx < 1 ? 1 : kx;
  L.o_xs = b + L.Kc * gstep;   // Kx steps' embeddings, or a step's gh
  b = L.o_xs + imax2(L.Kx * xstep, gstep);
  L.bytes = imax2(chain_end, b);
  return L;
}

struct GSmem {
  float *ht, *tok, *hf, *Y, *wdg, *emb, *bdc, *gid, *gif, *gh, *acc, *ys,
      *hd, *X, *red, *tg, *hsd, *sb, *gis, *xs;
  int *own, *len;       // own: [nro][1 + W] pitch and bits of owned rows
  short* pitch;         // [DG][K-1]
  unsigned char *bits, *mask;  // [DG][K-1][W], [DG][K-1]
  void *wd, *ws;
};

// the float array at byte offset o of the block's shared memory
__device__ __forceinline__ float* group_smem_f(int o) {
  return reinterpret_cast<float*>(reinterpret_cast<char*>(group_smem) + o);
}

// The pointers of the layout L (in static shared memory). A function
// carves the ones it uses at its start: derived from group_smem, they are
// known to point into shared memory, and they live no longer than the
// function.
__device__ inline GSmem group_carve(const GLayout& L, int W) {
  char* base = reinterpret_cast<char*>(group_smem);
  auto f = [&](int o) { return reinterpret_cast<float*>(base + o); };
  GSmem s;
  s.ht = f(L.o_ht);
  s.tok = f(L.o_tok);
  s.hf = f(L.o_hf);
  s.Y = f(L.o_Y);
  s.wdg = f(L.o_wdg);
  s.emb = f(L.o_emb);
  s.bdc = f(L.o_dc);
  s.gid = s.bdc + L.lDC;
  s.gif = f(L.o_gif);
  s.gh = f(L.o_gh);
  s.acc = f(L.o_acc);
  s.ys = f(L.o_ys);
  s.hd = f(L.o_hd);
  s.X = f(L.o_X);
  s.red = f(L.o_red);
  s.tg = f(L.o_tg);
  s.hsd = f(L.o_hsd);
  s.sb = f(L.o_sb);
  s.gis = f(L.o_gis);
  s.xs = f(L.o_xs);
  s.own = reinterpret_cast<int*>(base + L.o_own);
  s.len = s.own + L.nro * (1 + W);
  s.pitch = reinterpret_cast<short*>(base + L.o_pitch);
  s.bits = reinterpret_cast<unsigned char*>(base + L.o_bits);
  s.mask = reinterpret_cast<unsigned char*>(base + L.o_mask);
  s.wd = base + L.o_wd;
  s.ws = base + L.o_ws;
  return s;
}

// v into element p of every block of ranks [r0, r0 + n) of the cluster
template <typename T>
__device__ __forceinline__ void put_ranks(cg::cluster_group& cl, int r0,
                                          int n, T* p, T v) {
  for (int cc = r0; cc < r0 + n; ++cc) *cl.map_shared_rank(p, cc) = v;
}

// X[ro] = hd[ro] @ w_dcomb + b_dcomb for the NRO owned rows, both from
// shared memory. k cut into slices summed in order, slice 0 plus the bias.
template <int NRO, typename S>
__device__ __forceinline__ void dur_product(const S* Wd, const float* bd,
                                            int DH, int DC, const float* hd,
                                            int lDH, float* X, int lDC,
                                            float* red) {
  const int t = threadIdx.x;
  int ns = NT / DC;
  ns = ns > 8 ? 8 : (ns < 1 ? 1 : ns);
  const int chunk = cdiv(DH, ns);
  for (int q = t; q < ns * DC; q += NT) {
    const int sl = q / DC, j = q - sl * DC;
    const int k0 = sl * chunk, k1 = min(DH, k0 + chunk);
    const float b = sl == 0 ? bd[j] : 0.0f;
    float acc[NRO];
#pragma unroll
    for (int ro = 0; ro < NRO; ++ro) acc[ro] = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float wv = to_f(Wd[k * DC + j]);
#pragma unroll
      for (int ro = 0; ro < NRO; ++ro)
        acc[ro] = fmaf(hd[ro * lDH + k], wv, acc[ro]);
    }
#pragma unroll
    for (int ro = 0; ro < NRO; ++ro)
      red[(sl * NRO + ro) * DC + j] = acc[ro] + b;
  }
  __syncthreads();
  for (int q = t; q < NRO * DC; q += NT) {
    const int ro = q / DC, j = q - ro * DC;
    float v = red[ro * DC + j];
    for (int sl = 1; sl < ns; ++sl) v += red[(sl * NRO + ro) * DC + j];
    X[ro * lDC + j] = v;
  }
  __syncthreads();
}

// The GRU gate of unit j with its three gi values in registers (gru_gate's
// arithmetic).
__device__ __forceinline__ float gru_gate_r(const float (&gi)[3],
                                            const float* gh, int H, int j,
                                            float h) {
  const float r = sigmoid_(gi[0] + gh[j]);
  const float z = sigmoid_(gi[1] + gh[H + j]);
  const float n = tanhf(gi[2] + r * gh[2 * H + j]);
  return (1.0f - z) * n + z * h;
}

// Zeroed exchange buffers and the chain's region (a phase launched alone
// reads zeros, not junk); the small constants the serial steps read staged
// in shared memory (this block's columns of w_dur_gi, w_emb's bit rows and
// b_emb, b_dcomb, gi_d).
template <typename S>
__device__ __forceinline__ void group_init(const DecoderWeightsT<S>& w,
                                           const GLayout& L, int c) {
  const GSmem s = group_carve(L, w.W);
  const int t = threadIdx.x, S1 = w.K - 1;
  const int NH = w.NH, j0 = part(NH, L.C, c), U = part(NH, L.C, c + 1) - j0;
  for (int i = t; i < w.W * 3 * U; i += NT) {
    const int ws = i / (3 * U), q = i - ws * 3 * U, g = q / U;
    s.wdg[ws * L.lU3 + q] = ldg_f(w.w_dur_gi + ws * 3 * NH + g * NH + j0 +
                                  q - g * U);
  }
  for (int i = t; i < (w.W + 1) * w.E; i += NT) {
    const int ws = i / w.E, e = i - ws * w.E;
    s.emb[ws * L.lE + e] = ws < w.W ? ldg_f(w.w_emb + (size_t)(w.P + ws) *
                                                w.E + e)
                                    : ldg_f(w.b_emb + e);
  }
  const int DH = w.DH, DC = 2 + 3 * w.DH;
  for (int i = t; i < DC; i += NT) s.bdc[i] = ldg_f(w.b_dcomb + i);
  for (int i = t; i < 9 * DH; i += NT)  // gi_d (3, 3DH): row g a DH-row
    s.gid[i / DH * L.lDH + i % DH] = __ldg(w.gi_d + i);
  for (int i = t; i < L.nro * L.lSL; i += NT) s.Y[i] = 0.0f;
  for (int i = t; i < (L.o_wd - L.o_hf) / 4; i += NT) s.hf[i] = 0.0f;
  for (int i = t; i < DG * S1; i += NT) s.pitch[i] = 0;
  for (int i = t; i < DG * S1 * w.W; i += NT) s.bits[i] = 0;
}

// N (8 or 16) bytes from global memory into this block's shared memory,
// asynchronously (cp.async); cp_wait() waits for this thread's copies
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// w_dcomb into its place in shared memory by asynchronous copies (its
// DH x (2 + 3 DH) elements are whole 16-byte words: DH % 4 == 0); the
// summary's region covers it, so K4 stages it each frame, behind the time
// step. cp_wait() and a block barrier come before the duration chain.
template <typename S>
__device__ __forceinline__ void stage_wd(const DecoderWeightsT<S>& w,
                                         const GLayout& L) {
  const GSmem s = group_carve(L, w.W);
  const int n = w.DH * (2 + 3 * w.DH) * (int)sizeof(S) / 16;
  const char* src = reinterpret_cast<const char*>(w.w_dcomb);
  char* dst = static_cast<char*>(s.wd);
  for (int i = threadIdx.x; i < n; i += NT)
    cp_async<16>(dst + 16 * i, src + 16 * i);
}

// The frame projection: this block's units' columns of [hid | gi_frame] =
// h_time @ w_frame + b_frame (gi_frame plus b_raw_gi) into gif, hid pushed
// into every block's hf.
template <typename S>
__device__ __forceinline__ void group_projection(
    const DecoderWeightsT<S>& w, const GLayout& L, cg::cluster_group& cl) {
  const GSmem s = group_carve(L, w.W);
  const int t = threadIdx.x, C = L.C, c = cl.block_rank();
  const int NH = w.NH, NH4 = 4 * w.NH;
  const int j0 = part(NH, C, c), U = part(NH, C, c + 1) - j0;
  Seg<S> sg[4];
  sg[0] = seg(w.w_frame + j0, w.b_frame + j0, NH4, U, w.TH, s.ht, L.lTH,
              s.gh, L.lU3);  // hid, staged in gh
#pragma unroll
  for (int g = 0; g < 3; ++g)
    sg[1 + g] = seg(w.w_frame + NH + g * NH + j0, w.b_frame + NH + g * NH + j0,
                    NH4, U, w.TH, s.ht, L.lTH, s.gif + g * U, L.lU3);
  group_product(sg);
#pragma unroll 8
  for (int idx = t; idx < DG * 3 * U; idx += NT) {
    const int r = idx / (3 * U), q = idx - r * 3 * U, g = q / U;
    s.gif[r * L.lU3 + q] += ldg_f(w.b_raw_gi + g * NH + j0 + q - g * U);
  }
  for (int idx = t; idx < DG * U; idx += NT) {
    const int r = idx / U, u = idx - r * U;
    put_ranks(cl, 0, C, s.hf + r * L.lNH + j0 + u, s.gh[r * L.lU3 + u]);
  }
  cl.sync();
}

// The owned rows r = c + C ro of a slot (Y pushed by every block): the
// pitch argmax (warp ro; ties to the lowest index) and, with `dur`, the
// 5-step duration chain, into s.own = [pitch | W bits] a row. Thread
// t < NRO DH keeps unit t % DH of row t / DH, its three gi_d values (sos,
// bit 0, bit 1 rows) in registers.
template <int NRO, typename S>
__device__ __forceinline__ void owned_rows(const DecoderWeightsT<S>& w,
                                           const GLayout& L, bool dur) {
  const GSmem s = group_carve(L, w.W);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int P = w.P, DH = w.DH, W = w.W, DC = 2 + 3 * w.DH;
  const bool mine = dur && t < NRO * DH;
  const int ro = t / DH, j = t - ro * DH;
  float gs[3], g0[3], g1[3];   // gi_d rows: sos, bit 0, bit 1
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    gs[g] = mine ? s.gid[g * L.lDH + j] : 0.0f;
    g0[g] = mine ? s.gid[(3 + g) * L.lDH + j] : 0.0f;
    g1[g] = mine ? s.gid[(6 + g) * L.lDH + j] : 0.0f;
  }
  if (warp < NRO) {
    const float* y = s.Y + warp * L.lSL;
    float best = -INFINITY;
    int bi = P;
    for (int k = lane; k < P; k += 32) {
      const float v = y[k];
      if (v > best) {
        best = v;
        bi = k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) {
      int* o = s.own + warp * (1 + W);
      o[0] = bi >= P ? 0 : bi;
      for (int ws = 0; ws < W; ++ws) o[1 + ws] = 0;
    }
  }
  if (!dur) {
    __syncthreads();
    return;
  }
  float* hd = s.hd + ro * L.lDH + j;
  if (mine) {
    const float* y = s.Y + ro * L.lSL;
    *hd = gru_gate_r(gs, y + P + DH + 2, DH, j, y[P + j]);
  }
  __syncthreads();
  const S* Wd = static_cast<const S*>(s.wd);
  for (int ws = 0; ws < W; ++ws) {
    dur_product<NRO>(Wd, s.bdc, DH, DC, s.hd, L.lDH, s.X, L.lDC,
                          s.red);
    if (t < NRO) {
      const float* x = s.X + t * L.lDC;
      s.own[t * (1 + W) + 1 + ws] = x[1] > x[0] ? 1 : 0;
    }
    if (mine && ws + 1 < W) {
      const float* x = s.X + ro * L.lDC;
      *hd = gru_gate_r(x[1] > x[0] ? g1 : g0, x + 2, DH, j, *hd);
    }
    __syncthreads();
  }
}

// The serial 15-slot chain of a frame from hf (hid) and gif: notes-GRU
// step on this block's units (pushed into every block's hf), this block's
// columns of the slot projection (pushed to the rows' owners) and of the
// next hidden gates, the owners' argmax and duration chains (decisions
// pushed into every block), and this block's columns of the folded token
// feedback. The phases bits NOTE and DUR select what runs.
template <int NRO, typename S>
__device__ __forceinline__ void group_chain(const DecoderWeightsT<S>& w,
                                            const GLayout& L,
                                            cg::cluster_group& cl,
                                            int phases) {
  const GSmem s = group_carve(L, w.W);
  const int t = threadIdx.x, C = L.C, c = cl.block_rank();
  const int NH = w.NH, NH3 = 3 * w.NH, DH = w.DH, P = w.P, W = w.W, K = w.K;
  const int SL = P + DH + 2 + 3 * DH;
  const int j0 = part(NH, C, c), U = part(NH, C, c + 1) - j0;
  const int s0 = part(SL, C, c), ns = part(SL, C, c + 1) - s0;
  const bool note = phases & PH_NOTE, dur = phases & PH_DUR;
  if (phases & PH_BARRIERS) {  // timing: the chain's cluster barriers alone
    for (int k = 1; k < K; ++k) {
      cl.sync();
      cl.sync();
      cl.sync();
    }
  }
  if (note) {
#pragma unroll 8
    for (int idx = t; idx < DG * 3 * U; idx += NT) {
      const int r = idx / (3 * U), q = idx - r * 3 * U, g = q / U;
      s.acc[r * L.lU3 + q] = __ldg(w.gi_tok_sos + g * NH + j0 + q - g * U);
    }
    Seg<S> sg[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      sg[g] = seg(w.w_hh + g * NH + j0, w.b_hh + g * NH + j0, NH3, U, NH,
                  s.hf, L.lNH, s.gh + g * U, L.lU3);
    group_product(sg);
    cl.sync();  // every block has read hid before the first slot's h comes
  }
  for (int k = 1; k < K; ++k) {
    if (note) {
      for (int idx = t; idx < DG * U; idx += NT) {
        const int r = idx / U, u = idx - r * U, j = j0 + u;
        const float* g = s.gif + r * L.lU3;
        const float* a = s.acc + r * L.lU3;
        const float* hh = s.gh + r * L.lU3;
        const float ir = g[u] + a[u], iz = g[U + u] + a[U + u],
                    in_ = g[2 * U + u] + a[2 * U + u];
        const float rr = sigmoid_(ir + hh[u]);
        const float zz = sigmoid_(iz + hh[U + u]);
        const float nn = tanhf(in_ + rr * hh[2 * U + u]);
        const float hv = s.hf[r * L.lNH + j];
        put_ranks(cl, 0, C, s.hf + r * L.lNH + j, (1.0f - zz) * nn + zz * hv);
      }
      cl.sync();
      // the last slot's next hidden gates are never read
      const int Uh = k + 1 < K ? U : 0;
      Seg<S> sg[4];
      sg[0] = seg(w.w_slot + s0, w.b_slot + s0, SL, ns, NH, s.hf, L.lNH,
                  s.ys, L.lSLc);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        sg[1 + g] = seg(w.w_hh + g * NH + j0, w.b_hh + g * NH + j0, NH3, Uh,
                        NH, s.hf, L.lNH, s.gh + g * U, L.lU3);
      group_product(sg);
      for (int idx = t; idx < DG * ns; idx += NT) {
        const int r = idx / ns, j = idx - r * ns;
        *cl.map_shared_rank(s.Y + (r / C) * L.lSL + s0 + j, r % C) =
            s.ys[r * L.lSLc + j];
      }
      cl.sync();
    }
    if (note || dur) {
      owned_rows<NRO>(w, L, dur);
      for (int idx = t; idx < NRO * C; idx += NT) {
        const int ro = idx / C, cc = idx - ro * C, r = c + C * ro;
        const int* o = s.own + ro * (1 + W);
        const int q = r * (K - 1) + k - 1;
        *cl.map_shared_rank(s.pitch + q, cc) = static_cast<short>(o[0]);
        for (int ws = 0; ws < W; ++ws)
          *cl.map_shared_rank(s.bits + q * W + ws, cc) =
              static_cast<unsigned char>(o[1 + ws]);
      }
      cl.sync();
    }
    // this block's columns of the next slot's folded token feedback: the
    // pitch row, then each set bit's row in order (none after the last
    // slot: the summary's planes share this region)
    if (note && k + 1 < K) {
#pragma unroll 8
      for (int idx = t; idx < DG * 3 * U; idx += NT) {
        const int r = idx / (3 * U), q = idx - r * 3 * U, g = q / U;
        const int col = g * NH + j0 + q - g * U, qd = r * (K - 1) + k - 1;
        float a = ldg_f(w.w_pitch_gi + (size_t)s.pitch[qd] * NH3 + col);
        for (int ws = 0; ws < W; ++ws)
          if (s.bits[qd * W + ws]) a += s.wdg[ws * L.lU3 + q];
        s.acc[r * L.lU3 + q] = a;
      }
      __syncthreads();
    }
  }
}

// Each row's length: the first slot that decided eos, else K - 1.
template <typename S>
__device__ __forceinline__ void group_lengths(const DecoderWeightsT<S>& w,
                                              const GLayout& L) {
  const GSmem s = group_carve(L, w.W);
  for (int r = threadIdx.x; r < DG; r += NT) {
    int len = 0;
    for (int k = 1; k < w.K && !len; ++k)
      if (s.pitch[r * (w.K - 1) + k - 1] == w.eos) len = k;
    s.len[r] = len ? len : w.K - 1;
  }
  __syncthreads();
}

// A block's summary weight staged in shared memory: `in` rows of n = 3 SU
// columns (its units' r, z and n columns side by side), row k at (k / kc)
// spad + k ld elements: each lane's k-slice (summary_lanes, slice_width)
// starts 128 / sl bytes on modulo 128 from the last, so that the lanes of
// a quarter warp (8 / sl units of sl slices; 16 lanes for 8-byte bf16
// words) read distinct banks.
template <typename S>
struct StagedW {
  S* W;
  int in, n, ld, sl, kc, spad;
};

template <typename S>
__device__ __forceinline__ StagedW<S> staged_w(void* ws, int in, int n,
                                               int sl) {
  StagedW<S> sw;
  sw.W = static_cast<S*>(ws);
  sw.in = in;
  sw.n = sw.ld = n;
  sw.sl = sl;
  sw.kc = slice_width(in, sl);
  const int ts = (int)sizeof(S), step = sw.kc * n * ts;
  sw.spad = ((128 / sl - step % 128) + 128) % 128 / ts;
  return sw;
}

// Columns [e0, e0 + SU) of each gate of a direction's weight Wd (in, 3 EH)
// into sw, four weights a copy; ends synchronized.
template <typename S>
__device__ __forceinline__ void stage_summary(const S* Wd, int EH, int e0,
                                              int SU, const StagedW<S>& sw) {
  const int nq = sw.n / 4, total = sw.in * nq;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int k = i / nq, q = 4 * (i - k * nq), g = q / SU;
    cp_async<4 * sizeof(S)>(sw.W + k / sw.kc * sw.spad + k * sw.ld + q,
                            Wd + (size_t)k * 3 * EH + g * EH + e0 + q -
                                g * SU);
  }
  cp_wait();
  __syncthreads();
}

__device__ __forceinline__ unsigned sh_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float4 lds4(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
// four weights of storage type S at shared address a, as f32 (the bf16
// bits in the high half of an f32)
template <typename S>
__device__ __forceinline__ float4 ldsw(unsigned a) {
  if (sizeof(S) == 4) return lds4(a);
  unsigned x, y;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(x), "=r"(y)
               : "r"(a));
  return make_float4(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u),
                     __uint_as_float(y << 16),
                     __uint_as_float(y & 0xffff0000u));
}

// out[r][j] = b[j] + sum_{k < in} x[r][k] W[k][j] for R rows (a multiple
// of RU) and j < n, W staged (StagedW), b and x in shared memory, in units
// of RU rows x PJ columns at sl lanes a unit: each lane sums its k-slice
// (group_product's slices at sl lanes) in order, the slices meet by xor
// shuffles and the bias comes last, so every output has group_product's
// bits whatever RU. RU = 4 spreads a 16-row product over twice the warps
// of RU = PR. Every thread calls it; it ends synchronized.
template <int RU, typename S>
__device__ __forceinline__ void staged_product(const StagedW<S>& sw,
                                               const float* b,
                                               const float* x, int ldx,
                                               int R, float* out, int ldo) {
  const int t = threadIdx.x, lane = t & 31, sl = sw.sl;
  const int Q = sw.n / PJ, nq = R / RU * Q;
  if (nq == 0) return;
  const int per_warp = 32 / sl, s = lane % sl;
  const int warps = cdiv(nq, per_warp);
  const unsigned wld = sw.ld * (unsigned)sizeof(S), xld = 4u * ldx;
  for (int wq = t >> 5; wq < warps; wq += NT / 32) {
    const int p = wq * per_warp + lane / sl;
    const bool live = p < nq;
    const int r0 = live ? p / Q * RU : 0, c0 = live ? PJ * (p % Q) : 0;
    const int k0 = min(sw.in, s * sw.kc),
              k1 = live ? min(sw.in, k0 + sw.kc) : k0;
    // shared addresses of the lane's first weight row and x element
    unsigned wa = sh_addr(sw.W + s * sw.spad + c0) + k0 * wld;
    unsigned xa = sh_addr(x + r0 * ldx + k0);
    float acc[RU][PJ];
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int u = 0; u < PJ; ++u) acc[r][u] = 0.0f;
    int k = k0;
#pragma unroll 1
    for (; k + 4 <= k1; k += 4, wa += 4 * wld, xa += 16) {
      float4 wv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wv[kk] = ldsw<S>(wa + kk * wld);
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        const float4 a = lds4(xa + r * xld);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[r][0] = fmaf(av[kk], wv[kk].x, acc[r][0]);
          acc[r][1] = fmaf(av[kk], wv[kk].y, acc[r][1]);
          acc[r][2] = fmaf(av[kk], wv[kk].z, acc[r][2]);
          acc[r][3] = fmaf(av[kk], wv[kk].w, acc[r][3]);
        }
      }
    }
    for (; k < k1; ++k, wa += wld, xa += 4) {
      const float4 wk = ldsw<S>(wa);
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        float xv;
        asm volatile("ld.shared.f32 %0, [%1];\n"
                     : "=f"(xv)
                     : "r"(xa + r * xld));
        acc[r][0] = fmaf(xv, wk.x, acc[r][0]);
        acc[r][1] = fmaf(xv, wk.y, acc[r][1]);
        acc[r][2] = fmaf(xv, wk.z, acc[r][2]);
        acc[r][3] = fmaf(xv, wk.w, acc[r][3]);
      }
    }
    for (int off = 1; off < sl; off <<= 1)
#pragma unroll
      for (int r = 0; r < RU; ++r)
#pragma unroll
        for (int u = 0; u < PJ; ++u)
          acc[r][u] += __shfl_xor_sync(0xffffffffu, acc[r][u], off);
    if (live && s == 0) {
#pragma unroll
      for (int r = 0; r < RU; ++r) {
        float* o = out + (r0 + r) * ldo + c0;
#pragma unroll
        for (int u = 0; u < PJ; ++u) o[u] = acc[r][u] + b[c0 + u];
      }
    }
  }
  __syncthreads();
}

// The masked bi-GRU over [sos | 15 predicted notes]: blocks [0, C/2) run
// the forward direction, [C/2, C) the backward, each block EH / (C/2)
// units; step k runs slot k forward and slot K-1-k backward, and a row's
// hidden moves only while the slot is below its length. The steps run in
// chunks of L.Kc: the chunk's input projections first (gi = x @ we_ih +
// be_ih, we_ih staged, Kx steps' embeddings a product), then its steps on
// we_hh alone, staged: each h @ we_hh + be_hh, the gate, the new hidden
// into the direction's blocks and one cluster barrier. Two planes of the
// direction's hidden alternate; the result is plane K & 1. sos_emb holds
// the group's rows (nrows valid).
template <typename S>
__device__ __forceinline__ void group_summary(const DecoderWeightsT<S>& w,
                                              const GLayout& L,
                                              cg::cluster_group& cl,
                                              const S* sos_emb, int nrows) {
  const GSmem s = group_carve(L, w.W);
  const int t = threadIdx.x, Cd = L.C / 2, c = cl.block_rank();
  const int d = c / Cd, e0 = part(w.EH, Cd, c - d * Cd),
            SU = part(w.EH, Cd, c - d * Cd + 1) - e0;
  const int E = w.E, EH = w.EH, EH3 = 3 * w.EH, K = w.K, W = w.W;
  const int n3 = 3 * SU, sl = summary_lanes(SU), plane = DG * L.lEH;
  const int gstep = DG * L.lS3;
  const StagedW<S> wi = staged_w<S>(s.ws, E, n3, sl),
                   wh = staged_w<S>(s.ws, EH, n3, sl);
  float* bi = s.sb;           // be_ih, be_hh: this block's columns
  float* bh = s.sb + L.lS3;
  for (int i = t; i < plane; i += NT) s.hsd[i] = 0.0f;
  for (int i = t; i < n3; i += NT) {
    const int g = i / SU, col = d * EH3 + g * EH + e0 + i - g * SU;
    bi[i] = ldg_f(w.be_ih + col);
    bh[i] = ldg_f(w.be_hh + col);
  }
  for (int i = t; i < DG * (K - 1); i += NT) {
    int m = 0;
    for (int ws = 0; ws < W; ++ws) m |= s.bits[i * W + ws] << ws;
    s.mask[i] = static_cast<unsigned char>(m);
  }
  auto slot_of = [&](int k) { return d == 0 ? k : K - 1 - k; };
  // the embeddings of steps [k, k + n) into xs, x = w_emb[pitch] + the set
  // bits' rows in order + b_emb (sos_emb for slot 0): a thread loads the
  // pitch rows of all its elements first, then adds the bit rows bit by bit
  auto embed = [&](int k, int n) {
    float v[XB];
    int m[XB], eo[XB], xo[XB];  // the note's bits (-1: sos), e, xs index
#pragma unroll
    for (int i = 0; i < XB; ++i) {
      const int idx = t + i * NT, q = idx / E, e = idx - q * E;
      const int j = q / DG, r = q - j * DG, slot = slot_of(k + j);
      v[i] = 0.0f;
      m[i] = -1;
      eo[i] = e;
      xo[i] = q < n * DG ? q * L.lE + e : -1;
      if (xo[i] < 0) continue;
      if (slot == 0) {
        v[i] = r < nrows ? to_f(sos_emb[r * E + e]) : 0.0f;
      } else {
        const int qd = r * (K - 1) + slot - 1;
        v[i] = ldg_f(w.w_emb + (size_t)s.pitch[qd] * E + e);
        m[i] = s.mask[qd];
      }
    }
    for (int ws = 0; ws < W; ++ws)
#pragma unroll
      for (int i = 0; i < XB; ++i)
        if (m[i] > 0 && (m[i] >> ws & 1)) v[i] += s.emb[ws * L.lE + eo[i]];
#pragma unroll
    for (int i = 0; i < XB; ++i) {
      if (m[i] >= 0) v[i] += s.emb[W * L.lE + eo[i]];
      if (xo[i] >= 0) s.xs[xo[i]] = v[i];
    }
  };
  for (int k0 = 0; k0 < K; k0 += L.Kc) {
    const int k1 = min(K, k0 + L.Kc);
    stage_summary(w.we_ih + (size_t)d * E * EH3, EH, e0, SU, wi);
    for (int kb = k0; kb < k1; kb += L.Kx) {
      const int nb = min(L.Kx, k1 - kb);
      embed(kb, nb);
      __syncthreads();
      staged_product<PR>(wi, bi, s.xs, L.lE, nb * DG,
                         s.gis + (kb - k0) * gstep, L.lS3);
    }
    stage_summary(w.we_hh + (size_t)d * EH * EH3, EH, e0, SU, wh);
    for (int k = k0; k < k1; ++k) {
      const int slot = slot_of(k);
      const float* hin = s.hsd + (k & 1) * plane;
      float* hout = s.hsd + ((k + 1) & 1) * plane;
      staged_product<PR / 2>(wh, bh, hin, L.lEH, DG, s.xs, L.lS3);
      for (int idx = t; idx < DG * SU; idx += NT) {
        const int r = idx / SU, u = idx - r * SU, e = e0 + u;
        const float hv = hin[r * L.lEH + e];
        const float hn = slot < s.len[r]
                             ? gru_gate(s.gis + (k - k0) * gstep + r * L.lS3,
                                        s.xs + r * L.lS3, SU, u, hv)
                             : hv;
        put_ranks(cl, d * Cd, Cd, hout + r * L.lEH + e, hn);
      }
      cl.sync();
    }
  }
}

// K3 over a row group a cluster (see the note at the top).
template <int NRO, typename S>
__global__ void __launch_bounds__(NT, 1)
frame_group_kernel(DecoderWeightsT<S> w, int B, int phases,
                   const S* __restrict__ h_time,
                   const S* __restrict__ sos_emb, int* __restrict__ pitch_idx,
                   int* __restrict__ dur_bits, S* __restrict__ summary,
                   int* __restrict__ lengths) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), c = cl.block_rank(), t = threadIdx.x;
  __shared__ GLayout L_;
  if (t == 0) L_ = group_layout(w, C, false);
  __syncthreads();
  const GLayout& L = L_;
  const int row0 = blockIdx.x / C * DG, nrows = min(DG, B - row0);
  const int TH = w.TH, K = w.K, W = w.W, S1 = w.K - 1;
  group_init(w, L, c);
  stage_wd(w, L);
  for (int idx = t; idx < DG * TH; idx += NT) {
    const int r = idx / TH, j = idx - r * TH;
    group_smem_f(L.o_ht)[r * L.lTH + j] =
        r < nrows ? to_f(h_time[(size_t)(row0 + r) * TH + j]) : 0.0f;
  }
  cl.sync();
  if (phases & PH_PROJ) group_projection(w, L, cl);
  cp_wait();
  __syncthreads();
  group_chain<NRO>(w, L, cl, phases);
  group_lengths(w, L);
  const GSmem s = group_carve(L, w.W);
  for (int idx = t; idx < NRO * S1 * (1 + W); idx += NT) {
    const int ro = idx / (S1 * (1 + W)), q = idx - ro * S1 * (1 + W);
    const int r = c + C * ro, k = q / (1 + W), cc = q - k * (1 + W);
    if (r >= nrows) continue;
    if (cc == 0)
      pitch_idx[(size_t)(row0 + r) * S1 + k] = s.pitch[r * S1 + k];
    else
      dur_bits[((size_t)(row0 + r) * S1 + k) * W + cc - 1] =
          s.bits[(r * S1 + k) * W + cc - 1];
  }
  if (t < NRO && c + C * t < nrows) lengths[row0 + c + C * t] =
      s.len[c + C * t];
  if (phases & PH_SUMM) {
    group_summary(w, L, cl, sos_emb + (size_t)row0 * w.E, nrows);
    const int Cd = C / 2, d = c / Cd, e0 = part(w.EH, Cd, c - d * Cd),
              SU = part(w.EH, Cd, c - d * Cd + 1) - e0;
    const float* hfin = group_smem_f(L.o_hsd) + (K & 1) * DG * L.lEH;
    for (int idx = t; idx < nrows * SU; idx += NT) {
      const int r = idx / SU, e = e0 + idx - r * SU;
      summary[(size_t)(row0 + r) * 2 * w.EH + d * w.EH + e] =
          from_f<S>(hfin[r * L.lEH + e]);
    }
  }
  cl.sync();  // no block leaves while another may write into its memory
}

// K4 over a row group a cluster: the time GRU (this block's TH / C units,
// pushed into every block's ht), then K3's frame, the grid rows of the
// owned rows, and the summary pushed into every block's tok, T times.
template <int NRO>
__global__ void __launch_bounds__(NT, 1)
full_group_kernel(DecoderWeights w, int B, int phases,
                  const float* __restrict__ h0, const float* __restrict__ gi_z,
                  const float* __restrict__ token0,
                  const float* __restrict__ sos_emb, int* __restrict__ grid) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), c = cl.block_rank(), t = threadIdx.x;
  __shared__ GLayout L_;
  if (t == 0) L_ = group_layout(w, C, true);
  __syncthreads();
  const GLayout& L = L_;
  const int row0 = blockIdx.x / C * DG, nrows = min(DG, B - row0);
  const int TH = w.TH, TH3 = 3 * w.TH, EH2 = 2 * w.EH, K = w.K, W = w.W,
            S1 = w.K - 1, cell = 1 + w.W;
  const int t0 = part(TH, C, c), TU = part(TH, C, c + 1) - t0;
  const int Cd = C / 2, d = c / Cd, e0 = part(w.EH, Cd, c - d * Cd),
            SU = part(w.EH, Cd, c - d * Cd + 1) - e0;
  group_init(w, L, c);
  for (int idx = t; idx < DG * TH; idx += NT) {
    const int r = idx / TH, j = idx - r * TH;
    group_smem_f(L.o_ht)[r * L.lTH + j] =
        r < nrows ? h0[(size_t)(row0 + r) * TH + j] : 0.0f;
  }
  for (int idx = t; idx < DG * EH2; idx += NT) {
    const int r = idx / EH2, j = idx - r * EH2;
    group_smem_f(L.o_tok)[r * L.lHS + j] =
        r < nrows ? token0[(size_t)(row0 + r) * EH2 + j] : 0.0f;
  }
  cl.sync();
  for (int ti = 0; ti < w.T; ++ti) {
    stage_wd(w, L);
    if (phases & PH_TIME) {
      // gi = gi_z + token @ wt_tok, gh = h @ wt_hh + bt_hh
      const GSmem s = group_carve(L, w.W);
      Seg<float> sg[6];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        sg[g] = seg<float>(w.wt_tok + g * TH + t0, nullptr, TH3, TU, EH2,
                           s.tok, L.lHS, s.tg + g * TU, L.lT6);
        sg[3 + g] = seg<float>(w.wt_hh + g * TH + t0, w.bt_hh + g * TH + t0,
                               TH3, TU, TH, s.ht, L.lTH,
                               s.tg + (3 + g) * TU, L.lT6);
      }
      group_product(sg);
      cl.sync();  // every block has read ht before the new one comes in
#pragma unroll 4
      for (int idx = t; idx < DG * TU; idx += NT) {
        const int r = idx / TU, u = idx - r * TU, j = t0 + u;
        const float* gz = gi_z + (size_t)(row0 + (r < nrows ? r : 0)) * TH3;
        const float zr = r < nrows ? 1.0f : 0.0f;
        const float* gi = s.tg + r * L.lT6;
        const float* gh = gi + 3 * TU;
        const float ir = zr * gz[j] + gi[u], iz = zr * gz[TH + j] + gi[TU + u],
                    in_ = zr * gz[2 * TH + j] + gi[2 * TU + u];
        const float rr = sigmoid_(ir + gh[u]);
        const float zz = sigmoid_(iz + gh[TU + u]);
        const float nn = tanhf(in_ + rr * gh[2 * TU + u]);
        const float hv = s.ht[r * L.lTH + j];
        put_ranks(cl, 0, C, s.ht + r * L.lTH + j, (1.0f - zz) * nn + zz * hv);
      }
      cl.sync();
    }
    if (phases & PH_PROJ) group_projection(w, L, cl);
    cp_wait();
    __syncthreads();
    group_chain<NRO>(w, L, cl, phases);
    group_lengths(w, L);
    {  // grid (B, T, K-1, 1+W) = [pitch | dur bits] a slot, owned rows
      const GSmem s = group_carve(L, w.W);
      for (int idx = t; idx < NRO * S1 * cell; idx += NT) {
        const int ro = idx / (S1 * cell), q = idx - ro * S1 * cell;
        const int r = c + C * ro, k = q / cell, cc = q - k * cell;
        if (r >= nrows) continue;
        grid[(((size_t)(row0 + r) * w.T + ti) * S1 + k) * cell + cc] =
            cc == 0 ? s.pitch[r * S1 + k] : s.bits[(r * S1 + k) * W + cc - 1];
      }
    }
    if (phases & PH_SUMM) {
      group_summary(w, L, cl, sos_emb + (size_t)row0 * w.E, nrows);
      const GSmem s = group_carve(L, w.W);
      const float* hfin = s.hsd + (K & 1) * DG * L.lEH;
      for (int idx = t; idx < DG * SU; idx += NT) {
        const int r = idx / SU, e = e0 + idx - r * SU;
        put_ranks(cl, 0, C, s.tok + r * L.lHS + d * w.EH + e,
                  hfin[r * L.lEH + e]);
      }
      cl.sync();
    }
  }
  cl.sync();  // no block leaves while another may write into its memory
}

// What the row-group kernels take beyond the cluster size: their shared
// memory fits a block with at least one summary step hoisted, an owned
// row's dur units fit a block's threads, a step's embeddings fit XB a
// thread, a note's duration bits a byte, and w_slot's width (P + 2 + 4 DH)
// is whole quads like the other widths (the wrapper checks TH, NH, DH, E,
// EH).
template <typename S>
bool group_fits(const DecoderWeightsT<S>& w, const GLayout& L) {
  return L.bytes <= GROUP_MAX_SMEM && L.Kc >= 1 && L.nro * w.DH <= NT &&
         DG * w.E <= XB * NT && w.W <= WMAX && (w.P + 2) % 4 == 0;
}

template <typename S>
using FrameGroupKern = void (*)(DecoderWeightsT<S>, int, int, const S*,
                                const S*, int*, int*, S*, int*);
using FullGroupKern = void (*)(DecoderWeights, int, int, const float*,
                               const float*, const float*, const float*,
                               int*);

// the instance of a kernel for cluster size C (16 or 8; rows owned a
// block: 16 / C)
template <typename S>
FrameGroupKern<S> frame_group_instance(int C) {
  return C == 16 ? frame_group_kernel<1, S> : frame_group_kernel<2, S>;
}

inline FullGroupKern full_group_instance(int C) {
  return C == 16 ? full_group_kernel<1> : full_group_kernel<2>;
}

// {shared memory bytes, clusters of C blocks the card holds at once (0 if
// it cannot say)} of K3 (full = 0) or K4 (full = 1)
template <typename S>
cudaError_t group_info(const DecoderWeightsT<S>& w, bool full, int C,
                       int* out) {
  if (!cluster_ok(C)) return cudaErrorInvalidValue;
  const GLayout L = group_layout(w, C, full);
  out[0] = L.bytes;
  out[1] = 0;
  if (!group_fits(w, L)) return cudaSuccess;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = group_config(1, C, L.bytes, nullptr, &attr);
  cudaError_t e;
  if (full) {
    const FullGroupKern k = full_group_instance(C);
    e = group_prepare(k, L.bytes, C);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&out[1], k, &cfg);
  } else {
    const FrameGroupKern<S> k = frame_group_instance<S>(C);
    e = group_prepare(k, L.bytes, C);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&out[1], k, &cfg);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    out[1] = 0;
  }
  return cudaSuccess;
}

// K3 over B rows in groups of DG, a cluster of C blocks a group.
template <typename S>
int frame_decode_groups(const DecoderWeightsT<S>* w, int B, int phases, int C,
                        const S* h_time, const S* sos_emb, int* pitch_idx,
                        int* dur_bits, S* summary, int* lengths,
                        void* stream) {
  if (B <= 0 || phases < 1 || phases > (PH_ALL | PH_BARRIERS) ||
      !cluster_ok(C))
    return cudaErrorInvalidValue;
  const GLayout L = group_layout(*w, C, false);
  if (!group_fits(*w, L)) return cudaErrorInvalidValue;
  const FrameGroupKern<S> k = frame_group_instance<S>(C);
  cudaError_t e = group_prepare(k, L.bytes, C);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      group_config(cdiv(B, DG), C, L.bytes,
                   static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, k, *w, B, phases, h_time, sos_emb, pitch_idx,
                         dur_bits, summary, lengths);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K4 over B rows in groups of DG, a cluster of C blocks a group.
inline int full_decode_groups(const DecoderWeights* w, int B, int phases,
                              int C, const float* h0, const float* gi_z,
                              const float* token0, const float* sos_emb,
                              int* grid_out, void* stream) {
  if (B <= 0 || phases < 1 || phases > (PH_ALL | PH_BARRIERS) ||
      !cluster_ok(C))
    return cudaErrorInvalidValue;
  const GLayout L = group_layout(*w, C, true);
  if (!group_fits(*w, L)) return cudaErrorInvalidValue;
  const FullGroupKern k = full_group_instance(C);
  cudaError_t e = group_prepare(k, L.bytes, C);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      group_config(cdiv(B, DG), C, L.bytes,
                   static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, k, *w, B, phases, h0, gi_z, token0, sos_emb,
                         grid_out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The float entry points are compiled here, the bf16 ones of K3 in
// decoder_bf16.cu, which includes this file: the two build in parallel.
// pctd_frame_decode*, pctd_full_decode: the row-group kernels, in clusters
// of `cluster` blocks (8 or 16), the phases of `phases` (PH_*; 31 all).
extern "C" {

#ifndef PCTD_DECODE_BF16
const char* pctd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pctd_decode_info(const DecoderWeights* w, int full, int cluster,
                     int* out) {
  return group_info(*w, full != 0, cluster, out);
}

int pctd_frame_decode(const DecoderWeights* w, int B, int phases,
                      int cluster, const float* h_time, const float* sos_emb,
                      int* pitch_idx, int* dur_bits, float* summary,
                      int* lengths, void* stream) {
  return frame_decode_groups(w, B, phases, cluster, h_time, sos_emb,
                             pitch_idx, dur_bits, summary, lengths, stream);
}

int pctd_full_decode(const DecoderWeights* w, int B, int phases, int cluster,
                     const float* h0, const float* gi_z, const float* token0,
                     const float* sos_emb, int* grid_out, void* stream) {
  return full_decode_groups(w, B, phases, cluster, h0, gi_z, token0, sos_emb,
                            grid_out, stream);
}
#else
using bf16 = __nv_bfloat16;

int pctd_decode_info_bf16(const DecoderWeightsT<bf16>* w, int cluster,
                          int* out) {
  return group_info(*w, false, cluster, out);
}

int pctd_frame_decode_bf16(const DecoderWeightsT<bf16>* w, int B, int phases,
                           int cluster, const bf16* h_time,
                           const bf16* sos_emb, int* pitch_idx, int* dur_bits,
                           bf16* summary, int* lengths, void* stream) {
  return frame_decode_groups(w, B, phases, cluster, h_time, sos_emb,
                             pitch_idx, dur_bits, summary, lengths, stream);
}
#endif

}  // extern "C"
