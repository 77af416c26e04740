// Teacher-forced frame kernels of the training step for Hopper (sm_90a), in
// two storage types (float and bf16): K1 in f32 arithmetic on CUDA cores,
// K2a and K2b in f32-accurate products on the tensor cores.
//
// train_fwd_group_kernel (K1) replaces pctd_tpu/ops/pallas/train_frame.py::
//   _fwd_kernel: one frame's 15 note-GRU slots (pitch head and argmax,
//   5-step duration GRU with argmax feedback, predicted-note embedding,
//   teacher-coin token select) and the masked bi-GRU summary of the
//   predicted notes. In loss mode it ends in the masked-CE numerators; in
//   logits-out mode (the JAX package's frame_core) it writes the pitch and
//   duration logits instead and reads no target. On the gradient path it
//   writes every activation the backward reads (TrainStash). What bounds
//   it: a chain of small dependent products, ~45 MFLOP a row over ~30 MB
//   of weights (an argmax follows, so its products stay f32 FMA); a block
//   that streams every weight for its own few rows is bound by that L2
//   stream (the per-row kernel this one replaced, PERF.md), and a row group
//   by its serial chain. What the design does, along the JAX forward's
//   phases (_run_forward, _summary_fwd): a thread-block cluster of C blocks
//   (8 or 16; or the per-row kernel below where the groups would run in
//   waves: build.k1_plan, by measured wave times) takes a group of DG = 16
//   rows, each block a share of every product's columns in whole quads
//   (group.cuh), so one weight read serves the group. The projection (h0,
//   gi_frame, the first hidden gates) reads its weights from L2 once for
//   the group. The slot chain's weights never depend on the chain, so they
//   are packed once a train step into one contiguous panel a block
//   (train_frame.py: pack_panels) and stream through a ring of
//   shared-memory stages by bulk async copies completing on mbarriers: one
//   thread issues the copies up to K1_STAGES chunks ahead of the products,
//   which read the weights from shared memory; the next slot's first
//   chunks land while the cluster exchanges a slot's results. A slot: the
//   token product (tok @ w_ih_tok) and the note-GRU step on the block's
//   units (h into every block, a cluster barrier), the hidden product h @
//   [w_pitch | w_dhid[:NH] | w_hh] (pitch logits and dur-hidden shares to
//   the row's owner block r % C, the next hidden gates kept, a barrier),
//   then the owner's pitch argmax and CE, est @ w_dhid[NH:] and the 5-step
//   duration chain ([w_dout | w_dhh] and w_dhid[NH:] staged in shared
//   memory, an output a thread), and the next token (the predicted note's
//   embedding or, where the slot's coin says so, the ground truth) and the
//   decisions into every block (a barrier). The summary then computes the
//   input projections of all K slots first (hoisted, as _summary_fwd does)
//   and runs its 16 steps on we_hh alone, each block's summary weights
//   staged.
//   Products are f32 FMA in a fixed order (no atomics: the same bits on
//   every launch). Where the Pallas backward rebuilt the forward from a
//   stash of slot hiddens, the H100's 80 GB lets K1 write every gate and
//   decision it computed (~90 MB a frame at B=128), so K2 recomputes
//   nothing and never re-decides an argmax.
//
// K2a (train_bwd_slots_kernel, train_bwd_chain_kernel,
//   train_bwd_proj_kernel) replaces _bwd_kernel's hand-written VJP,
//   _frame_bwd_core (pctd_tpu/ops/pallas/train_frame.py:437-733) without
//   its weight-gradient adds: it writes the per-sample gate cotangents
//   (TrainCotangents), d_frame_h and d_x_emb. In loss mode it computes the
//   logit cotangents from the targets; in logits-out mode it reads them
//   (d_pitch, d_dur), already masked by the caller's loss. What bounds it
//   on this card: its products must be f32-accurate (the cotangents are
//   f32 and no argmax follows): 5.8 GFLOP a frame at B=128 at the 3xTF32
//   rate (495 / 3 TFLOP/s; bf16 weights: three bf16 passes, 989 / 3), a
//   floor of 0.035 ms; and the latency of its two serial chains, the note
//   GRU's 15 steps (d_gh @ w_hh^T, 3.0 GFLOP) and the summary bi-GRU's 16
//   (d_gh @ we_hh^T), each step a product that waits on the last. What the
//   design does: it follows _frame_bwd_core's phases, batching all but the
//   two chains over rows and slots. The slot-row kernel (2b) takes 16 of
//   the (K-1) B slot rows a block: the logit cotangents, the 5-step
//   duration chain with w_dhh staged in shared memory, the heads, and the
//   note chain's injected cotangent dh_inj into scratch. The chain kernel
//   runs the note chain (2c) in thread-block clusters of C blocks (16 where
//   the launch fits the card at once, else 8): a cluster takes a group of
//   16 rows, each block NH / C hidden units, so the group reads each weight
//   once a step rather than once a row; a block's columns of d_gh @ w_hh^T
//   land in its partial plane and the blocks sum their units' partials from
//   each other's planes in rank order (distributed shared memory), one
//   cluster barrier a step. Beside them, a block a (direction, row group)
//   runs the summary chain (2a). The projection kernel (2d) runs the
//   batched products d_pred, d_tok and d_frame_h and routes the token and
//   embedding cotangents. Every product is m16n8k8 TF32 mma.sync with the
//   f32 operands split hi + lo by round to nearest (3xTF32; bf16 weights
//   are exact in TF32: two passes), 16 rows of cotangents against weight
//   rows, each 32 k summed in a fresh fragment; gates and CE stay f32 on
//   CUDA cores. No atomics: the same bits on every run.
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
// Plain PyTorch versions (train_frame.py beside this file): frame_recon_plain
// (loss mode) and frame_core_plain (logits out) for K1, with autograd of
// them for K2; frame_stash_plain and frame_bwd_plain for K2a alone;
// wgrad_plain for K2b. Ties of the pitch argmax go to the lowest index; a
// dur bit is logit[1] > logit[0] strictly. The argmax decisions and the
// teacher coins carry no gradient.
//
// The bf16 mode (the JAX kernels' compute dtype bfloat16): every kernel is
// a template on the storage type T of the weights, the inputs, the stashed
// values and the outputs; one source serves both types. The arithmetic
// stays f32 (a bf16 load converts exactly, a product of two bf16 values is
// exact in f32, sums are f32), and a value is rounded to bf16 exactly
// where the Pallas kernel writes .astype(dtype): the note and duration
// hiddens, the pitch and duration logits (the argmaxes and the CE read the
// rounded values), the predicted-note embedding, the summary hiddens, and
// the duration GRU's feedback rows w_dih[b] + b_dih (a bf16 + bf16 sum).
// The sos projection dur_sos @ w_dih + b_dih, the gate pre-activations and
// the gates stay f32. The stash holds the rounded values in bf16 and the
// f32 gates (ng, dg, sg) in f32; the per-sample cotangents and the CE
// numerators are f32; d_frame_h and d_x_emb are rounded once when stored;
// K2b sums each weight gradient in f32 and rounds it once to bf16.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "group.cuh"

namespace cg = cooperative_groups;

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

// The weight panels of K1 (train_frame.py: panel_layout, pack_panels), in
// the storage type, elements from `base`. Block c of a cluster of C reads
// the panel at c * pstride: its columns of every chain product, each
// k-major (a row of k holds the block's columns, contiguous):
//   o_tok: w_ih_tok (E, 3U), its U note units' [r | z | n] columns;
//   o_h:   [w_pitch (Pc of pad4(P), zero past P) | w_dhid[:NH] (Dc) |
//          w_hh (3U)] (NH, Pc + Dc + 3U);
//   o_sih, o_shh: we_ih[d] (E, 3SU) and we_hh[d] (EH, 3SU), its SU summary
//          units of direction d (blocks [0, C/2) forward, the rest backward);
// and once for all blocks: o_wdc: [w_dout | w_dhh] (DH, 2 + 3DH); o_west:
// w_dhid[NH:] (P, DH). Every section starts 128 bytes aligned.
// Field order matches K1PanelsC (build.py).
template <typename T>
struct K1PanelsT {
  const T* base;
  int pstride, o_tok, o_h, o_sih, o_shh, o_wdc, o_west;
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

// The saved gates of one torch-order GRU step at hidden unit j: g = [r |
// z | n | h_n] (stride H).
struct Gates {
  float r, z, n, hn;
};

__device__ __forceinline__ Gates load_gates(const float* g, int H, int j) {
  return {g[j], g[H + j], g[2 * H + j], g[3 * H + j]};
}

// Backward of one torch-order GRU step from its saved gates: the
// input-gate cotangents [dr, dz, dn] in d_gi and the hidden-gate ones
// [dr, dz, dn * r] in d_gh; returns dh * z, the direct share of d h_prev.
__device__ __forceinline__ float gru_bwd(float dh, float h_prev, Gates g,
                                         float (&d_gi)[3], float (&d_gh)[3]) {
  const float dz = dh * (h_prev - g.n);
  const float dn = dh * (1.0f - g.z);
  const float dn_pre = dn * (1.0f - g.n * g.n);
  const float dz_pre = dz * g.z * (1.0f - g.z);
  const float dr_pre = dn_pre * g.hn * g.r * (1.0f - g.r);
  d_gi[0] = d_gh[0] = dr_pre;
  d_gi[1] = d_gh[1] = dz_pre;
  d_gi[2] = dn_pre;
  d_gh[2] = dn_pre * g.r;
  return dh * g.z;
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
// K1: forward, a row group a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int K1_STAGES = 2;           // the weight ring's stages
constexpr int K1_CONS = NT - 32;    // product threads: all warps but one
constexpr int K1_STAGE_MAX = 65536;    // bytes of a stage at most
constexpr int KPR = 4;                 // rows of a product unit
constexpr int K1_GI = 2;               // gate items a thread: DG U <= 2 NT

// The shares of block c of a cluster of C (part: whole quads).
struct K1Share {
  int j0, U, p0, Pc, d0, Dc, n1, n2, d, e0, SU;
};

template <typename T>
__host__ __device__ inline K1Share k1_share(const TrainWeightsT<T>& w, int C,
                                            int c) {
  K1Share h;
  const int Pp = pad4(w.P), Cd = C / 2;
  h.j0 = part(w.NH, C, c);
  h.U = part(w.NH, C, c + 1) - h.j0;
  h.p0 = part(Pp, C, c);
  h.Pc = part(Pp, C, c + 1) - h.p0;
  h.d0 = part(w.DH, C, c);
  h.Dc = part(w.DH, C, c + 1) - h.d0;
  h.n1 = 3 * h.U;
  h.n2 = h.Pc + h.Dc + 3 * h.U;
  h.d = c / Cd;
  h.e0 = part(w.EH, Cd, c - h.d * Cd);
  h.SU = part(w.EH, Cd, c - h.d * Cd + 1) - h.e0;
  return h;
}

// Shared memory of a K1 block, offsets in bytes. Kept for the whole launch:
// the mbarriers (ring full and empty, the staged constants, the summary's
// weights), the group's decisions and lengths, the owned rows' CE sums,
// w_emb's bit rows with b_emb, the biases the products' epilogues add
// (b_pitch, this block's b_hh, b_dhid, its be_ih and be_hh), the owned
// rows' targets, the coins and dur_sos. The chain region, written by other
// blocks in hf, tok, Y: the group's note hidden and next token, the owned
// rows' slot logits and dur-hidden shares; this block's hidden gates,
// token products and hidden products; the owned rows' duration state;
// then frame_h (the projection only), over it w_dcomb and w_dhid[NH:] in T
// and the weight ring. The summary region reuses the chain region after
// the chain's last cluster barrier: the direction's two hidden planes
// (written by other blocks), the hoisted input projections of all K slots,
// a slot's embeddings, the step's hidden gates, and this block's summary
// weights in T.
struct K1Layout {
  int C, nro, U, SU, n2, Pp, lN2;
  int lTH, lNH, lE, lU3, lYr, lDH, lDH3, lDC, lEH, lS3;
  int b_mbar, b_pitch, b_bits, b_own, b_len, b_nll, b_emb, b_bias, b_tgt,
      b_chain;
  int o_hf, o_tok, o_gh, o_acc, o_ys, o_Y, o_gid, o_bdc, o_hd, o_X, o_red,
      o_fh,
      o_wdc, o_west, o_ring;
  int o_hsd, o_gis, o_xs, o_sgo, o_ws;
  int stage, bytes;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

template <typename T>
__host__ __device__ inline K1Layout k1_layout(const TrainWeightsT<T>& w,
                                              int C) {
  K1Layout L;
  const int S = w.K - 1, ts = (int)sizeof(T), DC = 2 + 3 * w.DH;
  L.C = C;
  L.nro = DG / C;
  L.Pp = pad4(w.P);
  L.U = 4 * cdiv(w.NH / 4, C);
  L.SU = 4 * cdiv(w.EH / 4, C / 2);
  L.n2 = 4 * cdiv(L.Pp / 4, C) + 4 * cdiv(w.DH / 4, C) + 3 * L.U;
  L.lTH = pad4(w.TH);
  L.lNH = pad4(w.NH);
  L.lE = pad4(w.E);
  L.lU3 = pad4(3 * L.U);
  L.lDH = pad4(w.DH);
  L.lDH3 = pad4(3 * w.DH);
  L.lDC = pad4(DC);
  L.lYr = L.Pp + L.lDH;
  L.lEH = pad4(w.EH);
  L.lS3 = pad4(3 * L.SU);
  L.lN2 = pad4(L.n2);
  int b = 0;
  L.b_mbar = b;  b += 8 * (2 * K1_STAGES + 2);
  L.b_own = b;   b += 4 * L.nro * (1 + w.W);
  L.b_len = b;   b += 4 * DG;
  L.b_nll = b;   b += 4 * L.nro * 8;
  L.b_emb = b;   b += 4 * (w.W + 1) * L.lE;
  L.b_bias = b;  b += 4 * (L.Pp + L.lU3 + L.lDH + 2 * L.lS3);
  L.b_tgt = b;   b += 4 * (L.nro * S * (1 + w.W) + w.K + pad4(w.W));
  L.b_pitch = b; b += 2 * DG * S;
  L.b_bits = b;  b += DG * S * w.W;
  L.b_chain = b = align128(b);
  L.o_hf = b;   b += 4 * DG * L.lNH;
  L.o_tok = b;  b += 4 * DG * L.lE;
  L.o_gh = b;   b += 4 * DG * L.lU3;
  L.o_acc = b;  b += 4 * DG * L.lU3;
  L.o_ys = b;   b += 4 * DG * L.lN2;
  L.o_Y = b;    b += 4 * L.nro * L.lYr;
  L.o_gid = b;  b += 4 * 3 * L.lDH3;
  L.o_bdc = b;  b += 4 * L.lDC;
  L.o_hd = b;   b += 4 * L.nro * L.lDH;
  L.o_X = b;    b += 4 * L.nro * L.lDC;
  L.o_red = b;  b += 4 * L.nro * NT;
  L.o_fh = L.o_wdc = b = align128(b);
  b = align128(b + ts * w.DH * DC);
  L.o_west = b;
  b = align128(b + ts * w.P * w.DH);
  L.o_ring = b;
  const int fh_end = L.o_fh + 4 * DG * L.lTH;
  int stage = (DEC_MAX_SMEM - b) / K1_STAGES & ~127;
  L.stage = stage < K1_STAGE_MAX ? stage : K1_STAGE_MAX;
  int chain_end = imax2(b + K1_STAGES * L.stage, fh_end);
  b = L.b_chain;
  L.o_hsd = b;  b += 4 * 2 * DG * L.lEH;
  L.o_gis = b;  b += 4 * w.K * DG * L.lS3;
  L.o_xs = b;   b += 4 * DG * L.lE;
  L.o_sgo = b;  b += 4 * DG * L.lS3;
  L.o_ws = b = align128(b);
  b += ts * imax2(w.E, w.EH) * 3 * L.SU;
  L.bytes = imax2(chain_end, b);
  return L;
}

// What K1's row-group kernel takes beyond the cluster size (8 or 16): a
// block's shared memory fits, the ring holds 4 rows of the widest
// product, the products' units fit the product threads, an owned row's
// duration units and embedding fit a block, a summary step's embeddings
// fit XI a thread, the gate items K1_GI a thread. The wrapper checks that
// TH, NH, DH, E, EH are multiples of 4.
template <typename T>
__host__ __device__ inline bool k1_fits(const TrainWeightsT<T>& w,
                                        const K1Layout& L) {
  const int ts = (int)sizeof(T), RH = DG / KPR;
  return L.bytes <= DEC_MAX_SMEM && L.stage >= 4 * L.n2 * ts &&
         L.stage >= 4 * 3 * L.U * ts && RH * (L.n2 / PJ) <= K1_CONS &&
         RH * (3 * L.SU / PJ) <= NT && RH * (3 * L.U / PJ) <= NT &&
         L.nro * w.DH <= NT && L.nro * w.E <= NT && DG * w.E <= XI * NT &&
         DG * L.U <= K1_GI * NT;
}

// ---- mbarriers and bulk copies (the weight ring)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* b,
                                            int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both ends 16 bytes aligned) from global memory
// into this block's shared memory, completing on mbarrier b
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// earlier generic accesses of shared memory before later async-proxy
// writes into it
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// v into element p of the shared memory of block `rank` of the cluster
// (32-bit shared::cluster addresses; float, short or unsigned char)
__device__ __forceinline__ unsigned remote(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void st_remote(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote(p, rank)),
               "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_remote(short* p, int rank, short v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(remote(p, rank)),
               "h"(v)
               : "memory");
}
__device__ __forceinline__ void st_remote(unsigned char* p, int rank,
                                          unsigned char v) {
  asm volatile("st.shared::cluster.u8 [%0], %1;\n" ::"r"(remote(p, rank)),
               "r"((unsigned)v)
               : "memory");
}
// v into element p of every block of ranks [r0, r0 + n) of the cluster
__device__ __forceinline__ void push_ranks(int r0, int n, float* p,
                                           float v) {
  const unsigned a = smem_u32(p);
  for (int cc = r0; cc < r0 + n; ++cc) {
    unsigned ra;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(ra)
                 : "r"(a), "r"(cc));
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(ra), "f"(v)
                 : "memory");
  }
}

// ---- products on weights in shared memory

// a thread's unit of a product of n columns over the DG rows: KPR rows x PJ
// columns, its k-quads dealt round robin to the unit's sl lanes. Lane slice
// s = lane / per_warp, so that the 8 lanes of a quarter warp read 8
// neighbouring column quads of one weight row: one conflict-free read.
struct Unit {
  int sl, s, per_warp, r0, c0;
  bool live;
};

__device__ __forceinline__ Unit unit_of(int n, int threads) {
  const int t = threadIdx.x, lane = t & 31;
  const int nq = (DG / KPR) * (n / PJ);
  int sl = 1;
  while (sl < 8 && nq * sl * 2 <= threads) sl *= 2;
  Unit u;
  u.sl = sl;
  u.per_warp = 32 / sl;
  u.s = lane / u.per_warp;
  const int p = (t >> 5) * u.per_warp + lane % u.per_warp;
  const int Q = imax2(n / PJ, 1);
  u.live = t < threads && p < nq;
  u.r0 = u.live ? p / Q * KPR : 0;
  u.c0 = u.live ? PJ * (p - p / Q * Q) : 0;
  return u;
}

__device__ __forceinline__ float4 sm4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 sm4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// acc[r][j] += sum over the unit's k-quads of x[r0 + r][k0 + k] W[k][c0 + j],
// k < rows (a multiple of 4); W (rows, n) in shared memory, x row stride
// ldx. Each thread sums its quads in order.
template <typename T>
__device__ __forceinline__ void unit_fma(const T* W, int n, int rows,
                                         const float* x, int ldx, int k0,
                                         const Unit& u,
                                         float (&acc)[KPR][PJ]) {
  if (!u.live) return;
  const T* wc = W + u.c0;
  const float* xr = x + u.r0 * ldx + k0;
  for (int k = 4 * u.s; k < rows; k += 4 * u.sl) {
    float4 wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wv[kk] = sm4(wc + (k + kk) * n);
#pragma unroll
    for (int r = 0; r < KPR; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(xr + r * ldx + k);
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
}

// the unit's lanes' sums meet (xor shuffles: every lane ends with the same
// bits); lane slice 0 hands each of its KPR x PJ outputs to out(r, col, v).
// Every lane of the warp calls it.
template <typename F>
__device__ __forceinline__ void unit_finish(const Unit& u,
                                            float (&acc)[KPR][PJ], F&& out) {
  for (int off = u.per_warp; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < KPR; ++r)
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
  if (u.live && u.s == 0) {
#pragma unroll
    for (int r = 0; r < KPR; ++r)
#pragma unroll
      for (int j = 0; j < PJ; ++j) out(u.r0 + r, u.c0 + j, acc[r][j]);
  }
}

// A product whose weights (in, n) are staged whole in shared memory, over
// all the block's threads; ends synchronized.
template <typename T, typename F>
__device__ __forceinline__ void staged_product(const T* W, int n, int in,
                                               const float* x, int ldx,
                                               F&& out) {
  const Unit u = unit_of(n, NT);
  float acc[KPR][PJ];
#pragma unroll
  for (int r = 0; r < KPR; ++r)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[r][j] = 0.0f;
  unit_fma(W, n, in, x, ldx, 0, u, acc);
  unit_finish(u, acc, out);
  __syncthreads();
}

// X[ro] = hd[ro] @ Wd + bd for the NRO owned rows (Wd (DH, DC) and bd in
// shared memory): a thread an output, its k dealt to 4 accumulators (k %
// 4) summed in order at the end, so that the dependent chain is DH / 4
// long; no partial sums cross threads. Every thread calls it; it ends
// synchronized.
template <int NRO, typename T>
__device__ __forceinline__ void dur_step(const T* Wd, const float* bd,
                                         int DH, int DC, const float* hd,
                                         int lDH, float* X, int lDC) {
  for (int q = threadIdx.x; q < NRO * DC; q += NT) {
    const int ro = q / DC, j = q - ro * DC;
    const float* h = hd + ro * lDH;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = 0;
#pragma unroll 4
    for (; k + 4 <= DH; k += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = fmaf(h[k + u], to_f(Wd[(k + u) * DC + j]), a[u]);
    for (; k < DH; ++k) a[0] = fmaf(h[k], to_f(Wd[k * DC + j]), a[0]);
    X[ro * lDC + j] = ((a[0] + a[1]) + (a[2] + a[3])) + bd[j];
  }
  __syncthreads();
}

// The weight ring: this block's panel streams through K1_STAGES stages of
// `stage` bytes, chunk i (whole k-rows of one product) into stage i %
// K1_STAGES. A slot's chunks: P1 (the token product, w_ih_tok), then P2
// (the hidden product, [w_pitch | w_dhid[:NH] | w_hh]), the same panels
// every slot. full[s] completes when a chunk has landed, empty[s] when the
// product warps have read it. One thread (lane 0 of the last warp) issues the
// bulk copies: up to K1_STAGES chunks ahead of the products, so that the
// next slot's first chunks land while the cluster exchanges this slot's
// results and runs its duration chains.
template <typename T>
struct Ring {
  char* stages;
  unsigned long long *full, *empty;
  const T* panel;
  int stage, n1, kt1, nc1, n2, kt2, nc2, E, NH, o_tok, o_h;
  int total, next, issued;
};

template <typename T>
__device__ __forceinline__ void ring_issue(Ring<T>& rg, int upto) {
  if (upto > rg.total) upto = rg.total;
  const int cps = rg.nc1 + rg.nc2;
  for (; rg.issued < upto; ++rg.issued) {
    const int i = rg.issued, s = i % K1_STAGES, j = i % cps;
    if (i >= K1_STAGES) mbar_wait(rg.empty + s, (i / K1_STAGES - 1) & 1);
    const T* src;
    int bytes;
    if (j < rg.nc1) {
      const int k0 = j * rg.kt1;
      src = rg.panel + rg.o_tok + (size_t)k0 * rg.n1;
      bytes = min(rg.kt1, rg.E - k0) * rg.n1 * (int)sizeof(T);
    } else {
      const int k0 = (j - rg.nc1) * rg.kt2;
      src = rg.panel + rg.o_h + (size_t)k0 * rg.n2;
      bytes = min(rg.kt2, rg.NH - k0) * rg.n2 * (int)sizeof(T);
    }
    fence_async_shared();
    mbar_expect(rg.full + s, bytes);
    bulk_load(rg.stages + (size_t)s * rg.stage, src, bytes, rg.full + s);
  }
}

// Product P1 (which = 1) or P2 (2) of a slot from the ring, x (DG rows,
// stride ldx) in shared memory; outputs to out(r, col, v). Every thread
// calls it; it ends synchronized.
template <typename T, typename F>
__device__ __forceinline__ void ring_product(Ring<T>& rg, int which,
                                             const float* x, int ldx,
                                             F&& out) {
  const int n = which == 1 ? rg.n1 : rg.n2;
  const int nc = which == 1 ? rg.nc1 : rg.nc2;
  const int kt = which == 1 ? rg.kt1 : rg.kt2;
  const int in = which == 1 ? rg.E : rg.NH;
  const int first = rg.next, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  rg.next += nc;
  if (warp < K1_CONS / 32) {
    const Unit u = unit_of(n, K1_CONS);
    float acc[KPR][PJ];
#pragma unroll
    for (int r = 0; r < KPR; ++r)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[r][j] = 0.0f;
    for (int j = 0; j < nc; ++j) {
      const int i = first + j, s = i % K1_STAGES;
      mbar_wait(rg.full + s, (i / K1_STAGES) & 1);
      const int k0 = j * kt;
      unit_fma(reinterpret_cast<const T*>(rg.stages + (size_t)s * rg.stage),
               n, min(kt, in - k0), x, ldx, k0, u, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(rg.empty + s);
    }
    unit_finish(u, acc, out);
  } else if (lane == 0) {
    ring_issue(rg, first + nc + K1_STAGES);
  }
  __syncthreads();
}

// phases of a K1 launch (build.K1_PHASES): the frame projection, the note
// chain (the token and hidden products from the ring, the note-GRU step,
// the pitch argmax and CE, the next token; three cluster barriers a
// slot), the owned rows' dur-hidden init and duration chains, the summary,
// and for timing only the chain's cluster barriers alone. A phase launched
// alone reads zeros where the ones before it would have written.
constexpr int K1_ALL = PH_PROJ | PH_NOTE | PH_DUR | PH_SUMM;

// K1 replaces pctd_tpu/ops/pallas/train_frame.py::_fwd_kernel (see the note
// at the top): the frame of a group of DG rows in a cluster of C blocks,
// NRO = DG / C owned rows a block (row r: block r % C).
template <int NRO, typename T>
__global__ void __launch_bounds__(NT, 1)
train_fwd_group_kernel(TrainWeightsT<T> w, K1PanelsT<T> pn, int B,
                       int phases, const int* __restrict__ coins,
                       const T* __restrict__ frame_h,
                       const T* __restrict__ x_emb,
                       const int* __restrict__ gt_pitch,
                       const int* __restrict__ gt_dur,
                       float* __restrict__ nums_rows,
                       T* __restrict__ pitch_logits,
                       T* __restrict__ dur_logits, T* __restrict__ summary,
                       int* __restrict__ lengths, int* __restrict__ decisions,
                       TrainStashT<T> st, int stash, int logits) {
  // loss mode (logits == 0): gt_pitch, gt_dur -> nums_rows (B, 1+W);
  // logits out: pitch_logits (B, K-1, P) and dur_logits (B, K-1, W, 2),
  // batch-major, and the targets are not read.
  extern __shared__ float4 smem4[];
  char* sb = reinterpret_cast<char*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), c = cl.block_rank(), t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const K1Layout L = k1_layout(w, C);
  const K1Share h = k1_share(w, C, c);
  const int row0 = blockIdx.x / C * DG, nrows = min(DG, B - row0);
  const int TH = w.TH, NH = w.NH, NH3 = 3 * w.NH, DH = w.DH, DH3 = 3 * w.DH,
            DC = 2 + 3 * w.DH, E = w.E, EH = w.EH, P = w.P, W = w.W,
            K = w.K, S = w.K - 1;
  const int j0 = h.j0, U = h.U;
  const bool note = phases & PH_NOTE, dur = phases & PH_DUR;
  unsigned long long* mb =
      reinterpret_cast<unsigned long long*>(sb + L.b_mbar);
  unsigned long long *cbar = mb + 2 * K1_STAGES, *sbar = cbar + 1;
  int* own = reinterpret_cast<int*>(sb + L.b_own);     // [NRO][1 + W]
  int* len = reinterpret_cast<int*>(sb + L.b_len);     // [DG]
  float* nll = reinterpret_cast<float*>(sb + L.b_nll);  // [NRO][8]
  float* emb = reinterpret_cast<float*>(sb + L.b_emb);  // bit rows, b_emb
  float* bia = reinterpret_cast<float*>(sb + L.b_bias);  // b_pitch
  float *bhh = bia + L.Pp, *bdh = bhh + L.lU3, *bsi = bdh + L.lDH,
        *bsh = bsi + L.lS3;
  int* tgt = reinterpret_cast<int*>(sb + L.b_tgt);  // [NRO][S][1 + W]
  int* coins_s = tgt + NRO * S * (1 + W);           // [K]: slot k's
  float* dsos = reinterpret_cast<float*>(coins_s + K);  // dur_sos
  short* pitch = reinterpret_cast<short*>(sb + L.b_pitch);  // [DG][S]
  unsigned char* bits = reinterpret_cast<unsigned char*>(sb + L.b_bits);
  float* hf = reinterpret_cast<float*>(sb + L.o_hf);
  float* tok = reinterpret_cast<float*>(sb + L.o_tok);
  float* gh = reinterpret_cast<float*>(sb + L.o_gh);
  float* acc = reinterpret_cast<float*>(sb + L.o_acc);
  float* ys = reinterpret_cast<float*>(sb + L.o_ys);
  float* Y = reinterpret_cast<float*>(sb + L.o_Y);
  float* gid = reinterpret_cast<float*>(sb + L.o_gid);
  float* bdc = reinterpret_cast<float*>(sb + L.o_bdc);
  float* hd = reinterpret_cast<float*>(sb + L.o_hd);
  float* X = reinterpret_cast<float*>(sb + L.o_X);
  float* red = reinterpret_cast<float*>(sb + L.o_red);
  float* fh = reinterpret_cast<float*>(sb + L.o_fh);
  const T* wdc = reinterpret_cast<const T*>(sb + L.o_wdc);
  const T* west = reinterpret_cast<const T*>(sb + L.o_west);
  // stash row (slot k, group row r) -> index (k * B + row0 + r)
  auto srow = [&](int k, int r) { return (size_t)k * B + row0 + r; };
  const T* panel = pn.base + (size_t)c * pn.pstride;

  // ---- init: barriers, zeros, the constants of the serial steps, frame_h
  if (t == 0) {
    for (int s = 0; s < K1_STAGES; ++s) {
      mbar_init(mb + s, 1);
      mbar_init(mb + K1_STAGES + s, K1_CONS / 32);
    }
    mbar_init(cbar, 1);
    mbar_init(sbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < (L.o_gid - L.o_hf) / 4; i += NT) hf[i] = 0.0f;
  for (int i = t; i < NRO * (1 + W); i += NT) own[i] = 0;
  for (int i = t; i < NRO * 8; i += NT) nll[i] = 0.0f;
  for (int i = t; i < DG * S; i += NT) pitch[i] = 0;
  for (int i = t; i < DG * S * W; i += NT) bits[i] = 0;
  for (int i = t; i < (W + 1) * E; i += NT) {
    const int q = i / E, e = i - q * E;
    emb[q * L.lE + e] = ldg_f(q < W ? w.w_emb + (size_t)(P + q) * E + e
                                    : w.b_emb + e);
  }
  for (int i = t; i < DH3; i += NT) {
    // the dur GRU's gi rows: dur_sos @ w_dih + b_dih (f32), and the
    // feedback rows w_dih[b] + b_dih, a sum of two values of T
    float v = 0.0f;
    for (int q = 0; q < W; ++q)
      v = fmaf(ldg_f(w.dur_sos + q), ldg_f(w.w_dih + q * DH3 + i), v);
    const float bi = ldg_f(w.b_dih + i);
    gid[i] = v + bi;
    gid[L.lDH3 + i] = round_to<T>(ldg_f(w.w_dih + i) + bi);
    gid[2 * L.lDH3 + i] = round_to<T>(ldg_f(w.w_dih + DH3 + i) + bi);
  }
  for (int i = t; i < DC; i += NT)
    bdc[i] = ldg_f(i < 2 ? w.b_dout + i : w.b_dhh + i - 2);
  for (int i = t; i < L.Pp; i += NT)
    bia[i] = i < P ? ldg_f(w.b_pitch + i) : 0.0f;
  for (int i = t; i < 3 * U; i += NT) {
    const int g = i / U;
    bhh[i] = ldg_f(w.b_hh + g * NH + j0 + i - g * U);
  }
  for (int i = t; i < DH; i += NT) bdh[i] = ldg_f(w.b_dhid + i);
  for (int i = t; !logits && i < NRO * S * (1 + W); i += NT) {
    const int ro = i / (S * (1 + W)), q = i - ro * S * (1 + W);
    const int r = c + C * ro, k = q / (1 + W), f = q - k * (1 + W);
    tgt[i] = r >= nrows ? 0
             : f == 0   ? gt_pitch[(size_t)(row0 + r) * S + k]
                        : gt_dur[((size_t)(row0 + r) * S + k) * W + f - 1];
  }
  for (int i = t; i < K; i += NT) coins_s[i] = i >= 1 ? coins[i - 1] : 0;
  for (int i = t; i < W; i += NT) dsos[i] = ldg_f(w.dur_sos + i);
  for (int i = t; i < 3 * h.SU; i += NT) {
    const int g = i / h.SU, o = h.d * 3 * EH + g * EH + h.e0 + i - g * h.SU;
    bsi[i] = ldg_f(w.be_ih + o);
    bsh[i] = ldg_f(w.be_hh + o);
  }
  for (int idx = t; idx < DG * TH; idx += NT) {
    const int r = idx / TH, j = idx - r * TH;
    fh[r * L.lTH + j] =
        r < nrows ? to_f(frame_h[(size_t)(row0 + r) * TH + j]) : 0.0f;
  }
  for (int idx = t; idx < DG * E; idx += NT) {
    const int r = idx / E, e = idx - r * E;
    const T v = r < nrows ? x_emb[(size_t)(row0 + r) * K * E + e]
                          : from_f<T>(0.0f);
    tok[r * L.lE + e] = to_f(v);
    if (stash && r < nrows && r % C == c) {
      st.tok[srow(0, r) * E + e] = v;
      st.pred[srow(0, r) * E + e] = v;
    }
  }
  __syncthreads();
  cl.sync();   // every block's barriers and zeros before any push

  // the ring over this block's panel
  Ring<T> rg;
  rg.stages = sb + L.o_ring;
  rg.full = mb;
  rg.empty = mb + K1_STAGES;
  rg.panel = panel;
  rg.stage = L.stage;
  rg.E = E;
  rg.NH = NH;
  rg.o_tok = pn.o_tok;
  rg.o_h = pn.o_h;
  rg.n1 = h.n1;
  rg.n2 = h.n2;
  rg.kt1 = h.n1 ? min(pad4(E), L.stage / (h.n1 * (int)sizeof(T)) & ~3) : 1;
  rg.kt2 = min(pad4(NH), L.stage / (h.n2 * (int)sizeof(T)) & ~3);
  rg.nc1 = h.n1 ? cdiv(E, rg.kt1) : 0;
  rg.nc2 = h.n2 ? cdiv(NH, rg.kt2) : 0;
  rg.total = note ? S * (rg.nc1 + rg.nc2) : 0;
  rg.next = rg.issued = 0;

  // this thread's gate items (r, u) = idx / U, idx % U: their gi_frame
  float gf[K1_GI][3];
#pragma unroll
  for (int i = 0; i < K1_GI; ++i) gf[i][0] = gf[i][1] = gf[i][2] = 0.0f;

  // ---- projection: h0 and gi_frame of this block's units, then the first
  // hidden gates; its weights are read once from L2 for the group
  if (phases & PH_PROJ) {
    Seg<T> sg[4];
    sg[0] = seg(w.w_t2n + j0, w.b_t2n + j0, NH, U, TH, fh, L.lTH, gh, L.lU3);
#pragma unroll
    for (int g = 0; g < 3; ++g)
      sg[1 + g] = seg(w.w_ih_frame + g * NH + j0, w.b_ih + g * NH + j0, NH3,
                      U, TH, fh, L.lTH, acc + g * U, L.lU3);
    group_product(sg);
  }
  // frame_h is read: the constants and the ring's first chunks come in
  if (t == NT - 32) {
    fence_async_shared();
    // (the panel pads each section to 128 bytes: whole 16-byte copies)
    const int b1 = (DH * DC * (int)sizeof(T) + 15) & ~15,
              b2 = (P * DH * (int)sizeof(T) + 15) & ~15;
    mbar_expect(cbar, b1 + b2);
    bulk_load(sb + L.o_wdc, pn.base + pn.o_wdc, b1, cbar);
    bulk_load(sb + L.o_west, pn.base + pn.o_west, b2, cbar);
    ring_issue(rg, K1_STAGES);
  }
  if (phases & PH_PROJ) {
#pragma unroll
    for (int i = 0; i < K1_GI; ++i) {
      const int idx = t + i * NT, r = idx / imax2(U, 1), u = idx - r * U;
      if (idx >= DG * U) continue;
      const float* a = acc + r * L.lU3;
      gf[i][0] = a[u];
      gf[i][1] = a[U + u];
      gf[i][2] = a[2 * U + u];
      const float h0 = round_to<T>(gh[r * L.lU3 + u]);
      push_ranks(0, C, hf + r * L.lNH + j0 + u, h0);
      if (stash && r < nrows) st.hs[srow(0, r) * NH + j0 + u] = from_f<T>(h0);
    }
    cl.sync();
    Seg<T> sg[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      sg[g] = seg(w.w_hh + g * NH + j0, w.b_hh + g * NH + j0, NH3, U, NH, hf,
                  L.lNH, gh + g * U, L.lU3);
    group_product(sg);
  }
  cl.sync();   // every block has read h0 before the first slot's h comes
  mbar_wait(cbar, 0);

  // ---- the slot chain
  if (phases & PH_BARRIERS) {
    for (int k = 1; k < K; ++k) {
      cl.sync();
      cl.sync();
      cl.sync();
    }
  }
  for (int k = 1; k < K; ++k) {
    if (note) {
      // P1: this block's columns of tok @ w_ih_tok
      ring_product(rg, 1, tok, L.lE, [&](int r, int col, float v) {
        acc[r * L.lU3 + col] = v;
      });
      // the note-GRU step on this block's units, h into every block
#pragma unroll
      for (int i = 0; i < K1_GI; ++i) {
        const int idx = t + i * NT, r = idx / imax2(U, 1), u = idx - r * U;
        if (idx >= DG * U) continue;
        const float* a = acc + r * L.lU3;
        const float* g = gh + r * L.lU3;
        const float ir = gf[i][0] + a[u], iz = gf[i][1] + a[U + u],
                    in_ = gf[i][2] + a[2 * U + u];
        const float rr = sigmoid_(ir + g[u]);
        const float zz = sigmoid_(iz + g[U + u]);
        const float nn = tanhf(in_ + rr * g[2 * U + u]);
        const int j = j0 + u;
        const float hv = hf[r * L.lNH + j];
        const float hnew = round_to<T>((1.0f - zz) * nn + zz * hv);
        push_ranks(0, C, hf + r * L.lNH + j, hnew);
        if (stash && r < nrows) {
          float* ngp = st.ng + srow(k - 1, r) * 4 * NH;
          ngp[j] = rr;
          ngp[NH + j] = zz;
          ngp[2 * NH + j] = nn;
          ngp[3 * NH + j] = g[2 * U + u];
          st.hs[srow(k, r) * NH + j] = from_f<T>(hnew);
        }
      }
      cl.sync();
      // P2: this block's columns of h @ [w_pitch | w_dhid[:NH] | w_hh] into
      // ys, then over every thread: the pitch logits and the dur-hidden
      // shares to the rows' owners (and the stash, the logits out), the
      // next hidden gates kept
      ring_product(rg, 2, hf, L.lNH, [&](int r, int col, float v) {
        ys[r * L.lN2 + col] = v;
      });
      for (int idx = t; idx < DG * h.n2; idx += NT) {
        const int r = idx / h.n2, col = idx - r * h.n2;
        const float v = ys[r * L.lN2 + col];
        if (col < h.Pc) {
          const int p = h.p0 + col;
          if (p >= P) continue;
          const float y = round_to<T>(v + bia[p]);
          st_remote(Y + (r / C) * L.lYr + p, r % C, y);
          if (r < nrows) {
            if (stash) st.est[srow(k - 1, r) * P + p] = from_f<T>(y);
            if (logits)
              pitch_logits[((size_t)(row0 + r) * S + k - 1) * P + p] =
                  from_f<T>(y);
          }
        } else if (col < h.Pc + h.Dc) {
          st_remote(Y + (r / C) * L.lYr + L.Pp + h.d0 + col - h.Pc, r % C,
                    v);
        } else {
          const int q = col - h.Pc - h.Dc;
          gh[r * L.lU3 + q] = v + bhh[q];
        }
      }
      cl.sync();
    }
    // ---- the owned rows r = c + C ro: pitch argmax and CE (warp ro)
    if (note && warp < NRO) {
      const int ro = warp, r = c + C * ro;
      const float* y = Y + ro * L.lYr;
      float best = -INFINITY;
      int bi = P;
      for (int j = lane; j < P; j += 32) {
        const float v = y[j];
        if (v > best) {
          best = v;
          bi = j;
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
      bi = __shfl_sync(0xffffffffu, bi, 0);
      const float lse = logits ? 0.0f : warp_lse(y, P, lane);
      if (lane == 0) {
        if (bi >= P) bi = 0;
        own[ro * (1 + W)] = bi;
        if (!logits && r < nrows) {
          const int gt = tgt[(ro * S + k - 1) * (1 + W)];
          if (gt != w.pitch_pad) nll[ro * 8] += lse - y[gt];
        }
      }
    }
    __syncthreads();
    // the next token's embedding row and teacher row, loaded ahead of the
    // duration chains: thread t < NRO E holds element e of owned row ro
    const int er = t / imax2(E, 1), ee = t - er * E;
    const bool emb_mine = note && t < NRO * E;
    const int erow = c + C * er;
    const int coin = k < K - 1 && coins_s[k] != 0;
    float pe = 0.0f, xe = 0.0f;
    if (emb_mine) {
      pe = ldg_f(w.w_emb + (size_t)own[er * (1 + W)] * E + ee);
      if (coin && erow < nrows)
        xe = ldg_f(x_emb + ((size_t)(row0 + erow) * K + k) * E + ee);
    }
    if (dur) {
      // dur-hidden init: hd0 = [h | est] @ w_dhid + b_dhid, the h share
      // from the blocks' P2 columns, est @ w_dhid[NH:] here in k-slices
      const int n = NRO * DH;
      int ns = NT / imax2(n, 1);
      ns = ns > 8 ? 8 : (ns < 1 ? 1 : ns);
      const int chunk = cdiv(P, ns);
      for (int q = t; q < ns * n; q += NT) {
        const int sl = q / n, o = q - sl * n, ro = o / DH, j = o - ro * DH;
        const int k0 = sl * chunk, k1 = min(P, k0 + chunk);
        const float* y = Y + ro * L.lYr;
        float a = 0.0f;
        for (int i = k0; i < k1; ++i)
          a = fmaf(y[i], to_f(west[i * DH + j]), a);
        red[q] = a;
      }
      __syncthreads();
      const bool mine = t < NRO * DH;
      const int ro = t / imax2(DH, 1), j = t - ro * DH, r = c + C * ro;
      float gs[3], g0[3], g1[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        gs[g] = mine ? gid[g * DH + j] : 0.0f;
        g0[g] = mine ? gid[L.lDH3 + g * DH + j] : 0.0f;
        g1[g] = mine ? gid[2 * L.lDH3 + g * DH + j] : 0.0f;
      }
      if (mine) {
        float v = 0.0f;
        for (int sl = 0; sl < ns; ++sl) v += red[sl * n + t];
        v = round_to<T>(v + Y[ro * L.lYr + L.Pp + j] + bdh[j]);
        hd[ro * L.lDH + j] = v;
        if (stash && r < nrows)
          st.hd[(srow(k - 1, r) * (W + 1)) * DH + j] = from_f<T>(v);
      }
      __syncthreads();
      // its hidden gates, then W steps of the duration GRU with the argmax
      // bit fed back (w_dcomb = [w_dout | w_dhh] staged)
      dur_step<NRO>(wdc, bdc, DH, DC, hd, L.lDH, X, L.lDC);
      // each unit's thread decides the step's bit from the rounded logits
      // itself (no barrier); unit 0's thread keeps it and its CE
      int b = 0;
      for (int ws = 0; ws < W; ++ws) {
        if (mine) {
          const float* x = X + ro * L.lDC;
          const float* gi = ws == 0 ? gs : (b ? g1 : g0);
          const float* g = x + 2;
          const float rr = sigmoid_(gi[0] + g[j]);
          const float zz = sigmoid_(gi[1] + g[DH + j]);
          const float nn = tanhf(gi[2] + rr * g[2 * DH + j]);
          const float hv = hd[ro * L.lDH + j];
          const float hnew = round_to<T>((1.0f - zz) * nn + zz * hv);
          hd[ro * L.lDH + j] = hnew;
          if (stash && r < nrows) {
            const size_t q = srow(k - 1, r) * W + ws;
            float* dgp = st.dg + q * 4 * DH;
            dgp[j] = rr;
            dgp[DH + j] = zz;
            dgp[2 * DH + j] = nn;
            dgp[3 * DH + j] = g[2 * DH + j];
            st.hd[(srow(k - 1, r) * (W + 1) + ws + 1) * DH + j] =
                from_f<T>(hnew);
            if (j < W)
              st.dtok[q * W + j] = from_f<T>(ws == 0 ? dsos[j]
                                                     : (j == b ? 1.0f : 0.0f));
          }
        }
        __syncthreads();
        dur_step<NRO>(wdc, bdc, DH, DC, hd, L.lDH, X, L.lDC);
        if (mine) {
          const float* x = X + ro * L.lDC;
          const float l0 = round_to<T>(x[0]), l1 = round_to<T>(x[1]);
          b = l1 > l0 ? 1 : 0;
          if (j == 0) {
            own[ro * (1 + W) + 1 + ws] = b;
            if (r < nrows) {
              if (logits) {
                T* o = dur_logits +
                       (((size_t)(row0 + r) * S + k - 1) * W + ws) * 2;
                o[0] = from_f<T>(l0);
                o[1] = from_f<T>(l1);
              } else {
                const int gt = tgt[(ro * S + k - 1) * (1 + W) + 1 + ws];
                if (gt != w.dur_pad)
                  nll[ro * 8 + 1 + ws] += lse2(l0, l1) - (gt ? l1 : l0);
              }
              if (stash) {
                T* dl = st.dlog + (srow(k - 1, r) * W + ws) * 2;
                dl[0] = from_f<T>(l0);
                dl[1] = from_f<T>(l1);
              }
            }
          }
        }
      }
      __syncthreads();
    }
    if (note) {
      // the predicted note's embedding (a row select of the one-hot
      // product), the coin's pick of the next token into every block, the
      // decisions into every block
      if (emb_mine) {
        const int* o = own + er * (1 + W);
        float v = pe;
        for (int ws = 0; ws < W; ++ws)
          if (o[1 + ws]) v += emb[ws * L.lE + ee];
        v = round_to<T>(v + emb[W * L.lE + ee]);
        const float nt = coin ? (erow < nrows ? xe : 0.0f) : v;
        if (k < K - 1) push_ranks(0, C, tok + erow * L.lE + ee, nt);
        if (stash && erow < nrows) {
          st.pred[srow(k, erow) * E + ee] = from_f<T>(v);
          if (k < K - 1) st.tok[srow(k, erow) * E + ee] = from_f<T>(nt);
        }
      }
      for (int i = t; i < NRO * C * (1 + W); i += NT) {
        const int ro = i / (C * (1 + W)), q = i - ro * C * (1 + W);
        const int cc = q / (1 + W), f = q - cc * (1 + W), r = c + C * ro;
        const int v = own[ro * (1 + W) + f];
        if (f == 0)
          st_remote(pitch + r * S + k - 1, cc, static_cast<short>(v));
        else
          st_remote(bits + (r * S + k - 1) * W + f - 1, cc,
                    static_cast<unsigned char>(v));
      }
      if (stash) {
        for (int i = t; i < NRO * (P + W); i += NT) {
          const int ro = i / (P + W), j = i - ro * (P + W), r = c + C * ro;
          if (r >= nrows) continue;
          const int* o = own + ro * (1 + W);
          st.emb_in[srow(k - 1, r) * (P + W) + j] = from_f<T>(
              j < P ? (j == o[0] ? 1.0f : 0.0f) : (float)o[1 + j - P]);
        }
      }
      cl.sync();
    }
  }

  // ---- lengths: the first slot that decided eos, else K - 1
  for (int r = t; r < DG; r += NT) {
    int l = 0;
    for (int k = 1; k < K && !l; ++k)
      if (pitch[r * S + k - 1] == w.eos) l = k;
    len[r] = l ? l : K - 1;
  }
  for (int i = t; i < NRO * S * (1 + W); i += NT) {
    const int ro = i / (S * (1 + W)), q = i - ro * S * (1 + W);
    const int r = c + C * ro, k = q / (1 + W), f = q - k * (1 + W);
    if (r < nrows)
      decisions[(size_t)(row0 + r) * S * (1 + W) + q] =
          f == 0 ? pitch[r * S + k] : bits[(r * S + k) * W + f - 1];
  }
  for (int i = t; !logits && i < NRO * (1 + W); i += NT) {
    const int ro = i / (1 + W), q = i - ro * (1 + W), r = c + C * ro;
    if (r < nrows)
      nums_rows[(size_t)(row0 + r) * (1 + W) + q] = nll[ro * 8 + q];
  }
  __syncthreads();
  for (int ro = t; ro < NRO; ro += NT) {
    const int r = c + C * ro;
    if (r < nrows) lengths[row0 + r] = len[r];
  }

  // ---- the masked bi-GRU over pred: blocks [0, C/2) forward, the rest
  // backward, SU units each; the input projections of all K slots first
  // (hoisted, as _summary_fwd does), then K steps on we_hh alone; step k
  // runs slot k forward, K-1-k backward
  if (phases & PH_SUMM) {
    const int Cd = C / 2, d = h.d, e0 = h.e0, SU = h.SU, n3 = 3 * SU;
    float* hsd = reinterpret_cast<float*>(sb + L.o_hsd);
    float* gis = reinterpret_cast<float*>(sb + L.o_gis);
    float* xs = reinterpret_cast<float*>(sb + L.o_xs);
    float* sgo = reinterpret_cast<float*>(sb + L.o_sgo);
    T* wsm = reinterpret_cast<T*>(sb + L.o_ws);
    const int plane = DG * L.lEH;
    if (t == 0 && n3) {
      fence_async_shared();
      mbar_expect(sbar, E * n3 * (int)sizeof(T));
      bulk_load(wsm, panel + pn.o_sih, E * n3 * (int)sizeof(T), sbar);
    }
    for (int i = t; i < plane; i += NT) hsd[i] = 0.0f;
    // slot k's embeddings: x_emb[:, 0] for slot 0, else the predicted
    // note's, as the chain computed them; gather() loads the pitch rows of
    // slot k ahead, behind the product of the slot before
    float nx[XI];
    auto gather = [&](int k) {
#pragma unroll
      for (int i = 0; i < XI; ++i) {
        const int idx = t + i * NT, r = idx / E, e = idx - r * E;
        nx[i] = 0.0f;
        if (idx >= DG * E) continue;
        if (k == 0)
          nx[i] = r < nrows ? ldg_f(x_emb + (size_t)(row0 + r) * K * E + e)
                            : 0.0f;
        else
          nx[i] = ldg_f(w.w_emb + (size_t)pitch[r * S + k - 1] * E + e);
      }
    };
    auto finish = [&](int k) {
#pragma unroll
      for (int i = 0; i < XI; ++i) {
        const int idx = t + i * NT, r = idx / E, e = idx - r * E;
        if (idx >= DG * E) continue;
        float v = nx[i];
        if (k != 0) {
          const int q = r * S + k - 1;
          for (int ws = 0; ws < W; ++ws)
            if (bits[q * W + ws]) v += emb[ws * L.lE + e];
          v = round_to<T>(v + emb[W * L.lE + e]);
        }
        xs[r * L.lE + e] = v;
      }
    };
    if (n3) mbar_wait(sbar, 0);
    gather(0);
    for (int k = 0; k < K; ++k) {
      finish(k);
      __syncthreads();
      if (k + 1 < K) gather(k + 1);
      float* out = gis + k * DG * L.lS3;
      staged_product(wsm, n3, E, xs, L.lE, [&](int r, int col, float v) {
        out[r * L.lS3 + col] = v + bsi[col];
      });
    }
    if (t == 0 && n3) {
      fence_async_shared();
      mbar_expect(sbar, EH * n3 * (int)sizeof(T));
      bulk_load(wsm, panel + pn.o_shh, EH * n3 * (int)sizeof(T), sbar);
    }
    cl.sync();   // every block's plane 0 is zero before the first push
    if (n3) mbar_wait(sbar, 1);
    for (int k = 0; k < K; ++k) {
      const int slot = d == 0 ? k : K - 1 - k;
      const float* hin = hsd + (k & 1) * plane;
      float* hout = hsd + ((k + 1) & 1) * plane;
      staged_product(wsm, n3, EH, hin, L.lEH, [&](int r, int col, float v) {
        sgo[r * L.lS3 + col] = v + bsh[col];
      });
      for (int idx = t; idx < DG * SU; idx += NT) {
        const int r = idx / SU, u = idx - r * SU, e = e0 + u;
        const float* gi_ = gis + slot * DG * L.lS3 + r * L.lS3;
        const float* gh_ = sgo + r * L.lS3;
        const float hp = hin[r * L.lEH + e];
        const float rr = sigmoid_(gi_[u] + gh_[u]);
        const float zz = sigmoid_(gi_[SU + u] + gh_[SU + u]);
        const float nn = tanhf(gi_[2 * SU + u] + rr * gh_[2 * SU + u]);
        const float hn =
            slot < len[r] ? round_to<T>((1.0f - zz) * nn + zz * hp) : hp;
        push_ranks(d * Cd, Cd, hout + r * L.lEH + e, hn);
        if (stash && r < nrows) {
          const size_t q = (size_t)d * K + k;
          st.sh[(q * B + row0 + r) * EH + e] = from_f<T>(hp);
          float* sgp = st.sg + (q * B + row0 + r) * 4 * EH;
          sgp[e] = rr;
          sgp[EH + e] = zz;
          sgp[2 * EH + e] = nn;
          sgp[3 * EH + e] = gh_[2 * SU + u];
        }
      }
      cl.sync();
    }
    const float* hfin = hsd + (K & 1) * plane;
    for (int idx = t; idx < nrows * SU; idx += NT) {
      const int r = idx / SU, e = e0 + idx - r * SU;
      summary[(size_t)(row0 + r) * 2 * EH + d * EH + e] =
          from_f<T>(hfin[r * L.lEH + e]);
    }
  }
  cl.sync();  // no block leaves while another may write into its memory
}

// ---- K1 per row

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

// K1 per row: a block owns R batch rows (1, 2 or 4) and streams every
// weight from L2 for them, its state in shared memory (matvec). The plan
// (build.k1_plan) takes it where the row groups would run in waves: at
// B=512, four rows a block in one wave beat three waves of row groups.
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

// ---------------------------------------------------------------------------
// K2a: the reverse chain in the phases of _frame_bwd_core
// ---------------------------------------------------------------------------

// K2a's blocks: eight warps. A row group is BW_M rows, the m of
// mma.m16n8k8; every product is a group's rows against weight rows.
constexpr int BW_THREADS = 256;
constexpr int BW_WARPS = BW_THREADS / 32;
constexpr int BW_M = 16;
constexpr int BW_STAGE = 384;  // k of a cotangent chunk that 2d stages
constexpr int BW_TILE = 128;   // output columns of a 2d item
constexpr int BW_MAX_CLUSTER = 16;

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
// row stride (floats) of a split A plane holding k < K (zeros up to a
// multiple of 32): an odd number of 16-byte units, so that the two rows a
// quarter-warp reads (16 bytes a lane, 32 bytes apart) fall in different
// banks
__host__ __device__ inline int a_ld(int K) { return ((K + 31) & ~31) + 4; }
// row stride (elements) of w_dhh staged in T: f32 as a_ld; bf16 (16 bytes
// a lane, contiguous) rows 64 bytes apart mod 128
template <typename T>
__host__ __device__ inline int w_ld(int K) {
  return sizeof(T) == sizeof(float) ? a_ld(K) : ((K + 63) & ~63) + 32;
}

// x into the split A planes at i: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void put_split(float* Ah, float* Al, int i,
                                          float x) {
  const unsigned h = tf32_rna(x);
  Ah[i] = __uint_as_float(h);
  Al[i] = __uint_as_float(tf32_rna(x - __uint_as_float(h)));
}

// W[k .. k + 7] of a bf16 weight row as its raw bits, zero from k = kw on;
// vec16: the row is 16-byte aligned (one vector load where k + 8 <= kw)
__device__ __forceinline__ uint4 ld_w8(const __nv_bfloat16* row, int k,
                                       int kw, bool vec16) {
  if (vec16 && k + 8 <= kw) return *reinterpret_cast<const uint4*>(row + k);
  unsigned short v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    v[u] = k + u < kw ? __bfloat16_as_ushort(row[k + u]) : 0;
  return make_uint4(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16,
                    v[4] | (unsigned)v[5] << 16, v[6] | (unsigned)v[7] << 16);
}

// W[k .. k + 7] of an f32 weight row, zero from k = kw on (two 16-byte
// loads where the row is 16-byte aligned and k + 8 <= kw)
struct W8 {
  float4 a, b;
};
__device__ __forceinline__ W8 ld_w8f(const float* row, int k, int kw,
                                     bool vec16) {
  if (vec16 && k + 8 <= kw)
    return {*reinterpret_cast<const float4*>(row + k),
            *reinterpret_cast<const float4*>(row + k + 4)};
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = k + u < kw ? row[k + u] : 0.0f;
  return {make_float4(v[0], v[1], v[2], v[3]),
          make_float4(v[4], v[5], v[6], v[7])};
}

// acc[ni] += the warp's 16 x 8 piece ni of out[m][n] = sum_k A[m][ka + k]
// W[n][k], n = n0 + 8 ni + (0..7), over k < kspan, f32-accurate on the
// tensor cores. A: split planes in shared memory (hi = tf32(x), lo =
// tf32(x - hi), row stride lda), zero or finite past their k up to a
// multiple of 32 (W is zero there). W: row n at W + n ldw (global or
// shared memory), k < kw; rows n >= N and k >= kw count as zero. In 32-k
// blocks: lane (g, t) holds k = 8t .. 8t + 7 of A rows g, g + 8 and of W
// row g, and its four mmas take the pairs (8t + 2m, 8t + 2m + 1), m =
// 0..3, as their k = t, t + 4 (the product sums over every k, so any
// pairing that A and W share gives the same sum); so a piece's W values of
// a block are one 16-byte load (bf16) or two (f32), issued together: the
// loads, not the products, set the pace of these small products. f32 W:
// three passes lo.hi + hi.lo + hi.hi (3xTF32), pass by pass over the
// pieces so that an mma never waits on the one just issued; bf16 W is
// exact in TF32: lo.W + hi.W. Each block sums in a fresh fragment added to
// acc in f32, as wgrad_kernel does.
template <int NTL, typename T>
__device__ __forceinline__ void mma_rows(const float* Ah, const float* Al,
                                           int lda, int ka, const T* W,
                                           long long ldw, int kw, int n0,
                                           int N, int kspan,
                                           float (&acc)[NTL][4]) {
  constexpr bool split_w = sizeof(T) == sizeof(float);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool vec16 = ((reinterpret_cast<uintptr_t>(W) |
                       static_cast<uintptr_t>(ldw * (long long)sizeof(T))) &
                      15) == 0;
  const float* ah = Ah + g * lda + ka + 8 * t;
  const float* al = Al + g * lda + ka + 8 * t;
  const T* wg = W + (long long)(n0 + g) * ldw;
  const int span = (kspan + 31) & ~31;
  for (int kb = 0; kb < span; kb += 32) {
    // this block's W values of each piece, as 8 floats
    float wv[NTL][8];
#pragma unroll
    for (int ni = 0; ni < NTL; ++ni) {
      const bool ok = n0 + 8 * ni + g < N;
      if constexpr (split_w) {
        const W8 v = ok ? ld_w8f(wg + 8 * ni * ldw, kb + 8 * t, kw, vec16)
                        : W8{make_float4(0.f, 0.f, 0.f, 0.f),
                             make_float4(0.f, 0.f, 0.f, 0.f)};
        wv[ni][0] = v.a.x; wv[ni][1] = v.a.y; wv[ni][2] = v.a.z;
        wv[ni][3] = v.a.w; wv[ni][4] = v.b.x; wv[ni][5] = v.b.y;
        wv[ni][6] = v.b.z; wv[ni][7] = v.b.w;
      } else {
        const uint4 v = ok ? ld_w8(wg + 8 * ni * ldw, kb + 8 * t, kw, vec16)
                           : make_uint4(0u, 0u, 0u, 0u);
        const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wv[ni][2 * q] = __uint_as_float(words[q] << 16);
          wv[ni][2 * q + 1] = __uint_as_float(words[q] & 0xffff0000u);
        }
      }
    }
    float part[NTL][4];
#pragma unroll
    for (int q = 0; q < 4 * NTL; ++q) (&part[0][0])[q] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 h0 = *reinterpret_cast<const float4*>(ah + kb + 4 * half);
      const float4 h1 =
          *reinterpret_cast<const float4*>(ah + 8 * lda + kb + 4 * half);
      const float4 l0 = *reinterpret_cast<const float4*>(al + kb + 4 * half);
      const float4 l1 =
          *reinterpret_cast<const float4*>(al + 8 * lda + kb + 4 * half);
      const float hv0[4] = {h0.x, h0.y, h0.z, h0.w};
      const float hv1[4] = {h1.x, h1.y, h1.z, h1.w};
      const float lv0[4] = {l0.x, l0.y, l0.z, l0.w};
      const float lv1[4] = {l1.x, l1.y, l1.z, l1.w};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int m = 2 * half + p;  // k pair (8t + 2m, 8t + 2m + 1)
        const unsigned a_h[4] = {
            __float_as_uint(hv0[2 * p]), __float_as_uint(hv1[2 * p]),
            __float_as_uint(hv0[2 * p + 1]), __float_as_uint(hv1[2 * p + 1])};
        const unsigned a_l[4] = {
            __float_as_uint(lv0[2 * p]), __float_as_uint(lv1[2 * p]),
            __float_as_uint(lv0[2 * p + 1]), __float_as_uint(lv1[2 * p + 1])};
        unsigned b_h[NTL][2], b_l[NTL][2];
#pragma unroll
        for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float x = wv[ni][2 * m + q];
            b_h[ni][q] = split_w ? tf32_rna(x) : __float_as_uint(x);
            b_l[ni][q] =
                split_w ? tf32_rna(x - __uint_as_float(b_h[ni][q])) : 0u;
          }
#pragma unroll
        for (int ni = 0; ni < NTL; ++ni) mma_tf32(part[ni], a_l, b_h[ni]);
        if (split_w) {
#pragma unroll
          for (int ni = 0; ni < NTL; ++ni) mma_tf32(part[ni], a_h, b_l[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < NTL; ++ni) mma_tf32(part[ni], a_h, b_h[ni]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4 * NTL; ++q) (&acc[0][0])[q] += (&part[0][0])[q];
  }
}

// The element (m, n) of fragment element q of piece ni: m = g + 8 (q / 2),
// n = n0 + 8 ni + 2t + q % 2.
__device__ __forceinline__ int frag_m(int q) {
  return ((threadIdx.x & 31) >> 2) + 8 * (q >> 1);
}
__device__ __forceinline__ int frag_n(int n0, int ni, int q) {
  return n0 + 8 * ni + 2 * (threadIdx.x & 3) + (q & 1);
}

// acc -> out[m][n] (row stride ldo) for n < N
template <int NTL>
__device__ __forceinline__ void store_rows(const float (&acc)[NTL][4],
                                           float* out, int ldo, int n0,
                                           int N) {
#pragma unroll
  for (int ni = 0; ni < NTL; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = frag_n(n0, ni, q);
      if (n < N) out[frag_m(q) * ldo + n] = acc[ni][q];
    }
}

// ---- 2b: the slot rows' logit cotangents, duration chains and heads

// Shared memory of train_bwd_slots_kernel (offsets in floats): the split A
// planes X (d_ghd, then d_hd, then d_est) and Y (d_gid at the first
// duration step), w_dhh staged in T, d_dhid_in (over Y, after the chain),
// the chain's d_hd, its direct share and product, the pitch-logit
// cotangent and the duration-logit cotangents.
struct SlotLayout {
  int lx, ly, lwd, ldi, lD, lP;
  int o_xh, o_xl, o_wd, o_yh, o_yl, o_dhin, o_dhd, o_dir, o_tmp, o_dest,
      o_dl, n_floats;
};

template <typename T>
__host__ __device__ inline SlotLayout slot_layout(const TrainWeightsT<T>& w) {
  SlotLayout L;
  const int DH3 = 3 * w.DH;
  L.lx = a_ld(imax(DH3, w.P));
  L.ly = a_ld(DH3);
  L.lwd = w_ld<T>(DH3);
  L.ldi = pad4(w.NH + w.P);
  L.lD = pad4(w.DH);
  L.lP = pad4(w.P);
  int o = 0;
  L.o_xh = o; o += BW_M * L.lx;
  L.o_xl = o; o += BW_M * L.lx;
  L.o_wd = o; o += (w.DH * L.lwd * (int)sizeof(T) + 15) / 16 * 4;
  L.o_yh = L.o_dhin = o;
  L.o_yl = o + BW_M * L.ly;
  o += imax(2 * BW_M * L.ly, BW_M * L.ldi);
  L.o_dhd = o; o += BW_M * L.lD;
  L.o_dir = o; o += BW_M * L.lD;
  L.o_tmp = o; o += BW_M * L.lD;
  L.o_dest = o; o += BW_M * L.lP;
  L.o_dl = o; o += BW_M * 2;
  L.n_floats = o;
  return L;
}

// One block a group of BW_M slot rows q = s B + b (rows of the (S, B, .)
// stash and cotangents): 2b of _frame_bwd_core, writing d_log, d_gid,
// d_ghd, d_sos, d_hd0, d_est and the note chain's injected cotangent
// dh_inj = d_dhid_in[:, :NH] + d_est @ w_pitch^T (S, B, NH).
template <typename T>
__global__ void __launch_bounds__(BW_THREADS, 1)
train_bwd_slots_kernel(TrainWeightsT<T> w, int B,
                       const int* __restrict__ gt_pitch,
                       const int* __restrict__ gt_dur,
                       const float* __restrict__ d_nums,
                       const T* __restrict__ d_pitch,
                       const T* __restrict__ d_dur, TrainStashT<T> st,
                       TrainCotangents ct, float* __restrict__ dh_inj,
                       int logits) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const SlotLayout L = slot_layout(w);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NH = w.NH, DH = w.DH, DH3 = 3 * w.DH, P = w.P, W = w.W;
  const int S = w.K - 1, q0 = blockIdx.x * BW_M;
  const int nrows = min(BW_M, S * B - q0);
  float *Xh = sm + L.o_xh, *Xl = sm + L.o_xl, *Yh = sm + L.o_yh,
        *Yl = sm + L.o_yl, *dhin = sm + L.o_dhin, *dhd = sm + L.o_dhd,
        *dir = sm + L.o_dir, *tmp = sm + L.o_tmp, *dest = sm + L.o_dest,
        *dl = sm + L.o_dl;
  T* Wd = reinterpret_cast<T*>(sm + L.o_wd);

  for (int i = tid; i < 2 * BW_M * L.lx; i += BW_THREADS) Xh[i] = 0.0f;
  for (int i = tid; i < 2 * BW_M * L.ly; i += BW_THREADS) Yh[i] = 0.0f;
  for (int i = tid; i < DH * DH3; i += BW_THREADS)
    Wd[i / DH3 * L.lwd + i % DH3] = w.w_dhh[i];
  for (int i = tid; i < BW_M * L.lD; i += BW_THREADS) dhd[i] = 0.0f;
  // the pitch-logit cotangent of each row: given (logits out), or the
  // CE's g0 * mask * (softmax - onehot) (loss mode), a warp a row
  for (int r = warp; r < BW_M; r += BW_WARPS) {
    float* y = dest + r * L.lP;
    const int q = q0 + r, s = q / B, b = q - s * B;
    if (r >= nrows) {
      for (int j = lane; j < P; j += 32) y[j] = 0.0f;
    } else if (logits) {
      const T* dp = d_pitch + ((size_t)b * S + s) * P;
      for (int j = lane; j < P; j += 32) y[j] = to_f(dp[j]);
    } else {
      const T* est = st.est + (size_t)q * P;
      const int gt = gt_pitch[(size_t)b * S + s];
      const float lse = warp_lse(est, P, lane);
      const float gm = gt != w.pitch_pad ? d_nums[0] : 0.0f;
      for (int j = lane; j < P; j += 32)
        y[j] = gm * (expf(to_f(est[j]) - lse) - (j == gt ? 1.0f : 0.0f));
    }
  }

  // the duration chains backward, steps W-1 .. 0
  for (int ws = W - 1; ws >= 0; --ws) {
    if (tid < BW_M) {
      const int r = tid, q = q0 + r, s = q / B, b = q - s * B;
      float d0 = 0.0f, d1 = 0.0f;
      if (r < nrows) {
        if (logits) {
          const T* dd = d_dur + (((size_t)b * S + s) * W + ws) * 2;
          d0 = to_f(dd[0]);
          d1 = to_f(dd[1]);
        } else {
          const T* lg = st.dlog + ((size_t)q * W + ws) * 2;
          const float l0 = to_f(lg[0]), l1 = to_f(lg[1]);
          const int gt = gt_dur[((size_t)b * S + s) * W + ws];
          const float lse = lse2(l0, l1);
          const float gm = gt != w.dur_pad ? d_nums[1 + ws] : 0.0f;
          d0 = gm * (expf(l0 - lse) - (gt == 0 ? 1.0f : 0.0f));
          d1 = gm * (expf(l1 - lse) - (gt == 1 ? 1.0f : 0.0f));
        }
        float* o = ct.d_log + ((size_t)q * W + ws) * 2;
        o[0] = d0;
        o[1] = d1;
      }
      dl[2 * r] = d0;
      dl[2 * r + 1] = d1;
    }
    __syncthreads();
    // IT items a thread at a time, every item's loads issued first
    constexpr int IT = 4;
    for (int i0 = tid; i0 < BW_M * DH; i0 += IT * BW_THREADS) {
      float hp[IT];
      Gates gt[IT];
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        const int i = min(i0 + u * BW_THREADS, BW_M * DH - 1);
        const int r = i / DH, j = i - r * DH;
        const size_t q = q0 + (r < nrows ? r : 0);
        hp[u] = to_f(st.hd[(q * (W + 1) + ws) * DH + j]);
        gt[u] = load_gates(st.dg + (q * W + ws) * 4 * DH, DH, j);
      }
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        const int i = i0 + u * BW_THREADS;
        if (i >= BW_M * DH) break;
        const int r = i / DH, j = i - r * DH;
        const bool ok = r < nrows;
        const size_t qw = (q0 + (ok ? r : 0)) * (size_t)W + ws;
        const float dlogit = dl[2 * r] * ldg_f(w.w_dout + 2 * j) +
                             dl[2 * r + 1] * ldg_f(w.w_dout + 2 * j + 1);
        const float dhv = ok ? dhd[r * L.lD + j] + dlogit : 0.0f;
        float dgi[3], dgh[3];
        dir[r * L.lD + j] = gru_bwd(dhv, hp[u], gt[u], dgi, dgh);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          put_split(Xh, Xl, r * L.lx + c * DH + j, dgh[c]);
          if (ws == 0) put_split(Yh, Yl, r * L.ly + c * DH + j, dgi[c]);
          if (ok) {
            ct.d_gid[qw * DH3 + c * DH + j] = dgi[c];
            ct.d_ghd[qw * DH3 + c * DH + j] = dgh[c];
          }
        }
      }
    }
    __syncthreads();
    // d_hd = direct + d_ghd @ w_dhh^T (w_dhh staged), and at the first
    // step d_sos = d_gid @ w_dih^T (the last warp)
    for (int nt = warp; nt < (DH + 7) / 8; nt += BW_WARPS) {
      float acc[1][4] = {};
      mma_rows<1, T>(Xh, Xl, L.lx, 0, Wd, L.lwd, DH3, 8 * nt, DH,
                     pad16(DH3), acc);
      store_rows<1>(acc, tmp, L.lD, 8 * nt, DH);
    }
    if (ws == 0 && warp == BW_WARPS - 1) {
      for (int nt = 0; nt < (W + 7) / 8; ++nt) {
        float acc[1][4] = {};
        mma_rows<1, T>(Yh, Yl, L.ly, 0, w.w_dih, DH3, DH3, 8 * nt, W,
                       pad16(DH3), acc);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = frag_m(q), n = frag_n(8 * nt, 0, q);
          if (m < nrows && n < W) ct.d_sos[(size_t)(q0 + m) * W + n] =
              acc[0][q];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < BW_M * DH; i += BW_THREADS) {
      const int r = i / DH, j = i - r * DH;
      dhd[r * L.lD + j] = dir[r * L.lD + j] + tmp[r * L.lD + j];
    }
  }
  __syncthreads();
  // d_hd0, and d_hd into X for d_dhid_in = d_hd @ w_dhid^T
  for (int i = tid; i < BW_M * pad16(DH); i += BW_THREADS) {
    const int r = i / pad16(DH), j = i - r * pad16(DH);
    const float v = j < DH ? dhd[r * L.lD + j] : 0.0f;
    put_split(Xh, Xl, r * L.lx + j, v);
    if (r < nrows && j < DH) ct.d_hd0[(size_t)(q0 + r) * DH + j] = v;
  }
  __syncthreads();
  const int NI = NH + P;
  for (int n0 = 32 * warp; n0 < NI; n0 += 32 * BW_WARPS) {
    float acc[4][4] = {};
    mma_rows<4, T>(Xh, Xl, L.lx, 0, w.w_dhid, DH, DH, n0, NI, pad16(DH),
                   acc);
    store_rows<4>(acc, dhin, L.ldi, n0, NI);
  }
  __syncthreads();
  // d_est = the logit cotangent + d_dhid_in[:, NH:], into X
  for (int i = tid; i < BW_M * pad16(P); i += BW_THREADS) {
    const int r = i / pad16(P), p = i - r * pad16(P);
    const float v = p < P ? dest[r * L.lP + p] + dhin[r * L.ldi + NH + p]
                          : 0.0f;
    put_split(Xh, Xl, r * L.lx + p, v);
    if (r < nrows && p < P) ct.d_est[(size_t)(q0 + r) * P + p] = v;
  }
  __syncthreads();
  // dh_inj = d_dhid_in[:, :NH] + d_est @ w_pitch^T
  for (int n0 = 64 * warp; n0 < NH; n0 += 64 * BW_WARPS) {
    float acc[8][4] = {};
    mma_rows<8, T>(Xh, Xl, L.lx, 0, w.w_pitch, P, P, n0, NH, pad16(P), acc);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = frag_m(q), n = frag_n(n0, ni, q);
        if (m < nrows && n < NH)
          dh_inj[(size_t)(q0 + m) * NH + n] = dhin[m * L.ldi + n] +
                                              acc[ni][q];
      }
  }
}

// ---- 2a and 2c: the serial chains

// Shared memory of train_bwd_chain_kernel: the larger of its two roles'.
// A note-chain block (C blocks a cluster, U = NH / C units each): the split
// planes of its d_gh columns (3 segments of pad16(U)), two planes of
// partial products [BW_M][NH] (the step's and the last step's), and its
// units' d h, direct shares and d_gi_frame sums. A summary block: the split
// planes of d_gh (3EH), d h and the product.
template <typename T>
__host__ __device__ inline int chain_floats(const TrainWeightsT<T>& w,
                                            int C) {
  const int U = w.NH / C;
  const int note = 2 * BW_M * a_ld(3 * pad16(U)) + 2 * BW_M * w.NH +
                   BW_M * 5 * U;
  const int summ = 2 * BW_M * a_ld(3 * w.EH) + 2 * BW_M * pad4(w.EH);
  return imax(note, summ);
}

// The grid: G = ceil(B / BW_M) row groups. Blocks [0, C G), clusters of C:
// the note-GRU reverse recurrence (2c) of a row group, each block owning
// NH / C hidden units: per slot, gru_bwd on its units (writing d_gi,
// d_gh), its columns of d_gh @ w_hh^T for all NH units into its partial
// plane, then a cluster barrier, and each block sums its units' partials
// from the C blocks' planes in rank order (distributed shared memory).
// Then 2 G blocks, one a (direction, row group), run the summary bi-GRU
// backward (2a), writing d_sgi and d_sgh; and the blocks up to the next
// multiple of C idle. `roles` (bit 0 the note chain, bit 1 the summary
// chain) lets a timing run one chain alone; the other's blocks return.
template <typename T>
__global__ void __launch_bounds__(BW_THREADS, 2)
train_bwd_chain_kernel(TrainWeightsT<T> w, int B, int G,
                       const int* __restrict__ lengths,
                       const T* __restrict__ d_summ,
                       const float* __restrict__ dh_inj, TrainStashT<T> st,
                       TrainCotangents ct, int roles) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5;
  const int NH = w.NH, NH3 = 3 * w.NH, EH = w.EH, EH3 = 3 * w.EH, K = w.K;
  if ((int)blockIdx.x >= C * G) {
    // 2a: one direction of the summary bi-GRU over a row group
    if (!(roles & 2)) return;
    const int idx = blockIdx.x - C * G, d = idx & 1, b0 = (idx >> 1) * BW_M;
    if (b0 >= B) return;
    const int nrows = min(BW_M, B - b0), lda = a_ld(EH3), lE = pad4(EH);
    float *Ah = sm, *Al = Ah + BW_M * lda, *dsum = Al + BW_M * lda,
          *prod = dsum + BW_M * lE;
    for (int i = tid; i < 2 * BW_M * lda; i += BW_THREADS) Ah[i] = 0.0f;
    for (int i = tid; i < BW_M * EH; i += BW_THREADS) {
      const int r = i / EH, j = i - r * EH;
      dsum[r * lE + j] =
          r < nrows ? to_f(d_summ[(size_t)(b0 + r) * 2 * EH + d * EH + j])
                    : 0.0f;
    }
    __syncthreads();
    const T* whh = w.we_hh + (size_t)d * EH * EH3;
    for (int k = K - 1; k >= 0; --k) {
      const int slot = d == 0 ? k : K - 1 - k;
      // IT items a thread at a time, every item's loads issued first
      constexpr int IT = 8;
      for (int i0 = tid; i0 < BW_M * EH; i0 += IT * BW_THREADS) {
        float hp[IT];
        Gates gt[IT];
#pragma unroll
        for (int u = 0; u < IT; ++u) {
          const int i = min(i0 + u * BW_THREADS, BW_M * EH - 1);
          const int r = i / EH, j = i - r * EH;
          const size_t q =
              ((size_t)d * K + k) * B + b0 + (r < nrows ? r : 0);
          hp[u] = to_f(st.sh[q * EH + j]);
          gt[u] = load_gates(st.sg + q * 4 * EH, EH, j);
        }
#pragma unroll
        for (int u = 0; u < IT; ++u) {
          const int i = i0 + u * BW_THREADS;
          if (i >= BW_M * EH) break;
          const int r = i / EH, j = i - r * EH;
          const bool ok = r < nrows;
          const float m = ok && slot < lengths[b0 + r] ? 1.0f : 0.0f;
          const size_t q = ((size_t)d * K + k) * B + b0 + (ok ? r : 0);
          const float ds = dsum[r * lE + j];
          float dgi[3], dgh[3];
          const float direct = gru_bwd(m * ds, hp[u], gt[u], dgi, dgh);
          const size_t qs = ((size_t)d * K + slot) * B + b0 + r;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            put_split(Ah, Al, r * lda + c * EH + j, dgh[c]);
            if (ok) {
              ct.d_sgi[qs * EH3 + c * EH + j] = dgi[c];
              ct.d_sgh[q * EH3 + c * EH + j] = dgh[c];
            }
          }
          dsum[r * lE + j] = (1.0f - m) * ds + direct;
        }
      }
      __syncthreads();
      for (int n0 = 16 * warp; n0 < EH; n0 += 16 * BW_WARPS) {
        float acc[2][4] = {};
        mma_rows<2, T>(Ah, Al, lda, 0, whh, EH3, EH3, n0, EH, pad16(EH3),
                       acc);
        store_rows<2>(acc, prod, lE, n0, EH);
      }
      __syncthreads();
      for (int i = tid; i < BW_M * EH; i += BW_THREADS) {
        const int r = i / EH, j = i - r * EH;
        dsum[r * lE + j] += prod[r * lE + j];
      }
    }
    return;
  }
  // 2c: this block's units [j0, j0 + U) of a row group (a cluster's
  // blocks return together)
  if (!(roles & 1)) return;
  const int c = cluster.block_rank(), U = NH / C, j0 = c * U;
  const int Us = pad16(U), lda = a_ld(3 * Us), S = K - 1;
  const int b0 = blockIdx.x / C * BW_M, nrows = min(BW_M, B - b0);
  float *Ah = sm, *Al = Ah + BW_M * lda, *part = Al + BW_M * lda,
        *dhn = part + 2 * BW_M * NH, *dir = dhn + BW_M * U,
        *dgif = dir + BW_M * U;
  for (int i = tid; i < 2 * BW_M * lda; i += BW_THREADS) Ah[i] = 0.0f;
  for (int i = tid; i < BW_M * U; i += BW_THREADS) dhn[i] = 0.0f;
  for (int i = tid; i < BW_M * 3 * U; i += BW_THREADS) dgif[i] = 0.0f;
  __syncthreads();
  // d h_prev of this block's units: the C blocks' partials summed in rank
  // order, four units a thread, every block's value loaded before the sum
  auto reduce = [&](const float* plane) {
    for (int i = tid; i < BW_M * U / 4; i += BW_THREADS) {
      const int r = i / (U / 4), u = 4 * (i - r * (U / 4));
      float4 p[BW_MAX_CLUSTER];
#pragma unroll
      for (int cc = 0; cc < BW_MAX_CLUSTER; ++cc)
        if (cc < C)
          p[cc] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(plane, cc) + r * NH + j0 + u);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int cc = 0; cc < BW_MAX_CLUSTER; ++cc)
        if (cc < C) {
          v.x += p[cc].x;
          v.y += p[cc].y;
          v.z += p[cc].z;
          v.w += p[cc].w;
        }
      float* dh = dhn + r * U + u;
      const float* dd = dir + r * U + u;
      dh[0] = dd[0] + v.x;
      dh[1] = dd[1] + v.y;
      dh[2] = dd[2] + v.z;
      dh[3] = dd[3] + v.w;
    }
    __syncthreads();
  };
  for (int k = S; k >= 1; --k) {
    const size_t s = k - 1;
    float* mine = part + (k & 1) * BW_M * NH;
    if (k < S) reduce(part + ((k + 1) & 1) * BW_M * NH);
    // IT items a thread at a time, every item's loads issued first
    constexpr int IT = 4;
    for (int i0 = tid; i0 < BW_M * U; i0 += IT * BW_THREADS) {
      float hp[IT], inj[IT];
      Gates gt[IT];
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        const int i = min(i0 + u * BW_THREADS, BW_M * U - 1);
        const int r = i / U, j = j0 + i - r * U;
        const size_t q = s * B + b0 + (r < nrows ? r : 0);
        hp[u] = to_f(st.hs[q * NH + j]);
        inj[u] = dh_inj[q * NH + j];
        gt[u] = load_gates(st.ng + q * 4 * NH, NH, j);
      }
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        const int i = i0 + u * BW_THREADS;
        if (i >= BW_M * U) break;
        const int r = i / U, jj = i - r * U, j = j0 + jj;
        const bool ok = r < nrows;
        const size_t q = s * B + b0 + (ok ? r : 0);
        const float dhk = ok ? dhn[i] + inj[u] : 0.0f;
        float dgi[3], dgh[3];
        dir[i] = gru_bwd(dhk, hp[u], gt[u], dgi, dgh);
#pragma unroll
        for (int g3 = 0; g3 < 3; ++g3) {
          put_split(Ah, Al, r * lda + g3 * Us + jj, dgh[g3]);
          dgif[r * 3 * U + g3 * U + jj] += dgi[g3];
          if (ok) {
            ct.d_gi[q * NH3 + g3 * NH + j] = dgi[g3];
            ct.d_gh[q * NH3 + g3 * NH + j] = dgh[g3];
          }
        }
      }
    }
    __syncthreads();
    // this block's columns of d_gh @ w_hh^T, for every unit
    for (int n0 = 32 * warp; n0 < NH; n0 += 32 * BW_WARPS) {
      float acc[4][4] = {};
#pragma unroll 1
      for (int g3 = 0; g3 < 3; ++g3)
        mma_rows<4, T>(Ah, Al, lda, g3 * Us, w.w_hh + g3 * NH + j0, NH3, U,
                       n0, NH, Us, acc);
      store_rows<4>(acc, mine, NH, n0, NH);
    }
    cluster.sync();
  }
  reduce(part + BW_M * NH);  // slot 1's partials: d h0
  for (int i = tid; i < BW_M * U; i += BW_THREADS) {
    const int r = i / U, jj = i - r * U, j = j0 + jj;
    if (r >= nrows) continue;
    const size_t b = b0 + r;
    ct.dh0[b * NH + j] = dhn[i];
#pragma unroll
    for (int g3 = 0; g3 < 3; ++g3)
      ct.d_gif[b * NH3 + g3 * NH + j] = dgif[r * 3 * U + g3 * U + jj];
  }
  cluster.sync();  // every block has read this block's partials
}

// ---- 2d: the token and embedding routes, and d_frame_h

// k of the cotangent rows src (BW_M rows from row b0 of nrows, row stride
// lds, K wide) staged in chunks of BW_STAGE into the split planes, each
// chunk's products with W (row n at W + n ldw, k < K) added to acc by every
// warp at its n0. Every thread of the block calls it.
template <int NTL, typename T>
__device__ __forceinline__ void staged_mma(const float* src, long long lds,
                                           int nrows, int K, const T* W,
                                           long long ldw, int n0, int N,
                                           float* Ah, float* Al, int lda,
                                           float (&acc)[NTL][4]) {
  for (int kc = 0; kc < K; kc += BW_STAGE) {
    // zeros up to a multiple of 32 k: the bf16 products read 32-k blocks
    const int kl = min(BW_STAGE, K - kc), ks = (kl + 31) & ~31;
    for (int i = threadIdx.x; i < BW_M * ks; i += BW_THREADS) {
      const int r = i / ks, kk = i - r * ks;
      put_split(Ah, Al, r * lda + kk,
                r < nrows && kk < kl ? src[r * lds + kc + kk] : 0.0f);
    }
    __syncthreads();
    mma_rows<NTL, T>(Ah, Al, lda, 0, W + kc, ldw, kl, n0, N, ks, acc);
    __syncthreads();
  }
}

template <typename T>
__host__ __device__ inline int proj_floats(const TrainWeightsT<T>& w) {
  return 2 * BW_M * a_ld(BW_STAGE) + 2 * BW_M * BW_TILE;
}

// Items: (slot k < K, row group, column tile of E) first, then (row group,
// column tile of TH); BW_TILE columns an item, 16 a warp. A slot item
// computes d_pred[k] = d_sgi[0, k] @ we_ih[0]^T + d_sgi[1, k] @ we_ih[1]^T
// and d_tok = d_gi[k] @ w_ih_tok^T, the cotangent of the token slot k + 1
// took (none for k = K-1), and routes them: d_emb[k-1] = d_pred[k] + (the
// coin took the ground truth ? 0 : d_tok), d_x_emb[:, k] = (coin ? d_tok :
// 0), d_x_emb[:, 0] = d_tok + d_pred[0]. A frame item computes d_frame_h =
// dh0 @ w_t2n^T + d_gi_frame @ w_ih_frame^T, rounded once to T.
template <typename T>
__global__ void __launch_bounds__(BW_THREADS, 2)
train_bwd_proj_kernel(TrainWeightsT<T> w, int B, int G,
                      const int* __restrict__ coins,
                      T* __restrict__ d_frame_h, T* __restrict__ d_x_emb,
                      TrainCotangents ct) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lda = a_ld(BW_STAGE);
  float *Ah = sm, *Al = Ah + BW_M * lda, *Dp = Al + BW_M * lda,
        *Dt = Dp + BW_M * BW_TILE;
  const int NH = w.NH, NH3 = 3 * w.NH, E = w.E, EH3 = 3 * w.EH, K = w.K;
  const int S = K - 1, TH = w.TH, warp = threadIdx.x >> 5;
  const int tiles_e = (E + BW_TILE - 1) / BW_TILE;
  int item = blockIdx.x;
  if (item < K * G * tiles_e) {
    const int k = item / (G * tiles_e);
    item -= k * G * tiles_e;
    const int b0 = item / tiles_e * BW_M, e0 = item % tiles_e * BW_TILE;
    const int nrows = min(BW_M, B - b0), n0 = e0 + 16 * warp;
    float acc[2][4] = {};
    for (int d = 0; d < 2; ++d)
      staged_mma<2, T>(ct.d_sgi + (((size_t)d * K + k) * B + b0) * EH3, EH3,
                       nrows, EH3, w.we_ih + (size_t)d * E * EH3, EH3, n0, E,
                       Ah, Al, lda, acc);
    store_rows<2>(acc, Dp - e0, BW_TILE, n0, min(E, e0 + BW_TILE));
    float tok[2][4] = {};
    if (k < S)
      staged_mma<2, T>(ct.d_gi + ((size_t)k * B + b0) * NH3, NH3, nrows,
                       NH3, w.w_ih_tok, NH3, n0, E, Ah, Al, lda, tok);
    store_rows<2>(tok, Dt - e0, BW_TILE, n0, min(E, e0 + BW_TILE));
    __syncthreads();
    const int ne = min(BW_TILE, E - e0);
    const bool coin = k > 0 && coins[k - 1] != 0;
    for (int i = threadIdx.x; i < nrows * ne; i += BW_THREADS) {
      const int r = i / ne, e = i - r * ne;
      const size_t b = b0 + r;
      const float dp = Dp[r * BW_TILE + e], dt = Dt[r * BW_TILE + e];
      T* dx = d_x_emb + (b * K + k) * E + e0 + e;
      if (k == 0) {
        *dx = from_f<T>(dt + dp);
      } else {
        ct.d_emb[((size_t)(k - 1) * B + b) * E + e0 + e] =
            dp + (coin ? 0.0f : dt);
        *dx = from_f<T>(coin ? dt : 0.0f);
      }
    }
    return;
  }
  item -= K * G * tiles_e;
  const int tiles_t = (TH + BW_TILE - 1) / BW_TILE;
  const int b0 = item / tiles_t * BW_M, n0 = item % tiles_t * BW_TILE +
                                              16 * warp;
  const int nrows = min(BW_M, B - b0);
  float acc[2][4] = {};
  staged_mma<2, T>(ct.dh0 + (size_t)b0 * NH, NH, nrows, NH, w.w_t2n, NH, n0,
                   TH, Ah, Al, lda, acc);
  staged_mma<2, T>(ct.d_gif + (size_t)b0 * NH3, NH3, nrows, NH3,
                   w.w_ih_frame, NH3, n0, TH, Ah, Al, lda, acc);
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = frag_m(q), n = frag_n(n0, ni, q);
      if (m < nrows && n < TH)
        d_frame_h[(size_t)(b0 + m) * TH + n] = from_f<T>(acc[ni][q]);
    }
}

template <typename Kern>
cudaError_t prepare_train(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K1 per row in either mode (see train_fwd_kernel).
template <typename T>
cudaError_t train_fwd_rows(const TrainWeightsT<T>* w, int B, int R,
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

// K1's instance for cluster size C (16 or 8; rows owned a block: 16 / C)
template <typename T>
using K1Kern = void (*)(TrainWeightsT<T>, K1PanelsT<T>, int, int,
                        const int*, const T*, const T*, const int*,
                        const int*, float*, T*, T*, T*, int*, int*,
                        TrainStashT<T>, int, int);

template <typename T>
K1Kern<T> k1_instance(int C) {
  return C == 16 ? train_fwd_group_kernel<1, T> : train_fwd_group_kernel<2, T>;
}

// {shared memory bytes, clusters of C blocks the card holds at once (0 if
// it cannot say or the kernel does not take these widths)} of K1
template <typename T>
cudaError_t k1_info(const TrainWeightsT<T>& w, int C, int* out) {
  if (!cluster_ok(C)) return cudaErrorInvalidValue;
  const K1Layout L = k1_layout(w, C);
  out[0] = L.bytes;
  out[1] = 0;
  if (!k1_fits(w, L)) return cudaSuccess;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = group_config(1, C, L.bytes, nullptr, &attr);
  const K1Kern<T> k = k1_instance<T>(C);
  cudaError_t e = group_prepare(k, L.bytes, C);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&out[1], k, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    out[1] = 0;
  }
  return cudaSuccess;
}

// K1 in either mode over B rows: with R = 0, in groups of DG, a cluster
// of C blocks a group, the phases of `phases` (K1_ALL all); with R > 0,
// the per-row kernel, R rows a block (pn, phases and C unused).
template <typename T>
cudaError_t train_fwd(const TrainWeightsT<T>* w, const K1PanelsT<T>* pn,
                      int B, int phases, int C, int R, const int* coins,
                      const T* frame_h, const T* x_emb, const int* gt_pitch,
                      const int* gt_dur, float* nums_rows, T* pitch_logits,
                      T* dur_logits, T* summary, int* lengths,
                      int* decisions, const TrainStashT<T>* stash, int logits,
                      void* stream) {
  if (R > 0)
    return train_fwd_rows(w, B, R, coins, frame_h, x_emb, gt_pitch, gt_dur,
                          nums_rows, pitch_logits, dur_logits, summary,
                          lengths, decisions, stash, logits, stream);
  if (B <= 0 || !pn || phases < 1 || phases > (K1_ALL | PH_BARRIERS) ||
      !cluster_ok(C))
    return cudaErrorInvalidValue;
  const K1Layout L = k1_layout(*w, C);
  if (!k1_fits(*w, L)) return cudaErrorInvalidValue;
  const K1Kern<T> k = k1_instance<T>(C);
  cudaError_t e = group_prepare(k, L.bytes, C);
  if (e != cudaSuccess) return e;
  TrainStashT<T> st = {};
  if (stash) st = *stash;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      group_config(cdiv(B, DG), C, L.bytes,
                   static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, k, *w, *pn, B, phases, coins, frame_h, x_emb,
                         gt_pitch, gt_dur, nums_rows, pitch_logits,
                         dur_logits, summary, lengths, decisions, st,
                         stash != nullptr ? 1 : 0, logits);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t prepare_chain(const TrainWeightsT<T>& w, int C, size_t* bytes) {
  if (C < 1 || C > BW_MAX_CLUSTER || (C & (C - 1)) || w.NH % (4 * C))
    return cudaErrorInvalidValue;
  *bytes = sizeof(float) * (size_t)chain_floats(w, C);
  cudaError_t e = prepare_train(train_bwd_chain_kernel<T>, *bytes);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(train_bwd_chain_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e;
}

template <typename T>
cudaLaunchConfig_t chain_config(const TrainWeightsT<T>& w, int B, int C,
                                size_t bytes, cudaStream_t s,
                                cudaLaunchAttribute* attr) {
  const int G = (B + BW_M - 1) / BW_M;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * G + (2 * G + C - 1) / C * C);
  cfg.blockDim = dim3(BW_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of C blocks of the chain kernel the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 if it cannot say), cached by size.
template <typename T>
int chain_clusters_at_once(const TrainWeightsT<T>& w, int C) {
  static int cached_c = 0, cached_floats = 0, cached = 0;
  size_t bytes = 0;
  if (prepare_chain(w, C, &bytes) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (C == cached_c && chain_floats(w, C) == cached_floats) return cached;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = chain_config(w, C * BW_M, C, bytes, nullptr,
                                              &attr);
  int most = 0;
  if (cudaOccupancyMaxActiveClusters(&most, train_bwd_chain_kernel<T>,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    most = 0;
  }
  cached_c = C;
  cached_floats = chain_floats(w, C);
  cached = most;
  return most;
}

// The cluster size of K2a's note chain: `cluster` if given; else 16 where
// NH allows it and every cluster of the launch fits on the card at once
// (the chain's steps then run on twice the SMs of 8: B = 128 at canonical
// width), otherwise the largest of 8, 4, 2, 1 that leaves each block a
// multiple of 4 units.
template <typename T>
int bwd_cluster(const TrainWeightsT<T>& w, int B, int cluster) {
  if (cluster) return cluster;
  const int G = (B + BW_M - 1) / BW_M;
  if (w.NH % 64 == 0 &&
      G + (2 * G + 15) / 16 <= chain_clusters_at_once(w, 16))
    return 16;
  int C = 8;
  while (C > 1 && w.NH % (4 * C)) C >>= 1;
  return C;
}

// K2a in either mode: `phases` selects its phases (1: 2b, the slot-row
// kernel; 2: 2c, the note chain, and 8: 2a, the summary chain, both in the
// chain kernel; 4: 2d, the projection kernel; 15 all, the kernels in that
// order: each reads what the ones before it wrote). dh_inj is the
// wrapper's f32 scratch (K-1, B, NH).
template <typename T>
cudaError_t train_bwd(const TrainWeightsT<T>* w, int B, int phases,
                      int cluster, const int* coins, const int* gt_pitch,
                      const int* gt_dur, const int* lengths,
                      const float* d_nums, const T* d_pitch, const T* d_dur,
                      const T* d_summ, T* d_frame_h, T* d_x_emb,
                      float* dh_inj, const TrainStashT<T>* stash,
                      const TrainCotangents* cot, int logits, void* stream) {
  if (B <= 0 || phases < 1 || phases > 15 || !stash || !cot || !dh_inj)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = (B + BW_M - 1) / BW_M, S = w->K - 1;
  cudaError_t e = cudaSuccess;
  if (phases & 1) {
    const size_t bytes = sizeof(float) * (size_t)slot_layout(*w).n_floats;
    e = prepare_train(train_bwd_slots_kernel<T>, bytes);
    if (e != cudaSuccess) return e;
    train_bwd_slots_kernel<T><<<(S * B + BW_M - 1) / BW_M, BW_THREADS, bytes,
                                s>>>(*w, B, gt_pitch, gt_dur, d_nums,
                                     d_pitch, d_dur, *stash, *cot, dh_inj,
                                     logits);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (phases & 10) {
    const int C = bwd_cluster(*w, B, cluster);
    size_t bytes = 0;
    e = prepare_chain(*w, C, &bytes);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = chain_config(*w, B, C, bytes, s, &attr);
    e = cudaLaunchKernelEx(&cfg, train_bwd_chain_kernel<T>, *w, B, G,
                           lengths, d_summ, (const float*)dh_inj, *stash,
                           *cot, (phases & 2 ? 1 : 0) | (phases & 8 ? 2 : 0));
    if (e != cudaSuccess) return e;
  }
  if (phases & 4) {
    const size_t bytes = sizeof(float) * (size_t)proj_floats(*w);
    e = prepare_train(train_bwd_proj_kernel<T>, bytes);
    if (e != cudaSuccess) return e;
    const int items = w->K * G * ((w->E + BW_TILE - 1) / BW_TILE) +
                      G * ((w->TH + BW_TILE - 1) / BW_TILE);
    train_bwd_proj_kernel<T><<<items, BW_THREADS, bytes, s>>>(
        *w, B, G, coins, d_frame_h, d_x_emb, *cot);
  }
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
// for bfloat16; float otherwise). K1 stages weights in its storage type
// and reports its own sizes per type; K2a's slot-row kernel stages w_dhh in
// it, and the sizes reported are float's.
#define PCTD_TRAIN_ENTRIES(T, SFX)                                           \
  /* K1, loss mode: CE numerators per row; rows > 0: the per-row kernel */  \
  int pctd_train_fwd##SFX(const TrainWeightsT<T>* w, const K1PanelsT<T>* pn, \
                          int B, int phases, int cluster, int rows,          \
                          const int* coins, const T* frame_h,                \
                          const T* x_emb,                                    \
                          const int* gt_pitch, const int* gt_dur,            \
                          float* nums_rows, T* summary, int* lengths,        \
                          int* decisions, const TrainStashT<T>* stash,       \
                          void* stream) {                                    \
    return train_fwd<T>(w, pn, B, phases, cluster, rows, coins, frame_h,     \
                        x_emb, gt_pitch, gt_dur, nums_rows, nullptr, nullptr,\
                        summary, lengths, decisions, stash, 0, stream);      \
  }                                                                          \
  /* K1, logits out. */                                                      \
  int pctd_train_fwd_logits##SFX(                                            \
      const TrainWeightsT<T>* w, const K1PanelsT<T>* pn, int B, int phases,  \
      int cluster, int rows, const int* coins, const T* frame_h,             \
      const T* x_emb, T* pitch_logits, T* dur_logits, T* summary,            \
      int* lengths, int* decisions, const TrainStashT<T>* stash,             \
      void* stream) {                                                        \
    return train_fwd<T>(w, pn, B, phases, cluster, rows, coins, frame_h,     \
                        x_emb, nullptr, nullptr, nullptr, pitch_logits,      \
                        dur_logits, summary, lengths, decisions, stash, 1,   \
                        stream);                                             \
  }                                                                          \
  /* K1's shared memory a block and clusters at once (out[2]). */            \
  int pctd_train_fwd_info##SFX(const TrainWeightsT<T>* w, int cluster,       \
                               int* out) {                                   \
    return k1_info<T>(*w, cluster, out);                                     \
  }                                                                          \
  /* K2a, loss mode: the CE cotangents from the targets and d_nums. */     \
  int pctd_train_bwd##SFX(const TrainWeightsT<T>* w, int B, int phases,      \
                          int cluster, const int* coins,                     \
                          const int* gt_pitch, const int* gt_dur,            \
                          const int* lengths, const float* d_nums,           \
                          const T* d_summ, T* d_frame_h, T* d_x_emb,         \
                          float* dh_inj, const TrainStashT<T>* stash,        \
                          const TrainCotangents* cot, void* stream) {        \
    return train_bwd<T>(w, B, phases, cluster, coins, gt_pitch, gt_dur,      \
                        lengths, d_nums, nullptr, nullptr, d_summ,           \
                        d_frame_h, d_x_emb, dh_inj, stash, cot, 0, stream);  \
  }                                                                          \
  /* K2a, logits out: the logit cotangents d_pitch and d_dur given. */       \
  int pctd_train_bwd_logits##SFX(                                            \
      const TrainWeightsT<T>* w, int B, int phases, int cluster,             \
      const int* coins, const int* lengths, const T* d_pitch,                \
      const T* d_dur, const T* d_summ, T* d_frame_h, T* d_x_emb,             \
      float* dh_inj, const TrainStashT<T>* stash, const TrainCotangents* cot, \
      void* stream) {                                                        \
    return train_bwd<T>(w, B, phases, cluster, coins, nullptr, nullptr,      \
                        lengths, nullptr, d_pitch, d_dur, d_summ, d_frame_h, \
                        d_x_emb, dh_inj, stash, cot, 1, stream);             \
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
// K2a's: kernel 0 the slot rows, 1 the chains (in clusters of `cluster`
// blocks; 0, the size the launch at batch B takes, in cluster_taken), 2
// the projections; for the chains also how many such clusters the card
// holds at once (0 if it cannot say).
int pctd_train_bwd_smem_bytes(const TrainWeightsT<float>* w, int kernel,
                              int cluster, int B, int* cluster_taken,
                              int* max_clusters) {
  if (kernel == 0) return (int)sizeof(float) * slot_layout(*w).n_floats;
  if (kernel == 2) return (int)sizeof(float) * proj_floats(*w);
  const int C = bwd_cluster(*w, B, cluster);
  *cluster_taken = C;
  *max_clusters = chain_clusters_at_once(*w, C);
  return (int)sizeof(float) * chain_floats(*w, C);
}

PCTD_TRAIN_ENTRIES(float, )
#else
PCTD_TRAIN_ENTRIES(bf16, _bf16)
#endif

}  // extern "C"
