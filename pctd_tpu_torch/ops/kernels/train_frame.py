"""K1 + K2: one frame's teacher-forced PianoTree decode (K1), and its
hand-written backward (K2), in two modes.

Replaces the Pallas kernels ``pctd_tpu/ops/pallas/train_frame.py``:
``_fwd_kernel`` (K1, launched by ``_fwd_call``) and ``_bwd_kernel`` (K2,
``_bwd_call``). In loss mode (the JAX package's ``frame_recon_partials``)
the reconstruction cross-entropy is fused in and the frame emits its
masked-CE numerators; in logits-out mode (the JAX package's ``frame_core``)
it emits the pitch and duration logits, and the backward takes their
cotangents from the caller's loss. The CUDA source is
``csrc/train_frame.cu``:

- ``train_fwd_group_kernel`` (K1): the 15 note-GRU slots with the pitch
  head and argmax, the 5-step duration GRU with argmax feedback, the
  predicted-note embedding and the teacher-coin token select, the masked
  bi-GRU summary of the predicted notes, and the masked-CE numerators
  (loss mode) or the logits (logits out), for a group of 16 rows in a
  thread-block cluster, its chain weights streamed from panels packed
  once per weights (:func:`pack_panels`, cached by :func:`panels`); where
  the row groups would run in more waves than pay (B=512), the per-row
  ``train_fwd_kernel`` (the plan: ``build.k1_plan``). On the gradient
  path it also writes every activation the backward needs (the stash,
  :class:`Stash`), so K2 recomputes nothing and replays no argmax.
- K2a, the reverse chain in the phases of the JAX backward, three kernels:
  ``train_bwd_slots_kernel`` (2b: the logit cotangents, computed from the
  targets in loss mode or given in logits-out mode, the duration chains
  and the heads, batched over the slot rows), ``train_bwd_chain_kernel``
  (the two serial chains side by side: 2c the note-GRU reverse recurrence
  in thread-block clusters sharing each weight read among a row group, 2a
  the summary bi-GRU backward) and ``train_bwd_proj_kernel`` (2d: the
  token and embedding routes and ``d_frame_h``, batched). Its products are
  f32-accurate on the tensor cores. It writes the per-sample gate
  cotangents (:class:`Cotangents`), ``d_frame_h`` and ``d_x_emb``.
- ``wgrad_kernel`` and ``wgrad_reduce_kernel`` (K2b): the 24 weight
  gradients as 16 ``X^T . dY`` reductions of stash against cotangents over
  rows, slots and duration steps, f32-accurate on the tensor cores (TF32
  products with split operands), cut into work items of about one length
  by :func:`wgrad_plan` and summed in a fixed order (no atomics). The same
  in both modes.

:func:`frame_recon_plain` (loss mode) and :func:`frame_core_plain` (logits
out) are the plain PyTorch versions of K1 in the kernel's grouping;
autograd of them is K2's plain version (the CPU training path).
:func:`frame_stash_plain` is K1's stash and :func:`frame_bwd_plain` K2a
alone on it, in plain PyTorch; :func:`wgrad_plain` is K2b's. The argmax
decisions and the teacher coins carry no gradient.

Every function here runs in the storage dtype of the weights, float32 or
bfloat16 (the JAX kernels compute in the dtype of their inputs). In bf16
all arithmetic stays f32: products take the bf16 values as f32 and sum in
f32, and a value is rounded to bf16 only where the Pallas kernel writes
``.astype(dtype)`` (the note and duration hiddens, the pitch and duration
logits, the predicted-note embedding, the summary hiddens, and the
duration GRU's two feedback rows). The argmaxes read the rounded logits.
The stash keeps the rounded values in bf16 and the f32 gate values in f32;
the per-sample cotangents and the CE numerators are f32, and each weight
gradient is summed in f32 and rounded once to the weight's dtype.
"""
from __future__ import annotations

import collections
import functools
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from pctd_tpu_torch.config import ModelConfig, PianoTreeSpec
from pctd_tpu_torch.ops.gru import gru_gates
from pctd_tpu_torch.ops.losses import masked_ce_parts


class CoreWeights(NamedTuple):
    """The 24 decoder tensors the frame kernels read (the JAX package's
    ``core_weights`` order; biases 1-D). Field order is the order of the
    pointer fields of ``TrainWeights`` in ``csrc/train_frame.cu``."""
    w_t2n: torch.Tensor       # (TH, NH) note-level init
    b_t2n: torch.Tensor
    w_ih_frame: torch.Tensor  # (TH, 3NH) notes GRU, frame share of w_ih
    w_ih_tok: torch.Tensor    # (E, 3NH) notes GRU, token share of w_ih
    b_ih: torch.Tensor        # (3NH,)
    w_hh: torch.Tensor        # (NH, 3NH)
    b_hh: torch.Tensor
    w_pitch: torch.Tensor     # (NH, P)
    b_pitch: torch.Tensor
    w_dhid: torch.Tensor      # (NH + P, DH) dur-hidden init from [h | est]
    b_dhid: torch.Tensor
    w_dih: torch.Tensor       # (W, 3DH) dur GRU
    b_dih: torch.Tensor
    w_dhh: torch.Tensor       # (DH, 3DH)
    b_dhh: torch.Tensor
    w_dout: torch.Tensor      # (DH, 2)
    b_dout: torch.Tensor
    w_emb: torch.Tensor       # (P + W, E) note embedding
    b_emb: torch.Tensor
    dur_sos: torch.Tensor     # (W,)
    we_ih: torch.Tensor       # (2, E, 3EH) summary bi-GRU [fwd, bwd]
    we_hh: torch.Tensor       # (2, EH, 3EH)
    be_ih: torch.Tensor       # (2, 3EH)
    be_hh: torch.Tensor       # (2, 3EH)


def core_weights(p: dict, cfg: ModelConfig) -> CoreWeights:
    """The decoder params ``p`` as the kernels' 24 tensors: views and slices
    of the params (the notes-GRU ``w_ih`` split at the time-hidden width)
    and stacks of the summary GRUs, all differentiable, so autograd routes
    the kernels' weight gradients back to ``p``."""
    th = cfg.dec_time_hidden
    ng, dg = p["notes_gru"], p["dur_gru"]
    ef, eb = p["emb_fwd"], p["emb_bwd"]
    return CoreWeights(
        p["time2notes"]["w"], p["time2notes"]["b"],
        ng.w_ih[:th], ng.w_ih[th:], ng.b_ih, ng.w_hh, ng.b_hh,
        p["pitch_out"]["w"], p["pitch_out"]["b"],
        p["dur_hid"]["w"], p["dur_hid"]["b"],
        dg.w_ih, dg.b_ih, dg.w_hh, dg.b_hh,
        p["dur_out"]["w"], p["dur_out"]["b"],
        p["note_emb"]["w"], p["note_emb"]["b"], p["dur_sos"],
        torch.stack([ef.w_ih, eb.w_ih]), torch.stack([ef.w_hh, eb.w_hh]),
        torch.stack([ef.b_ih, eb.b_ih]), torch.stack([ef.b_hh, eb.b_hh]))


#: storage dtypes the frame kernels take
DTYPES = (torch.float32, torch.bfloat16)
#: the plain versions also take float64 (the reference of the f32 kernels)
PLAIN_DTYPES = DTYPES + (torch.float64,)


class _RoundTo(torch.autograd.Function):
    """f32 -> the nearest value of ``dtype``, kept in f32; the backward
    passes the cotangent through unchanged, as the hand-written VJP of the
    JAX kernel does at its rounding points (its cotangents stay f32)."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _rounding(dtype: torch.dtype):
    """The rounding of a value to ``dtype`` (identity for float32 and
    float64)."""
    if dtype != torch.bfloat16:
        return lambda x: x
    return lambda x: _RoundTo.apply(x, dtype)


def storage_dtype(cw: CoreWeights) -> torch.dtype:
    """The one dtype of the 24 weights; raises on a mix or a dtype outside
    :data:`PLAIN_DTYPES` (the kernels take only :data:`DTYPES`)."""
    dts = {w.dtype for w in cw}
    if len(dts) != 1 or next(iter(dts)) not in PLAIN_DTYPES:
        raise TypeError(f"train-frame weights must all be float32, all "
                        f"bfloat16 or all float64, got "
                        f"{sorted(map(str, dts))}")
    return next(iter(dts))


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic dtype of the plain versions for weights of ``dtype``:
    float64 for float64, float32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class FrameOut(NamedTuple):
    nums: torch.Tensor      # (1 + W,) masked-CE numerators [pitch, bits]
    summary: torch.Tensor   # (B, 2EH) predicted-frame summary
    lengths: torch.Tensor   # (B,) int32 eos lengths
    hs: torch.Tensor        # (K, B, NH) note-GRU hiddens, hs[0] initial
    pitch: torch.Tensor     # (B, K-1) int32 pitch argmaxes
    bits: torch.Tensor      # (B, K-1, W) int32 duration bits


class CoreOut(NamedTuple):
    pitch_logits: torch.Tensor  # (B, K-1, P)
    dur_logits: torch.Tensor    # (B, K-1, W, 2)
    summary: torch.Tensor       # (B, 2EH) predicted-frame summary
    lengths: torch.Tensor       # (B,) int32 eos lengths


def _summary_plain(c: CoreWeights, pred: torch.Tensor,
                   lengths: torch.Tensor, rnd, rec=None) -> torch.Tensor:
    """The masked bi-GRU summary of ``_summary_fwd`` (pack_padded
    semantics) over pred (B, K, E), each new hidden rounded by ``rnd``.
    ``rec`` (lists by stash field) records, step by step, the hidden before
    the step and its gates."""
    B, K, _ = pred.shape
    mask = (torch.arange(K, device=pred.device)[None, :]
            < lengths[:, None])
    out = []
    for d in range(2):
        gi = pred @ c.we_ih[d] + c.be_ih[d]
        h = pred.new_zeros((B, c.we_hh.shape[1]))
        if rec is not None:
            rec["sgi"].append(gi)
        for k in (range(K) if d == 0 else range(K - 1, -1, -1)):
            gh = h @ c.we_hh[d] + c.be_hh[d]
            h_new, gates = gru_gates(gi[:, k], gh, h)
            if rec is not None:
                rec["sh"].append(h)
                rec["sg"].append(torch.cat(gates, -1))
                rec["sgh"].append(gh)
            h = rnd(torch.where(mask[:, k, None], h_new, h))
        out.append(h)
    return torch.cat(out, dim=-1)


def _frame_plain(cw: CoreWeights, spec: PianoTreeSpec,
                 frame_h: torch.Tensor, x_emb: torch.Tensor,
                 coins: torch.Tensor, rec=None):
    """One frame's teacher-forced decode in K1's grouping (``_run_forward``
    and ``_summary_fwd`` of the JAX kernel), in f32 arithmetic (f64 for
    f64 weights) with the rounding points of the weights' dtype (see the
    module docstring). Returns tensors of that arithmetic holding values of
    the weights' dtype: (pitch logits (B, K-1, P), dur logits
    (B, K-1, W, 2), summary, lengths, hs, pitch argmaxes (B, K-1), dur bits
    (B, K-1, W)). ``rec`` (a defaultdict of lists) records, slot by slot,
    what K1 stashes beyond those (:func:`frame_stash_plain`) and the tensors
    whose gradients are K2a's cotangents (the gate projections ``gi``,
    ``gh``, ``gid``, ``ghd``, ``sgi``, ``sgh``, ``gi_frame``, the logits
    ``est`` and ``logit``, the hidden inits ``h0`` and ``hd0``)."""
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    B = frame_h.shape[0]
    dt = storage_dtype(cw)
    rnd, f = _rounding(dt), compute_dtype(dt)
    # one f32 view of each weight, so autograd sums a weight's gradient in
    # f32 and rounds it to the weight's dtype once (no copy in float32)
    c = CoreWeights(*(w.to(f) for w in cw))
    frame_h, x_emb = frame_h.to(f), x_emb.to(f)
    gi_d_sos = c.dur_sos @ c.w_dih + c.b_dih
    row0 = rnd(c.w_dih[0] + c.b_dih)
    row1 = rnd(c.w_dih[1] + c.b_dih)
    h = rnd(frame_h @ c.w_t2n + c.b_t2n)
    gi_frame = frame_h @ c.w_ih_frame + c.b_ih
    gh = h @ c.w_hh + c.b_hh
    if rec is not None:
        rec["h0"], rec["gi_frame"] = h, gi_frame
    token = x_emb[:, 0]
    hs, pred, ests, dur_logits, pitches, all_bits = [h], [token], [], [], \
        [], []
    lengths = torch.zeros(B, dtype=torch.int32, device=frame_h.device)
    for k in range(1, K):
        gi = gi_frame + token @ c.w_ih_tok
        h_new, gates = gru_gates(gi, gh, h)
        if rec is not None:
            rec["tok"].append(token)
            rec["ng"].append(torch.cat(gates, -1))
            rec["gi"].append(gi)
            rec["gh"].append(gh)
        h = rnd(h_new)
        hs.append(h)
        gh = h @ c.w_hh + c.b_hh
        est = rnd(h @ c.w_pitch + c.b_pitch)
        pitch = est.argmax(-1)
        h_d = rnd(torch.cat([h, est], -1) @ c.w_dhid + c.b_dhid)
        gh_d = h_d @ c.w_dhh + c.b_dhh
        gi_d = gi_d_sos.expand(B, -1)
        d_tok = c.dur_sos.expand(B, -1)
        logits, bits, hds, dgs, dtoks = [], [], [h_d], [], []
        if rec is not None:
            rec["est"].append(est)
            rec["hd0"].append(h_d)
        for _ in range(W):
            if rec is not None:
                rec["gid"].append(gi_d)
                rec["ghd"].append(gh_d)
            h_new, gates = gru_gates(gi_d, gh_d, h_d)
            h_d = rnd(h_new)
            logit = rnd(h_d @ c.w_dout + c.b_dout)
            gh_d = h_d @ c.w_dhh + c.b_dhh
            bitf = (logit[:, 1:2] > logit[:, 0:1]).to(h.dtype)
            gi_d = bitf * row1 + (1.0 - bitf) * row0
            logits.append(logit)
            bits.append(bitf[:, 0])
            if rec is not None:
                rec["logit"].append(logit)
                hds.append(h_d)
                dgs.append(torch.cat(gates, -1))
                dtoks.append(d_tok)
                d_tok = torch.nn.functional.one_hot(
                    bitf[:, 0].long(), W).to(h.dtype)
        bits = torch.stack(bits, -1)
        raw = torch.cat([torch.nn.functional.one_hot(pitch, P).to(h.dtype),
                         bits], -1)
        emb = rnd(raw @ c.w_emb + c.b_emb)
        if rec is not None:
            rec["hd"].append(torch.stack(hds, 1))
            rec["dg"].append(torch.stack(dgs, 1))
            rec["dtok"].append(torch.stack(dtoks, 1))
            rec["emb_in"].append(raw)
        pred.append(emb)
        pitch = pitch.to(torch.int32)
        is_eos = (pitch == spec.pitch_eos) & (lengths == 0)
        lengths = torch.where(is_eos, torch.full_like(lengths, k), lengths)
        token = torch.where(coins[k - 1] != 0, x_emb[:, k], emb)
        ests.append(est)
        dur_logits.append(torch.stack(logits, 1))
        pitches.append(pitch)
        all_bits.append(bits.to(torch.int32))
    lengths = torch.where(lengths == 0, torch.full_like(lengths, K - 1),
                          lengths)
    if rec is not None:
        rec["pred"] = pred
    summary = _summary_plain(c, torch.stack(pred, 1), lengths, rnd, rec)
    return (torch.stack(ests, 1), torch.stack(dur_logits, 1), summary,
            lengths, torch.stack(hs), torch.stack(pitches, 1),
            torch.stack(all_bits, 1))


def frame_recon_plain(cw: CoreWeights, spec: PianoTreeSpec,
                      frame_h: torch.Tensor, x_emb: torch.Tensor,
                      coins: torch.Tensor, gt_pitch: torch.Tensor,
                      gt_dur: torch.Tensor) -> FrameOut:
    """Plain PyTorch version of K1 in loss mode, in the kernel's grouping
    (``_run_forward``, ``_summary_fwd`` and ``_ce_nll_sum`` of the JAX
    kernel): one frame's teacher-forced decode and its CE numerators.

    frame_h (B, TH) time hidden; x_emb (B, K, E) ground-truth note
    embeddings (x_emb[:, 0] is the sos token); coins (K-1,) teacher flags of
    slots 1..K-1; gt_pitch (B, K-1) and gt_dur (B, K-1, W) integer targets.
    frame_h, x_emb, the summary and hs are in the weights' dtype; the
    numerators are f32.
    """
    dt = storage_dtype(cw)
    est_all, dur_all, summary, lengths, hs, pitch, bits = _frame_plain(
        cw, spec, frame_h, x_emb, coins)
    nums = [masked_ce_parts(est_all, gt_pitch, spec.pitch_pad)[0]]
    nums += [masked_ce_parts(dur_all[:, :, w], gt_dur[..., w],
                             spec.dur_pad)[0] for w in range(spec.dur_width)]
    return FrameOut(torch.stack(nums), summary.to(dt), lengths, hs.to(dt),
                    pitch, bits)


def frame_core_plain(cw: CoreWeights, spec: PianoTreeSpec,
                     frame_h: torch.Tensor, x_emb: torch.Tensor,
                     coins: torch.Tensor) -> CoreOut:
    """Plain PyTorch version of K1 in logits-out mode (the JAX package's
    ``frame_core``): one frame's teacher-forced decode, returning the pitch
    and duration logits, the predicted-frame summary and the lengths (the
    first three in the weights' dtype). Arguments as in
    :func:`frame_recon_plain`."""
    dt = storage_dtype(cw)
    pitch, dur, summary, lengths = _frame_plain(cw, spec, frame_h, x_emb,
                                                coins)[:4]
    return CoreOut(pitch.to(dt), dur.to(dt), summary.to(dt), lengths)


def frame_stash_plain(cw: CoreWeights, spec: PianoTreeSpec,
                      frame_h: torch.Tensor, x_emb: torch.Tensor,
                      coins: torch.Tensor) -> "Stash":
    """K1's stash in plain PyTorch: the :class:`Stash` K1 writes on the
    gradient path, from :func:`_frame_plain`'s arithmetic and rounding
    points (the gates in f32, f64 for f64 weights; every other field in the
    weights' dtype). Arguments as in :func:`frame_recon_plain`."""
    rec = collections.defaultdict(list)
    est, dur, _, _, hs = _frame_plain(cw, spec, frame_h, x_emb, coins,
                                      rec)[:5]
    dt = storage_dtype(cw)
    gate = compute_dtype(dt)
    K = spec.max_simu_note
    st = lambda name: torch.stack(rec[name])
    fields = Stash(
        hs=hs, ng=st("ng"), tok=st("tok"), est=est.transpose(0, 1),
        hd=st("hd"), dg=st("dg"), dlog=dur.transpose(0, 1), dtok=st("dtok"),
        emb_in=st("emb_in"), pred=st("pred"),
        sh=st("sh").reshape(2, K, hs.shape[1], -1),
        sg=st("sg").reshape(2, K, hs.shape[1], -1))
    return Stash(*(x.to(gate if name in F32_STASH else dt).contiguous()
                   for name, x in zip(Stash._fields, fields)))


def _gru_bwd(dh: torch.Tensor, h_prev: torch.Tensor, gates: torch.Tensor):
    """Backward of one torch-order GRU step from its stashed gates
    [r | z | n | h_n] (``gru_bwd`` in ``csrc/train_frame.cu``): (input-gate
    cotangents, hidden-gate cotangents, dh * z, the direct share of
    d h_prev)."""
    r, z, n, hn = gates.chunk(4, dim=-1)
    dz = dh * (h_prev - n)
    dn = dh * (1.0 - z)
    dn_pre = dn * (1.0 - n * n)
    dz_pre = dz * z * (1.0 - z)
    dr_pre = dn_pre * hn * r * (1.0 - r)
    return (torch.cat([dr_pre, dz_pre, dn_pre], -1),
            torch.cat([dr_pre, dz_pre, dn_pre * r], -1), dh * z)


def _mm(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y @ w.T: a cotangent (..., O) through a weight (I, O)."""
    return y @ w.t()


def _frame_bwd(cw: CoreWeights, spec: PianoTreeSpec, coins, gt_pitch,
               gt_dur, lengths, st: "Stash", d_nums, d_summ, d_pitch, d_dur,
               mm: Callable = _mm):
    """:func:`frame_bwd_plain` with its products ``mm(y, w)`` = y @ w.T
    given (a test emulates K2a's tensor-core products through it)."""
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    dt = storage_dtype(cw)
    f = compute_dtype(dt)
    c = CoreWeights(*(w.to(f) for w in cw))
    st = Stash(*(x.to(f) for x in st))
    S, B = K - 1, lengths.shape[0]
    NH, EH = c.w_hh.shape[0], c.we_hh.shape[1]
    # the logit cotangents: the CE's g * mask * (softmax - onehot) from the
    # targets (loss mode), or given (logits out)
    if d_pitch is None:
        g = d_nums.to(f)
        gt = gt_pitch.t().long()                          # (S, B)
        mask = gt != spec.pitch_pad
        onehot = torch.nn.functional.one_hot(torch.where(mask, gt, 0), P)
        d_est_ce = (torch.where(mask, g[0], 0.0)[..., None]
                    * (torch.softmax(st.est, -1) - onehot.to(f)))
        gt = gt_dur.permute(1, 0, 2).long()               # (S, B, W)
        mask = gt != spec.dur_pad
        onehot = torch.nn.functional.one_hot(torch.where(mask, gt, 0), 2)
        d_log = (torch.where(mask, g[1:], 0.0)[..., None]
                 * (torch.softmax(st.dlog, -1) - onehot.to(f)))
    else:
        d_est_ce = d_pitch.transpose(0, 1).to(f)
        d_log = d_dur.transpose(0, 1).to(f)

    # 2a: the summary bi-GRU, serial over the K steps of each direction;
    # only d_gh @ we_hh.T is on the serial path, d_pred is batched after
    valid = torch.arange(K, device=lengths.device)[:, None] < lengths
    d_sgi, d_sgh = [[None] * K for _ in range(2)], [[None] * K
                                                    for _ in range(2)]
    for d in range(2):
        dsum = d_summ[:, d * EH:(d + 1) * EH].to(f)
        for k in range(K - 1, -1, -1):
            slot = k if d == 0 else K - 1 - k
            m = valid[slot][:, None].to(f)
            dgi, dgh, direct = _gru_bwd(m * dsum, st.sh[d, k], st.sg[d, k])
            d_sgi[d][slot], d_sgh[d][k] = dgi, dgh
            dsum = (1.0 - m) * dsum + direct + mm(dgh, c.we_hh[d])
    d_sgi = torch.stack([torch.stack(x) for x in d_sgi])  # (2, K, B, 3EH)
    d_sgh = torch.stack([torch.stack(x) for x in d_sgh])
    d_pred = mm(d_sgi[0], c.we_ih[0]) + mm(d_sgi[1], c.we_ih[1])

    # 2b: the duration chains and the heads, batched over the S*B slot rows
    d_hd = st.hd.new_zeros(st.hd[:, :, 0].shape)
    d_gid, d_ghd = [None] * W, [None] * W
    for ws in range(W - 1, -1, -1):
        dhv = d_hd + mm(d_log[:, :, ws], c.w_dout)
        d_gid[ws], d_ghd[ws], direct = _gru_bwd(dhv, st.hd[:, :, ws],
                                                st.dg[:, :, ws])
        d_hd = direct + mm(d_ghd[ws], c.w_dhh)
    d_sos = mm(d_gid[0], c.w_dih)
    d_dhid_in = mm(d_hd, c.w_dhid)
    d_est = d_est_ce + d_dhid_in[..., NH:]
    dh_inj = d_dhid_in[..., :NH] + mm(d_est, c.w_pitch)

    # 2c: the note-GRU reverse recurrence, serial over the slots; only
    # d_gh @ w_hh.T is on the serial path
    dh = st.hs.new_zeros(st.hs[0].shape)
    d_gif = st.ng.new_zeros(B, 3 * NH)
    d_gi, d_gh = [None] * S, [None] * S
    for s in range(S - 1, -1, -1):
        d_gi[s], d_gh[s], direct = _gru_bwd(dh + dh_inj[s], st.hs[s],
                                            st.ng[s])
        d_gif = d_gif + d_gi[s]
        dh = direct + mm(d_gh[s], c.w_hh)
    d_gi, d_gh = torch.stack(d_gi), torch.stack(d_gh)

    # 2d: the token and embedding routes, batched over the slot rows, and
    # d_frame_h. Slot k's embedding feeds the summary and, unless the coin
    # took the ground truth, the token of slot k+1 (none after the last)
    d_tok = mm(d_gi, c.w_ih_tok)              # d of the token slot s+1 took
    nxt = torch.cat([d_tok[1:], torch.zeros_like(d_tok[:1])])
    coin = (coins != 0)[:, None, None]
    d_emb = d_pred[1:] + torch.where(coin, 0.0, nxt)
    d_x_emb = torch.cat([(d_tok[0] + d_pred[0])[None],
                         torch.where(coin, nxt, 0.0)]).transpose(0, 1)
    d_frame_h = mm(dh, c.w_t2n) + mm(d_gif, c.w_ih_frame)
    ct = Cotangents(d_gi, d_gh, d_est, d_hd, torch.stack(d_gid, 2),
                    torch.stack(d_ghd, 2), d_log, d_sos, d_emb, d_sgi, d_sgh,
                    dh, d_gif)
    return (d_frame_h.to(dt), d_x_emb.to(dt).contiguous(),
            Cotangents(*(x.contiguous() for x in ct)))


def frame_bwd_plain(cw: CoreWeights, spec: PianoTreeSpec, frame_h, coins,
                    gt_pitch, gt_dur, lengths, st: "Stash", d_nums, d_summ,
                    d_pitch: Optional[torch.Tensor] = None,
                    d_dur: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K2a alone: the hand-written VJP of the frame
    (``_frame_bwd_core`` of the JAX package without its weight-gradient
    adds) on K1's stash ``st`` (:func:`frame_stash_plain`), in the JAX
    phase order: 2a the summary bi-GRU backward, 2b the logit cotangents,
    duration chains and heads batched over the slot rows, 2c the note-GRU
    reverse recurrence, 2d the token and embedding routes and d_frame_h.
    Loss mode (``d_pitch`` None): the logit cotangents come from the
    targets and d_nums (1+W,), the cotangents of the CE numerators; logits
    out: from d_pitch (B, K-1, P) and d_dur (B, K-1, W, 2). Computes in f32
    (f64 for f64 weights and stash) and returns (d_frame_h (B, TH), d_x_emb
    (B, K, E), both in the weights' dtype, :class:`Cotangents` in the
    arithmetic's dtype). frame_h is not read (the signature is K2a's)."""
    del frame_h
    return _frame_bwd(cw, spec, coins, gt_pitch, gt_dur, lengths, st,
                      d_nums, d_summ, d_pitch, d_dur)


class Stash(NamedTuple):
    """Activations K1 writes on the gradient path and K2 reads (one frame;
    S = K-1 slots). Field order is ``TrainStash`` in ``csrc/train_frame.cu``.
    The gate values (``ng``, ``dg``, ``sg``) are f32; the other fields hold
    values of the storage dtype and are stored in it (:data:`F32_STASH`).
    """
    hs: torch.Tensor      # (K, B, NH) note-GRU hiddens, hs[0] initial
    ng: torch.Tensor      # (S, B, 4NH) note-GRU gates r, z, n, h_n
    tok: torch.Tensor     # (S, B, E) token consumed by slot k (k = 1..)
    est: torch.Tensor     # (S, B, P) pitch logits
    hd: torch.Tensor      # (S, B, W+1, DH) dur hiddens, hd[0] initial
    dg: torch.Tensor      # (S, B, W, 4DH) dur-GRU gates
    dlog: torch.Tensor    # (S, B, W, 2) dur logits
    dtok: torch.Tensor    # (S, B, W, W) dur-GRU input tokens
    emb_in: torch.Tensor  # (S, B, P+W) raw predicted note [one-hot | bits]
    pred: torch.Tensor    # (K, B, E) summary inputs, pred[0] = x_emb[:, 0]
    sh: torch.Tensor      # (2, K, B, EH) summary hidden before step k
    sg: torch.Tensor      # (2, K, B, 4EH) summary gates at step k


#: the stash fields kept in f32 whatever the storage dtype
F32_STASH = ("ng", "dg", "sg")


class Cotangents(NamedTuple):
    """Per-sample cotangents K2a writes and K2b reduces against the stash.
    Field order is ``TrainCotangents`` in ``csrc/train_frame.cu``."""
    d_gi: torch.Tensor    # (S, B, 3NH) note-GRU input gates
    d_gh: torch.Tensor    # (S, B, 3NH) note-GRU hidden gates
    d_est: torch.Tensor   # (S, B, P)
    d_hd0: torch.Tensor   # (S, B, DH)
    d_gid: torch.Tensor   # (S, B, W, 3DH)
    d_ghd: torch.Tensor   # (S, B, W, 3DH)
    d_log: torch.Tensor   # (S, B, W, 2)
    d_sos: torch.Tensor   # (S, B, W) dur_sos cotangent of each sample
    d_emb: torch.Tensor   # (S, B, E)
    d_sgi: torch.Tensor   # (2, K, B, 3EH) summary input gates, by slot
    d_sgh: torch.Tensor   # (2, K, B, 3EH) summary hidden gates, by step
    dh0: torch.Tensor     # (B, NH)
    d_gif: torch.Tensor   # (B, 3NH)


class Dims(NamedTuple):
    """Integer fields of ``TrainWeights`` in ``csrc/train_frame.cu``."""
    TH: int
    NH: int
    DH: int
    E: int
    EH: int
    P: int
    W: int
    K: int
    eos: int
    pitch_pad: int
    dur_pad: int


def dims_of(cw: CoreWeights, spec: PianoTreeSpec) -> Dims:
    return Dims(TH=cw.w_t2n.shape[0], NH=cw.w_hh.shape[0],
                DH=cw.w_dhh.shape[0], E=cw.w_ih_tok.shape[0],
                EH=cw.we_hh.shape[1], P=cw.w_pitch.shape[1],
                W=cw.w_dih.shape[0], K=spec.max_simu_note,
                eos=spec.pitch_eos, pitch_pad=spec.pitch_pad,
                dur_pad=spec.dur_pad)


def _empty(dev, *shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=dev)


def new_stash(d: Dims, B: int, dev, dtype=torch.float32) -> Stash:
    """An empty :class:`Stash` of B rows for weights of ``dtype``."""
    S = d.K - 1
    shapes = Stash(
        (d.K, B, d.NH), (S, B, 4 * d.NH), (S, B, d.E), (S, B, d.P),
        (S, B, d.W + 1, d.DH), (S, B, d.W, 4 * d.DH), (S, B, d.W, 2),
        (S, B, d.W, d.W), (S, B, d.P + d.W), (d.K, B, d.E),
        (2, d.K, B, d.EH), (2, d.K, B, 4 * d.EH))
    return Stash(*(_empty(dev, *shape, dtype=torch.float32
                          if name in F32_STASH else dtype)
                   for name, shape in zip(Stash._fields, shapes)))


def new_cotangents(d: Dims, B: int, dev) -> Cotangents:
    S = d.K - 1
    return Cotangents(
        _empty(dev, S, B, 3 * d.NH), _empty(dev, S, B, 3 * d.NH),
        _empty(dev, S, B, d.P), _empty(dev, S, B, d.DH),
        _empty(dev, S, B, d.W, 3 * d.DH), _empty(dev, S, B, d.W, 3 * d.DH),
        _empty(dev, S, B, d.W, 2), _empty(dev, S, B, d.W),
        _empty(dev, S, B, d.E), _empty(dev, 2, d.K, B, 3 * d.EH),
        _empty(dev, 2, d.K, B, 3 * d.EH), _empty(dev, B, d.NH),
        _empty(dev, B, 3 * d.NH))


class WgradTask(NamedTuple):
    """One ``gW = X^T dY`` (and ``gb = 1^T dY``) reduction of K2b over N
    samples; sample n's row of X starts at element
    ``(n // n_in) * x_o + (n % n_in) * x_i`` of ``X`` (dY likewise)."""
    X: torch.Tensor
    DY: torch.Tensor
    gW: torch.Tensor
    gb: torch.Tensor
    N: int
    I: int
    O: int
    n_in: int
    x_o: int
    x_i: int
    y_o: int
    y_i: int


#: the reductions of :func:`wgrad_tasks`, in its order
WGRAD_NAMES = ("w_t2n", "w_ih_frame", "w_ih_tok", "w_hh", "w_pitch",
               "w_dhid[:NH]", "w_dhid[NH:]", "w_dih", "w_dhh", "w_dout",
               "dur_sos", "w_emb", "we_ih[0]", "we_hh[0]", "we_ih[1]",
               "we_hh[1]")


def wgrad_tasks(d: Dims, B: int, frame_h: torch.Tensor, st: Stash,
                ct: Cotangents, grads: CoreWeights):
    """The K2b reductions of one frame, writing into ``grads`` (24 tensors
    shaped like the weights)."""
    S, W, NH, DH, EH, P = d.K - 1, d.W, d.NH, d.DH, d.EH, d.P
    SB, KB = S * B, d.K * B
    none = grads.b_t2n.new_empty(0)
    g = grads

    def task(X, DY, gW, gb, N, I, O, n_in=1, x_o=None, x_i=0, y_o=None,
             y_i=0):
        return WgradTask(X, DY, gW, none if gb is None else gb, N, I, O,
                         n_in, I if x_o is None else x_o, x_i,
                         O if y_o is None else y_o, y_i)

    tasks = [
        task(frame_h, ct.dh0, g.w_t2n, g.b_t2n, B, d.TH, NH),
        task(frame_h, ct.d_gif, g.w_ih_frame, g.b_ih, B, d.TH, 3 * NH),
        task(st.tok, ct.d_gi, g.w_ih_tok, None, SB, d.E, 3 * NH),
        task(st.hs, ct.d_gh, g.w_hh, g.b_hh, SB, NH, 3 * NH),
        task(st.hs[1:], ct.d_est, g.w_pitch, g.b_pitch, SB, NH, P),
        task(st.hs[1:], ct.d_hd0, g.w_dhid[:NH], g.b_dhid, SB, NH, DH),
        task(st.est, ct.d_hd0, g.w_dhid[NH:], None, SB, P, DH),
        task(st.dtok, ct.d_gid, g.w_dih, g.b_dih, SB * W, W, 3 * DH),
        task(st.hd, ct.d_ghd, g.w_dhh, g.b_dhh, SB * W, DH, 3 * DH,
             n_in=W, x_o=(W + 1) * DH, x_i=DH, y_o=W * 3 * DH, y_i=3 * DH),
        task(st.hd[:, :, 1:], ct.d_log, g.w_dout, g.b_dout, SB * W, DH, 2,
             n_in=W, x_o=(W + 1) * DH, x_i=DH, y_o=W * 2, y_i=2),
        task(none, ct.d_sos, none, g.dur_sos, SB, 0, W),
        task(st.emb_in, ct.d_emb, g.w_emb, g.b_emb, SB, P + W, d.E),
    ]
    for i in range(2):
        tasks.append(task(st.pred, ct.d_sgi[i], g.we_ih[i], g.be_ih[i], KB,
                          d.E, 3 * EH))
        tasks.append(task(st.sh[i], ct.d_sgh[i], g.we_hh[i], g.be_hh[i],
                          KB, EH, 3 * EH))
    return tasks


def _rows(t: torch.Tensor, N: int, width: int, n_in: int, outer: int,
          inner: int) -> torch.Tensor:
    """(N, width) view of a task operand: sample n's row starts at element
    ``(n // n_in) * outer + (n % n_in) * inner`` of ``t``'s storage."""
    return t.as_strided((N // n_in, n_in, width), (outer, inner, 1)
                        ).reshape(N, width)


def task_rows(tk: WgradTask):
    """(X (N, I) or None when I = 0, dY (N, O)): a task's operands as row
    views."""
    dy = _rows(tk.DY, tk.N, tk.O, tk.n_in, tk.y_o, tk.y_i)
    x = _rows(tk.X, tk.N, tk.I, tk.n_in, tk.x_o, tk.x_i) if tk.I else None
    return x, dy


def wgrad_plain(tasks) -> None:
    """Plain PyTorch version of K2b: each task's ``X^T dY`` and column sum
    as torch products in the cotangents' dtype (f32; f64 for an f64
    reference), written (rounded once) into the same outputs."""
    for tk in tasks:
        x, dy = task_rows(tk)
        if x is not None:
            tk.gW.copy_(x.to(dy.dtype).t() @ dy)
        if tk.gb.numel():
            tk.gb.copy_(dy.sum(0))


#: K2b's square output tile (rows of gW, the bias row included, by
#: columns) and the samples a pipeline stage holds: ``WG_TILE`` and
#: ``WG_CHUNK`` in ``csrc/train_frame.cu``
WG_TILE, WG_CHUNK = 64, 32
#: the most f32 partial-sum workspace a K2b plan may take (bytes)
WG_WS_CAP = 48 << 20


class WgradPlan(NamedTuple):
    """K2b's work decomposition (:func:`wgrad_plan`). Task k is cut into
    ``slices[k]`` N-slices of whole ``WG_CHUNK``-sample chunks: slice j of
    C = ceil(N / WG_CHUNK) chunks covers chunks [j C // s, (j + 1) C // s).
    A work item is one (task, output tile, slice): one block of
    ``wgrad_kernel``, which numbers them from this table, tasks in
    ``order``, within a task slice-major, tiles row-major. A task with more
    than one slice writes f32 partials [slice][I + bias][O] at element
    ``ws_off[k]`` of a ``ws_elems``-element workspace, which a second pass
    sums in slice order."""
    slices: Tuple[int, ...]
    order: Tuple[int, ...]
    ws_off: Tuple[int, ...]
    ws_elems: int
    length: int          # the most chunks an item may take


def wgrad_shapes(tasks) -> tuple:
    """The (N, I, O, bias) of each task: all a K2b plan depends on."""
    return tuple((t.N, t.I, t.O, bool(t.gb.numel())) for t in tasks)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def wgrad_plan(shapes: tuple) -> WgradPlan:
    """Cut K2b's reductions (:func:`wgrad_shapes`) into work items of about
    one length. Every item runs its chunks one after another, so the
    longest item sets the kernel's time: a task of N samples over few
    output tiles (the duration GRU's 9,600 at B=128) is cut into many
    N-slices. The length L (in chunks) an item may take is the least that
    keeps the f32 partials of the cut tasks within ``WG_WS_CAP`` bytes,
    and no less than the tile-weighted median task length (cutting below
    what most tiles run anyway shortens nothing and adds partials). Each
    task takes ceil(C / L) slices; tasks run longest items first."""
    rows = [i + b for _, i, _, b in shapes]
    tiles = [_cdiv(r, WG_TILE) * _cdiv(o, WG_TILE)
             for r, (_, _, o, _) in zip(rows, shapes)]
    chunks = [_cdiv(n, WG_CHUNK) for n, _, _, _ in shapes]
    by_len = sorted(zip(chunks, tiles))
    half, seen, length = sum(tiles) / 2, 0, by_len[-1][0]
    for c, n in by_len:
        seen += n
        if seen >= half:
            length = c
            break

    def cut(length):
        slices = [_cdiv(c, length) for c in chunks]
        ws = sum(s * r * o for s, r, (_, _, o, _) in
                 zip(slices, rows, shapes) if s > 1)
        return slices, ws

    slices, ws = cut(length)
    while 4 * ws > WG_WS_CAP and length < max(chunks):
        length += 1
        slices, ws = cut(length)
    longest = [_cdiv(c, s) for c, s in zip(chunks, slices)]
    order = tuple(sorted(range(len(shapes)), key=lambda k: -longest[k]))
    ws_off, off = [0] * len(shapes), 0
    for k in order:
        if slices[k] > 1:
            ws_off[k], off = off, off + slices[k] * rows[k] * shapes[k][2]
    return WgradPlan(tuple(slices), order, tuple(ws_off), off,
                     max(longest))


def wgrad(tasks) -> None:
    """K2b on ``tasks`` (CUDA tensors): plans the work (:func:`wgrad_plan`,
    cached by shapes), allocates the f32 workspace and launches. Raises on
    a tensor off the card, of another dtype than the gradients' (the
    cotangents f32), or a non-contiguous cotangent or gradient."""
    from pctd_tpu_torch.ops.kernels import build

    dev, dt = tasks[0].DY.device, tasks[0].gb.dtype
    if dev.type != "cuda":
        raise ValueError(f"K2b takes CUDA tensors, got {dev}")
    for k, t in enumerate(tasks):
        for name, x, want in (("X", t.X, dt), ("DY", t.DY, torch.float32),
                              ("gW", t.gW, dt), ("gb", t.gb, dt)):
            if not x.numel():
                continue
            if x.device != dev:
                raise ValueError(f"K2b task {k} {name} is on {x.device}, "
                                 f"expected {dev}")
            if x.dtype != want:
                raise TypeError(f"K2b task {k} {name} has dtype {x.dtype}, "
                                f"expected {want}")
            if name != "X" and not x.is_contiguous():
                raise ValueError(f"K2b task {k} {name} is not contiguous")
    plan = wgrad_plan(wgrad_shapes(tasks))
    ws = (torch.empty(plan.ws_elems, dtype=torch.float32, device=dev)
          if plan.ws_elems else None)
    build.launch_wgrad([tasks[k] for k in plan.order],
                       [plan.slices[k] for k in plan.order], ws,
                       [plan.ws_off[k] for k in plan.order])


#: the cluster sizes K1 takes (``cluster_ok`` in ``csrc/group.cuh``)
K1_CLUSTERS = (16, 8)
#: the weights K1's panels hold, in the order :func:`panel_index` lists them
PANEL_FIELDS = ("w_ih_tok", "w_pitch", "w_dhid", "w_hh", "we_ih", "we_hh",
                "w_dout", "w_dhh")


def _part(n: int, C: int, c: int) -> int:
    """First index of share c when n items (a multiple of 4) are cut into C
    shares of whole quads (``part`` in ``csrc/group.cuh``)."""
    return 4 * ((n // 4) * c // C)


def _pad4(n: int) -> int:
    return (n + 3) & ~3


class K1Share(NamedTuple):
    """Block c's shares of a K1 cluster of C (``k1_share`` in
    ``csrc/train_frame.cu``): its note units [j0, j0 + U), pitch columns
    [p0, p0 + Pc) of pad4(P), dur-hidden columns [d0, d0 + Dc), and its
    summary units [e0, e0 + SU) of direction ``d``."""
    j0: int
    U: int
    p0: int
    Pc: int
    d0: int
    Dc: int
    d: int
    e0: int
    SU: int


def k1_share(d: Dims, C: int, c: int) -> K1Share:
    Pp, Cd = _pad4(d.P), C // 2
    sd, cc = c // Cd, c % Cd
    j0, p0, d0, e0 = (_part(d.NH, C, c), _part(Pp, C, c), _part(d.DH, C, c),
                      _part(d.EH, Cd, cc))
    return K1Share(j0, _part(d.NH, C, c + 1) - j0, p0,
                   _part(Pp, C, c + 1) - p0, d0, _part(d.DH, C, c + 1) - d0,
                   sd, e0, _part(d.EH, Cd, cc + 1) - e0)


class PanelLayout(NamedTuple):
    """K1's panel buffer (``K1PanelsT`` in ``csrc/train_frame.cu``), in
    elements of the storage dtype: block c's panel at ``c * pstride`` with
    its sections at ``o_tok`` (w_ih_tok, (E, 3U)), ``o_h`` ([w_pitch |
    w_dhid[:NH] | w_hh], (NH, Pc + Dc + 3U)), ``o_sih`` and ``o_shh``
    (we_ih[d] (E, 3SU), we_hh[d] (EH, 3SU)), each k-major; then, once,
    [w_dout | w_dhh] (DH, 2 + 3DH) at ``o_wdc`` and w_dhid[NH:] (P, DH) at
    ``o_west``. Every section starts 128 bytes aligned (the kernel's bulk
    copies take whole 16 bytes at 16-byte addresses)."""
    pstride: int
    o_tok: int
    o_h: int
    o_sih: int
    o_shh: int
    o_wdc: int
    o_west: int
    size: int


def panel_layout(d: Dims, C: int, dtype: torch.dtype) -> PanelLayout:
    """Where K1's panels for clusters of C blocks sit; raises unless C is
    a cluster size K1 takes and every width K1 cuts into shares is whole
    quads (TH, NH, DH, E, EH multiples of 4)."""
    if C not in K1_CLUSTERS:
        raise ValueError(f"K1 takes clusters of {K1_CLUSTERS} blocks, got "
                         f"{C}")
    for n in ("TH", "NH", "DH", "E", "EH"):
        if getattr(d, n) % 4:
            raise ValueError(f"K1 panels need {n} % 4 == 0, got "
                             f"{getattr(d, n)}")
    al = 128 // torch.empty(0, dtype=dtype).element_size()
    up = lambda n: -(-n // al) * al
    sh = [k1_share(d, C, c) for c in range(C)]
    s1 = max(d.E * 3 * s.U for s in sh)
    s2 = max(d.NH * (s.Pc + s.Dc + 3 * s.U) for s in sh)
    s3 = max(d.E * 3 * s.SU for s in sh)
    s4 = max(d.EH * 3 * s.SU for s in sh)
    o_h = up(s1)
    o_sih = o_h + up(s2)
    o_shh = o_sih + up(s3)
    pstride = o_shh + up(s4)
    o_wdc = C * pstride
    o_west = o_wdc + up(d.DH * (2 + 3 * d.DH))
    return PanelLayout(pstride, 0, o_h, o_sih, o_shh, o_wdc, o_west,
                       o_west + up(d.P * d.DH))


@functools.lru_cache(maxsize=None)
def panel_index(d: Dims, C: int, dtype: torch.dtype):
    """For each weight of :data:`PANEL_FIELDS`, (its shape, the panel
    buffer's indices, the weight's flat indices) of every element K1's
    panels hold (int64 CPU tensors): the map :func:`pack_panels` writes and
    :func:`unpack_panels` reads. Every element of every field appears once
    (w_pitch's padding columns are left zero)."""
    lay = panel_layout(d, C, dtype)
    NH, DH, E, EH, P = d.NH, d.DH, d.E, d.EH, d.P
    shapes = {"w_ih_tok": (E, 3 * NH), "w_pitch": (NH, P),
              "w_dhid": (NH + P, DH), "w_hh": (NH, 3 * NH),
              "we_ih": (2, E, 3 * EH), "we_hh": (2, EH, 3 * EH),
              "w_dout": (DH, 2), "w_dhh": (DH, 3 * DH)}
    dst = {f: [] for f in PANEL_FIELDS}
    src = {f: [] for f in PANEL_FIELDS}

    def put(field, at, rows, cols, ld, off=0):
        """rows x cols of ``field`` (flat row stride ld, element ``off`` +
        r ld + col) into the buffer at ``at``, k-major, len(cols) a row."""
        r = torch.arange(rows)[:, None]
        col = torch.as_tensor(cols, dtype=torch.long)[None, :]
        n = col.shape[1]
        dst[field].append((at + r * n + torch.arange(n)[None, :]).flatten())
        src[field].append((off + r * ld + col).flatten())

    for c in range(C):
        s = k1_share(d, C, c)
        base = c * lay.pstride
        units = [g * NH + s.j0 + u for g in range(3) for u in range(s.U)]
        put("w_ih_tok", base + lay.o_tok, E, units, 3 * NH)
        n2 = s.Pc + s.Dc + 3 * s.U
        at = base + lay.o_h
        pitch = [p for p in range(s.p0, s.p0 + s.Pc) if p < P]
        r = torch.arange(NH)[:, None]
        dst["w_pitch"].append((at + r * n2 + torch.tensor(
            [p - s.p0 for p in pitch], dtype=torch.long)[None, :]).flatten())
        src["w_pitch"].append((r * P + torch.tensor(
            pitch, dtype=torch.long)[None, :]).flatten())
        dh = torch.arange(s.d0, s.d0 + s.Dc)
        dst["w_dhid"].append((at + r * n2 + s.Pc + torch.arange(s.Dc)[None, :]
                              ).flatten())
        src["w_dhid"].append((r * DH + dh[None, :]).flatten())
        dst["w_hh"].append((at + r * n2 + s.Pc + s.Dc
                            + torch.arange(3 * s.U)[None, :]).flatten())
        src["w_hh"].append((r * 3 * NH + torch.tensor(
            units, dtype=torch.long)[None, :]).flatten())
        sunits = [g * EH + s.e0 + u for g in range(3) for u in range(s.SU)]
        put("we_ih", base + lay.o_sih, E, sunits, 3 * EH, s.d * E * 3 * EH)
        put("we_hh", base + lay.o_shh, EH, sunits, 3 * EH,
            s.d * EH * 3 * EH)
    DC = 2 + 3 * DH
    r = torch.arange(DH)[:, None]
    dst["w_dout"].append((lay.o_wdc + r * DC + torch.arange(2)[None, :]
                          ).flatten())
    src["w_dout"].append((r * 2 + torch.arange(2)[None, :]).flatten())
    dst["w_dhh"].append((lay.o_wdc + r * DC + 2
                         + torch.arange(3 * DH)[None, :]).flatten())
    src["w_dhh"].append((r * 3 * DH + torch.arange(3 * DH)[None, :]
                         ).flatten())
    dst["w_dhid"].append(lay.o_west + torch.arange(P * DH))
    src["w_dhid"].append(NH * DH + torch.arange(P * DH))
    return tuple((f, shapes[f], torch.cat(dst[f]), torch.cat(src[f]))
                 for f in PANEL_FIELDS)


def pack_panels(cw: CoreWeights, d: Dims, C: int) -> torch.Tensor:
    """K1's panel buffer (:class:`PanelLayout`) for clusters of C blocks,
    on the weights' device in their dtype: each block's columns of the
    chain products k-major, the duration weights once. A pure layout
    change: every element is a weight's bits."""
    dt, dev = cw.w_hh.dtype, cw.w_hh.device
    lay = panel_layout(d, C, dt)
    buf = torch.zeros(lay.size, dtype=dt, device=dev)
    for field, shape, dst, src in panel_index_on(d, C, dt, dev):
        w = getattr(cw, field).detach()
        if tuple(w.shape) != shape:
            raise ValueError(f"{field} has shape {tuple(w.shape)}, expected "
                             f"{shape}")
        buf[dst] = w.reshape(-1)[src]
    return buf


@functools.lru_cache(maxsize=None)
def panel_index_on(d: Dims, C: int, dtype: torch.dtype, device):
    """:func:`panel_index` with its indices on ``device``, copied there
    once: a packing inside a captured CUDA graph copies nothing from the
    host."""
    return tuple((f, shape, dst.to(device), src.to(device))
                 for f, shape, dst, src in panel_index(d, C, dtype))


def unpack_panels(buf: torch.Tensor, d: Dims, C: int) -> dict:
    """The weights of :data:`PANEL_FIELDS` read back from a panel buffer
    (the inverse of :func:`pack_panels`); an element no panel holds stays
    NaN."""
    out = {}
    for field, shape, dst, src in panel_index(d, C, buf.dtype):
        w = torch.full(shape, float("nan"), dtype=buf.dtype)
        w.view(-1)[src] = buf.cpu()[dst]
        out[field] = w
    return out


_PANELS: dict = {}


def panels(cw: CoreWeights, d: Dims, C: int) -> torch.Tensor:
    """:func:`pack_panels`, cached: a train step's T frames and its eval
    reuse one packing (the key holds no T) while the weights are the same
    tensors at the same version (an in-place update bumps it, and so does
    the Trainer after a step graph's replay writes the weights; new
    tensors, as a bf16 cast each step makes, miss). Counts its packings in
    ``panels.packs``."""
    srcs = [getattr(cw, f) for f in PANEL_FIELDS]
    key = (C, srcs[0].dtype, srcs[0].device, d)
    versions = tuple(t._version for t in srcs)
    hit = _PANELS.get(key)
    if hit is not None and hit[1] == versions and all(
            r() is t for r, t in zip(hit[0], srcs)):
        return hit[2]
    buf = pack_panels(cw, d, C)
    _PANELS[key] = ([weakref.ref(t) for t in srcs], versions, buf)
    panels.packs += 1
    return buf


panels.packs = 0


def _check(cw: CoreWeights, d: Dims, dev, B: int, named) -> None:
    """Raise unless the weights (one dtype of :data:`DTYPES`) and the
    ``named`` (name, tensor, shape, dtype) inputs are contiguous tensors of
    their shapes and dtypes on the card ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"train-frame kernels take CUDA tensors, got {dev}")
    if B == 0:
        raise ValueError("empty batch")
    dt = storage_dtype(cw)
    if dt not in DTYPES:
        raise TypeError(f"train-frame kernels take float32 or bfloat16 "
                        f"weights, got {dt}")
    for name, t, shape, dtype in (
            [(f"weight {n}", w, None, dt)
             for n, w in zip(cw._fields, cw)] + list(named)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for n in ("TH", "NH", "DH", "E", "EH"):
        if getattr(d, n) % 4:
            raise ValueError(f"train-frame kernels need {n} % 4 == 0, got "
                             f"{getattr(d, n)}")


def frame_fwd(cw: CoreWeights, spec: PianoTreeSpec, frame_h, x_emb, coins,
              gt_pitch, gt_dur, stash: bool, cluster: int = 0,
              rows: int = 0):
    """K1 wrapper (CUDA tensors only): launches ``train_fwd_group_kernel``
    (or the per-row ``train_fwd_kernel``, as the plan picks) in the
    weights' dtype (frame_h and x_emb in it too). Returns (nums (1+W,)
    f32, summary (B, 2EH), lengths (B,) i32, decisions (B, K-1, 1+W) i32
    [pitch | bits], the :class:`Stash` or None). ``cluster`` (8 or 16) forces
    the row groups at that cluster size, ``rows`` (1, 2 or 4) the per-row
    kernel at that many rows a block; neither: the plan's
    (``build.k1_plan``). Counts its launches in ``frame_fwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev, i32 = frame_h.shape[0], frame_h.device, torch.int32
    S, dt = d.K - 1, storage_dtype(cw)
    _check(cw, d, dev, B, [
        ("frame_h", frame_h, (B, d.TH), dt),
        ("x_emb", x_emb, (B, d.K, d.E), dt),
        ("coins", coins, (S,), i32), ("gt_pitch", gt_pitch, (B, S), i32),
        ("gt_dur", gt_dur, (B, S, d.W), i32)])
    nums_rows = _empty(dev, B, 1 + d.W)
    summary = _empty(dev, B, 2 * d.EH, dtype=dt)
    lengths = torch.empty(B, dtype=i32, device=dev)
    decisions = torch.empty((B, S, 1 + d.W), dtype=i32, device=dev)
    st = new_stash(d, B, dev, dt) if stash else None
    build.launch_train_fwd(cw, d, B, [coins, frame_h, x_emb, gt_pitch,
                                      gt_dur, nums_rows, summary, lengths,
                                      decisions], st, cluster=cluster,
                           rows=rows)
    frame_fwd.launches += 1
    # the per-row CE partials meet here, summed over rows in f32
    return nums_rows.sum(0), summary, lengths, decisions, st


frame_fwd.launches = 0


def bwd_buffers(d: Dims, B: int, dev, dtype):
    """K2a's outputs and scratch, allocated for its wrappers: (Cotangents,
    d_frame_h (B, TH) and d_x_emb (B, K, E) of ``dtype``, the f32 injected
    note-chain cotangent dh_inj (K-1, B, NH) that its slot-row kernel hands
    to its chain kernel)."""
    return (new_cotangents(d, B, dev), _empty(dev, B, d.TH, dtype=dtype),
            _empty(dev, B, d.K, d.E, dtype=dtype),
            _empty(dev, d.K - 1, B, d.NH))


def frame_bwd(cw: CoreWeights, spec: PianoTreeSpec, frame_h, coins,
              gt_pitch, gt_dur, lengths, st: Stash, d_nums, d_summ):
    """K2a wrapper (CUDA tensors only; :func:`frame_bwd_plain` is its plain
    version): launches its three kernels (``train_bwd_slots_kernel``,
    ``train_bwd_chain_kernel``, ``train_bwd_proj_kernel``). d_nums is f32,
    d_summ in the weights' dtype. Returns (d_frame_h, d_x_emb, both in that
    dtype, :class:`Cotangents`, f32). Counts its calls in
    ``frame_bwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev, dt = frame_h.shape[0], frame_h.device, storage_dtype(cw)
    _check(cw, d, dev, B, [
        ("d_nums", d_nums, (1 + d.W,), torch.float32),
        ("d_summ", d_summ, (B, 2 * d.EH), dt)])
    ct, d_frame_h, d_x_emb, dh_inj = bwd_buffers(d, B, dev, dt)
    build.launch_train_bwd(cw, d, B, [coins, gt_pitch, gt_dur, lengths,
                                      d_nums, d_summ, d_frame_h, d_x_emb,
                                      dh_inj], st, ct)
    frame_bwd.launches += 1
    return d_frame_h, d_x_emb, ct


frame_bwd.launches = 0


def weight_grads(cw: CoreWeights, spec: PianoTreeSpec, frame_h, st: Stash,
                 ct: Cotangents) -> CoreWeights:
    """K2b wrapper: all 24 weight gradients of a frame through
    :func:`wgrad` (``wgrad_kernel`` and, for the cut tasks,
    ``wgrad_reduce_kernel``), each summed in f32 and written in its
    weight's dtype. Counts its launches in ``weight_grads.launches``."""
    d = dims_of(cw, spec)
    grads = CoreWeights(*(torch.empty_like(w) for w in cw))
    wgrad(wgrad_tasks(d, frame_h.shape[0], frame_h, st, ct, grads))
    weight_grads.launches += 1
    return grads


weight_grads.launches = 0


class FrameRecon(torch.autograd.Function):
    """K1 forward, K2 (K2a + K2b) backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, spec, stash, frame_h, x_emb, coins, gt_pitch, gt_dur,
                *weights):
        cw = CoreWeights(*weights)
        nums, summary, lengths, _, st = frame_fwd(
            cw, spec, frame_h, x_emb, coins, gt_pitch, gt_dur, stash)
        ctx.spec = spec
        ctx.mark_non_differentiable(lengths)
        if stash:
            ctx.save_for_backward(frame_h, coins, gt_pitch, gt_dur, lengths,
                                  *st, *weights)
        return nums, summary, lengths

    @staticmethod
    def backward(ctx, d_nums, d_summ, _d_lengths):
        saved = ctx.saved_tensors
        if not saved:
            raise RuntimeError("FrameRecon ran without its stash; call "
                               "frame_recon with gradients enabled")
        frame_h, coins, gt_pitch, gt_dur, lengths = saved[:5]
        n = len(Stash._fields)
        st = Stash(*saved[5:5 + n])
        cw = CoreWeights(*saved[5 + n:])
        d_frame_h, d_x_emb, ct = frame_bwd(
            cw, ctx.spec, frame_h, coins, gt_pitch, gt_dur, lengths,
            st, d_nums.contiguous(), d_summ.contiguous())
        grads = weight_grads(cw, ctx.spec, frame_h, st, ct)
        return (None, None, d_frame_h, d_x_emb, None, None, None, *grads)


def frame_recon(cw: CoreWeights, spec: PianoTreeSpec, frame_h: torch.Tensor,
                x_emb: torch.Tensor, coins: torch.Tensor,
                gt_pitch: torch.Tensor, gt_dur: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's fused decode + CE numerators: (nums (1+W,), summary
    (B, 2EH)). CUDA tensors go through K1 (and K2 for gradients); CPU
    tensors take :func:`frame_recon_plain` under autograd. Arguments as in
    :func:`frame_recon_plain`."""
    if frame_h.device.type == "cpu":
        out = frame_recon_plain(cw, spec, frame_h, x_emb, coins, gt_pitch,
                                gt_dur)
        return out.nums, out.summary
    i32 = torch.int32
    stash = torch.is_grad_enabled() and any(
        t.requires_grad for t in (frame_h, x_emb, *cw))
    nums, summary, _ = FrameRecon.apply(
        spec, stash, frame_h.contiguous(), x_emb.contiguous(),
        coins.to(i32).contiguous(), gt_pitch.to(i32).contiguous(),
        gt_dur.to(i32).contiguous(), *(w.contiguous() for w in cw))
    return nums, summary


def frame_core_fwd(cw: CoreWeights, spec: PianoTreeSpec, frame_h, x_emb,
                   coins, stash: bool, cluster: int = 0, rows: int = 0):
    """K1 wrapper in logits-out mode (CUDA tensors only): launches K1 (as
    :func:`frame_fwd` does) with no targets. Returns (pitch logits
    (B, K-1, P), dur logits (B, K-1, W, 2), summary (B, 2EH), lengths (B,)
    i32, decisions (B, K-1, 1+W) i32 [pitch | bits], the :class:`Stash` or
    None). ``cluster`` and ``rows`` as in :func:`frame_fwd`. Counts its
    launches in ``frame_core_fwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev, i32 = frame_h.shape[0], frame_h.device, torch.int32
    S, dt = d.K - 1, storage_dtype(cw)
    _check(cw, d, dev, B, [
        ("frame_h", frame_h, (B, d.TH), dt),
        ("x_emb", x_emb, (B, d.K, d.E), dt),
        ("coins", coins, (S,), i32)])
    pitch = _empty(dev, B, S, d.P, dtype=dt)
    dur = _empty(dev, B, S, d.W, 2, dtype=dt)
    summary = _empty(dev, B, 2 * d.EH, dtype=dt)
    lengths = torch.empty(B, dtype=i32, device=dev)
    decisions = torch.empty((B, S, 1 + d.W), dtype=i32, device=dev)
    st = new_stash(d, B, dev, dt) if stash else None
    build.launch_train_fwd(cw, d, B, [coins, frame_h, x_emb, pitch, dur,
                                      summary, lengths, decisions], st,
                           logits=True, cluster=cluster, rows=rows)
    frame_core_fwd.launches += 1
    return pitch, dur, summary, lengths, decisions, st


frame_core_fwd.launches = 0


def frame_core_bwd(cw: CoreWeights, spec: PianoTreeSpec, frame_h, coins,
                   lengths, st: Stash, d_pitch, d_dur, d_summ):
    """K2a wrapper in logits-out mode: launches its three kernels on the
    logit cotangents d_pitch (B, K-1, P) and d_dur (B, K-1, W, 2), in the
    weights' dtype like d_summ. Returns
    (d_frame_h, d_x_emb, :class:`Cotangents`). Counts its calls in
    ``frame_core_bwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev, dt = frame_h.shape[0], frame_h.device, storage_dtype(cw)
    S = d.K - 1
    _check(cw, d, dev, B, [
        ("d_pitch", d_pitch, (B, S, d.P), dt),
        ("d_dur", d_dur, (B, S, d.W, 2), dt),
        ("d_summ", d_summ, (B, 2 * d.EH), dt)])
    ct, d_frame_h, d_x_emb, dh_inj = bwd_buffers(d, B, dev, dt)
    build.launch_train_bwd(cw, d, B, [coins, lengths, d_pitch, d_dur, d_summ,
                                      d_frame_h, d_x_emb, dh_inj], st, ct,
                           logits=True)
    frame_core_bwd.launches += 1
    return d_frame_h, d_x_emb, ct


frame_core_bwd.launches = 0


class FrameCore(torch.autograd.Function):
    """K1 forward and K2 (K2a + K2b) backward in logits-out mode, on CUDA
    tensors."""

    @staticmethod
    def forward(ctx, spec, stash, frame_h, x_emb, coins, *weights):
        cw = CoreWeights(*weights)
        pitch, dur, summary, lengths, _, st = frame_core_fwd(
            cw, spec, frame_h, x_emb, coins, stash)
        ctx.spec = spec
        ctx.mark_non_differentiable(lengths)
        if stash:
            ctx.save_for_backward(frame_h, coins, lengths, *st, *weights)
        return pitch, dur, summary, lengths

    @staticmethod
    def backward(ctx, d_pitch, d_dur, d_summ, _d_lengths):
        saved = ctx.saved_tensors
        if not saved:
            raise RuntimeError("FrameCore ran without its stash; call "
                               "frame_core with gradients enabled")
        frame_h, coins, lengths = saved[:3]
        n = len(Stash._fields)
        st = Stash(*saved[3:3 + n])
        cw = CoreWeights(*saved[3 + n:])
        d_frame_h, d_x_emb, ct = frame_core_bwd(
            cw, ctx.spec, frame_h, coins, lengths, st, d_pitch.contiguous(),
            d_dur.contiguous(), d_summ.contiguous())
        grads = weight_grads(cw, ctx.spec, frame_h, st, ct)
        return (None, None, d_frame_h, d_x_emb, None, *grads)


def frame_core(cw: CoreWeights, spec: PianoTreeSpec, frame_h: torch.Tensor,
               x_emb: torch.Tensor, coins: torch.Tensor) -> CoreOut:
    """One frame's teacher-forced decode with logits out: :class:`CoreOut`.
    CUDA tensors go through K1 (and K2 for gradients); CPU tensors take
    :func:`frame_core_plain` under autograd. Arguments as in
    :func:`frame_recon_plain`."""
    if frame_h.device.type == "cpu":
        return frame_core_plain(cw, spec, frame_h, x_emb, coins)
    stash = torch.is_grad_enabled() and any(
        t.requires_grad for t in (frame_h, x_emb, *cw))
    return CoreOut(*FrameCore.apply(
        spec, stash, frame_h.contiguous(), x_emb.contiguous(),
        coins.to(torch.int32).contiguous(), *(w.contiguous() for w in cw)))

