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

- ``train_fwd_kernel`` (K1): per batch row, the 15 note-GRU slots with the
  pitch head and argmax, the 5-step duration GRU with argmax feedback, the
  predicted-note embedding and the teacher-coin token select, the masked
  bi-GRU summary of the predicted notes, and the masked-CE numerators
  (loss mode) or the logits (logits out). On the gradient path it also
  writes every activation the backward needs (the stash, :class:`Stash`),
  so K2 recomputes nothing and replays no argmax.
- ``train_bwd_kernel`` (K2a): per batch row, the reverse chain: summary
  bi-GRU backward, each slot's logit cotangents (computed from the targets
  in loss mode, given in logits-out mode) and duration-chain + head
  backward, the note-GRU reverse recurrence, the embedding and token
  routes. It writes the per-sample gate cotangents (:class:`Cotangents`),
  ``d_frame_h`` and ``d_x_emb``.
- ``wgrad_kernel`` (K2b): the 24 weight gradients as ``X^T . dY``
  reductions of stash against cotangents over rows, slots and duration
  steps, tiled in shared memory and summed in a fixed order (no atomics).
  The same in both modes.

:func:`frame_recon_plain` (loss mode) and :func:`frame_core_plain` (logits
out) are the plain PyTorch versions of K1 in the kernel's grouping;
autograd of them is K2's plain version. The argmax decisions and the
teacher coins carry no gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pctd_tpu_torch.config import ModelConfig, PianoTreeSpec
from pctd_tpu_torch.ops.gru import GRUParams, bigru_last_masked, \
    gru_gates_pre
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


def _frame_plain(cw: CoreWeights, spec: PianoTreeSpec,
                 frame_h: torch.Tensor, x_emb: torch.Tensor,
                 coins: torch.Tensor):
    """One frame's teacher-forced decode in K1's grouping (``_run_forward``
    and ``_summary_fwd`` of the JAX kernel). Returns (pitch logits
    (B, K-1, P), dur logits (B, K-1, W, 2), summary, lengths, hs, pitch
    argmaxes (B, K-1), dur bits (B, K-1, W))."""
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    B = frame_h.shape[0]
    gi_d_sos = cw.dur_sos @ cw.w_dih + cw.b_dih
    row0 = cw.w_dih[0] + cw.b_dih
    row1 = cw.w_dih[1] + cw.b_dih
    h = frame_h @ cw.w_t2n + cw.b_t2n
    gi_frame = frame_h @ cw.w_ih_frame + cw.b_ih
    gh = h @ cw.w_hh + cw.b_hh
    token = x_emb[:, 0]
    hs, pred, ests, dur_logits, pitches, all_bits = [h], [token], [], [], \
        [], []
    lengths = torch.zeros(B, dtype=torch.int32, device=frame_h.device)
    for k in range(1, K):
        h = gru_gates_pre(gi_frame + token @ cw.w_ih_tok, gh, h)
        hs.append(h)
        gh = h @ cw.w_hh + cw.b_hh
        est = h @ cw.w_pitch + cw.b_pitch
        pitch = est.argmax(-1)
        h_d = torch.cat([h, est], -1) @ cw.w_dhid + cw.b_dhid
        gh_d = h_d @ cw.w_dhh + cw.b_dhh
        gi_d = gi_d_sos.expand(B, -1)
        logits, bits = [], []
        for _ in range(W):
            h_d = gru_gates_pre(gi_d, gh_d, h_d)
            logit = h_d @ cw.w_dout + cw.b_dout
            gh_d = h_d @ cw.w_dhh + cw.b_dhh
            bitf = (logit[:, 1:2] > logit[:, 0:1]).to(h.dtype)
            gi_d = bitf * row1 + (1.0 - bitf) * row0
            logits.append(logit)
            bits.append(bitf[:, 0])
        bits = torch.stack(bits, -1)
        raw = torch.cat([torch.nn.functional.one_hot(pitch, P).to(h.dtype),
                         bits], -1)
        emb = raw @ cw.w_emb + cw.b_emb
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
    fwd = GRUParams(cw.we_ih[0], cw.we_hh[0], cw.be_ih[0], cw.be_hh[0])
    bwd = GRUParams(cw.we_ih[1], cw.we_hh[1], cw.be_ih[1], cw.be_hh[1])
    summary = bigru_last_masked(fwd, bwd, torch.stack(pred, 1), lengths)
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
    """
    est_all, dur_all, summary, lengths, hs, pitch, bits = _frame_plain(
        cw, spec, frame_h, x_emb, coins)
    nums = [masked_ce_parts(est_all, gt_pitch, spec.pitch_pad)[0]]
    nums += [masked_ce_parts(dur_all[:, :, w], gt_dur[..., w],
                             spec.dur_pad)[0] for w in range(spec.dur_width)]
    return FrameOut(torch.stack(nums), summary, lengths, hs, pitch, bits)


def frame_core_plain(cw: CoreWeights, spec: PianoTreeSpec,
                     frame_h: torch.Tensor, x_emb: torch.Tensor,
                     coins: torch.Tensor) -> CoreOut:
    """Plain PyTorch version of K1 in logits-out mode (the JAX package's
    ``frame_core``): one frame's teacher-forced decode, returning the pitch
    and duration logits, the predicted-frame summary and the lengths.
    Arguments as in :func:`frame_recon_plain`."""
    return CoreOut(*_frame_plain(cw, spec, frame_h, x_emb, coins)[:4])


class Stash(NamedTuple):
    """Activations K1 writes on the gradient path and K2 reads (one frame;
    S = K-1 slots). Field order is ``TrainStash`` in ``csrc/train_frame.cu``.
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


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def new_stash(d: Dims, B: int, dev) -> Stash:
    S = d.K - 1
    return Stash(
        _empty(dev, d.K, B, d.NH), _empty(dev, S, B, 4 * d.NH),
        _empty(dev, S, B, d.E), _empty(dev, S, B, d.P),
        _empty(dev, S, B, d.W + 1, d.DH), _empty(dev, S, B, d.W, 4 * d.DH),
        _empty(dev, S, B, d.W, 2), _empty(dev, S, B, d.W, d.W),
        _empty(dev, S, B, d.P + d.W), _empty(dev, d.K, B, d.E),
        _empty(dev, 2, d.K, B, d.EH), _empty(dev, 2, d.K, B, 4 * d.EH))


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


def wgrad_plain(tasks) -> None:
    """Plain PyTorch version of K2b: each task's ``X^T dY`` and column sum
    as torch products, written into the same outputs."""
    for tk in tasks:
        dy = _rows(tk.DY, tk.N, tk.O, tk.n_in, tk.y_o, tk.y_i)
        if tk.I:
            x = _rows(tk.X, tk.N, tk.I, tk.n_in, tk.x_o, tk.x_i)
            tk.gW.copy_(x.t() @ dy)
        if tk.gb.numel():
            tk.gb.copy_(dy.sum(0))


def _check(cw: CoreWeights, d: Dims, dev, B: int, named) -> None:
    if dev.type != "cuda":
        raise ValueError(f"train-frame kernels take CUDA tensors, got {dev}")
    if B == 0:
        raise ValueError("empty batch")
    for name, t, shape, dtype in (
            [(f"weight {n}", w, None, torch.float32)
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
              gt_pitch, gt_dur, stash: bool):
    """K1 wrapper (CUDA tensors only): launches ``train_fwd_kernel``.
    Returns (nums (1+W,), summary (B, 2EH), lengths (B,) i32, decisions
    (B, K-1, 1+W) i32 [pitch | bits], the :class:`Stash` or None). Counts
    its launches in ``frame_fwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev, i32 = frame_h.shape[0], frame_h.device, torch.int32
    S = d.K - 1
    _check(cw, d, dev, B, [
        ("frame_h", frame_h, (B, d.TH), torch.float32),
        ("x_emb", x_emb, (B, d.K, d.E), torch.float32),
        ("coins", coins, (S,), i32), ("gt_pitch", gt_pitch, (B, S), i32),
        ("gt_dur", gt_dur, (B, S, d.W), i32)])
    nums_rows = _empty(dev, B, 1 + d.W)
    summary = _empty(dev, B, 2 * d.EH)
    lengths = torch.empty(B, dtype=i32, device=dev)
    decisions = torch.empty((B, S, 1 + d.W), dtype=i32, device=dev)
    st = new_stash(d, B, dev) if stash else None
    build.launch_train_fwd(cw, d, B, [coins, frame_h, x_emb, gt_pitch,
                                      gt_dur, nums_rows, summary, lengths,
                                      decisions], st)
    frame_fwd.launches += 1
    # the per-row CE partials meet here, summed over rows in f32
    return nums_rows.sum(0), summary, lengths, decisions, st


frame_fwd.launches = 0


def frame_bwd(cw: CoreWeights, spec: PianoTreeSpec, frame_h, coins,
              gt_pitch, gt_dur, lengths, st: Stash, d_nums, d_summ):
    """K2a wrapper: launches ``train_bwd_kernel``. Returns (d_frame_h,
    d_x_emb, :class:`Cotangents`). Counts launches in
    ``frame_bwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev = frame_h.shape[0], frame_h.device
    _check(cw, d, dev, B, [
        ("d_nums", d_nums, (1 + d.W,), torch.float32),
        ("d_summ", d_summ, (B, 2 * d.EH), torch.float32)])
    ct = new_cotangents(d, B, dev)
    d_frame_h = _empty(dev, B, d.TH)
    d_x_emb = _empty(dev, B, d.K, d.E)
    build.launch_train_bwd(cw, d, B, [coins, gt_pitch, gt_dur, lengths,
                                      d_nums, d_summ, d_frame_h, d_x_emb],
                           st, ct)
    frame_bwd.launches += 1
    return d_frame_h, d_x_emb, ct


frame_bwd.launches = 0


def weight_grads(cw: CoreWeights, spec: PianoTreeSpec, frame_h, st: Stash,
                 ct: Cotangents) -> CoreWeights:
    """K2b wrapper: launches ``wgrad_kernel`` once for all 24 weight
    gradients of a frame. Counts launches in ``weight_grads.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    grads = CoreWeights(*(torch.empty_like(w) for w in cw))
    build.launch_wgrad(wgrad_tasks(d, frame_h.shape[0], frame_h, st, ct,
                                   grads))
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
                   coins, stash: bool):
    """K1 wrapper in logits-out mode (CUDA tensors only): launches
    ``train_fwd_kernel`` with no targets. Returns (pitch logits (B, K-1, P),
    dur logits (B, K-1, W, 2), summary (B, 2EH), lengths (B,) i32, decisions
    (B, K-1, 1+W) i32 [pitch | bits], the :class:`Stash` or None). Counts its
    launches in ``frame_core_fwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev, i32 = frame_h.shape[0], frame_h.device, torch.int32
    S = d.K - 1
    _check(cw, d, dev, B, [
        ("frame_h", frame_h, (B, d.TH), torch.float32),
        ("x_emb", x_emb, (B, d.K, d.E), torch.float32),
        ("coins", coins, (S,), i32)])
    pitch = _empty(dev, B, S, d.P)
    dur = _empty(dev, B, S, d.W, 2)
    summary = _empty(dev, B, 2 * d.EH)
    lengths = torch.empty(B, dtype=i32, device=dev)
    decisions = torch.empty((B, S, 1 + d.W), dtype=i32, device=dev)
    st = new_stash(d, B, dev) if stash else None
    build.launch_train_fwd(cw, d, B, [coins, frame_h, x_emb, pitch, dur,
                                      summary, lengths, decisions], st,
                           logits=True)
    frame_core_fwd.launches += 1
    return pitch, dur, summary, lengths, decisions, st


frame_core_fwd.launches = 0


def frame_core_bwd(cw: CoreWeights, spec: PianoTreeSpec, frame_h, coins,
                   lengths, st: Stash, d_pitch, d_dur, d_summ):
    """K2a wrapper in logits-out mode: launches ``train_bwd_kernel`` on the
    logit cotangents d_pitch (B, K-1, P) and d_dur (B, K-1, W, 2). Returns
    (d_frame_h, d_x_emb, :class:`Cotangents`). Counts launches in
    ``frame_core_bwd.launches``."""
    from pctd_tpu_torch.ops.kernels import build

    d = dims_of(cw, spec)
    B, dev = frame_h.shape[0], frame_h.device
    S = d.K - 1
    _check(cw, d, dev, B, [
        ("d_pitch", d_pitch, (B, S, d.P), torch.float32),
        ("d_dur", d_dur, (B, S, d.W, 2), torch.float32),
        ("d_summ", d_summ, (B, 2 * d.EH), torch.float32)])
    ct = new_cotangents(d, B, dev)
    d_frame_h = _empty(dev, B, d.TH)
    d_x_emb = _empty(dev, B, d.K, d.E)
    build.launch_train_bwd(cw, d, B, [coins, lengths, d_pitch, d_dur, d_summ,
                                      d_frame_h, d_x_emb], st, ct,
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
