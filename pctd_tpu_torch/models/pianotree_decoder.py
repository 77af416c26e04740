"""PianoTree decoder (``pctd_tpu/models/pianotree_decoder.py``): the argmax
autoregressive decode (time -> note -> duration) that serves the
latent-control workflows, with the serving weight folds, and the
teacher-forced decode fused with the reconstruction CE that trains it.

- time level: GRU (hid 1024) over [previous-frame summary | z_in],
  init hidden = Linear(z);
- note level: GRU (hid 512) over 15 note slots with argmax pitch feedback;
- duration level: 5-step binary-digit GRU (hid 64) with argmax feedback;
- frame summary: masked bi-GRU over the predicted note embeddings.

:func:`decode` without ground truth is the nested-loop argmax decode in
plain ops (the JAX package's ``fold_heads=True`` XLA path); given the
ground truth it is the teacher-forced decode with logits out: the time GRU
in tensor ops between frames and each frame through the K1/K2 kernel pair
in logits-out mode
(:func:`~pctd_tpu_torch.ops.kernels.train_frame.frame_core`), whose
logits :func:`recon_loss` scores (``fused_loss=False``).
:func:`decode_grid` is the serving entry, which runs each frame through the
K3 kernel (``frame_decoder="frame"``) or the whole decode through the K4
kernel (``"full"``, the default). :func:`decode_recon` is the training
decode with the loss fused in (``fused_loss=True``): the same time level,
each frame through the K1/K2 pair in loss mode
(:func:`~pctd_tpu_torch.ops.kernels.train_frame.frame_recon`), which emits
the CE numerators.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from pctd_tpu_torch.config import ModelConfig, PianoTreeSpec, check_config
from pctd_tpu_torch.ops import bigru_last_masked, gru_cell_pre, \
    gru_gates_pre, gru_init
from pctd_tpu_torch.ops.kernels import ar_decoder, full_decoder, train_frame
from pctd_tpu_torch.ops.losses import all_reduce_sum, cross_entropy_ignore, \
    masked_ce_parts
from pctd_tpu_torch.utils.init import dense_apply, dense_params, free_param

#: column offset of the GRU hidden gates in the combined dur-chain
#: projection [logit (2) | gh (3DH)]. The JAX package pads the logit block
#: to 128 lanes (a TPU tile); the pad columns are zeros and are dropped here.
DUR_GH = 2


class DecoderOutput(NamedTuple):
    pitch_logits: torch.Tensor   # (B, T, K-1, pitch_range)
    dur_logits: torch.Tensor     # (B, T, K-1, dur_width, 2)


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    spec = cfg.pianotree
    return {
        "note_emb": dense_params(gen, spec.note_size, cfg.note_emb_size),
        "z2hid": dense_params(gen, cfg.z_dim, cfg.dec_time_hidden),
        "z2in": dense_params(gen, cfg.z_dim, cfg.dec_z_in),
        "emb_fwd": gru_init(gen, cfg.note_emb_size, cfg.dec_emb_hidden),
        "emb_bwd": gru_init(gen, cfg.note_emb_size, cfg.dec_emb_hidden),
        "time_gru": gru_init(gen, cfg.dec_z_in + 2 * cfg.dec_emb_hidden,
                             cfg.dec_time_hidden),
        "time2notes": dense_params(gen, cfg.dec_time_hidden,
                                   cfg.dec_notes_hidden),
        "notes_gru": gru_init(gen, cfg.dec_time_hidden + cfg.note_emb_size,
                              cfg.dec_notes_hidden),
        "pitch_out": dense_params(gen, cfg.dec_notes_hidden,
                                  spec.pitch_range),
        "dur_gru": gru_init(gen, spec.dur_width, cfg.dec_dur_hidden),
        "dur_hid": dense_params(gen, spec.pitch_range + cfg.dec_notes_hidden,
                                cfg.dec_dur_hidden),
        "dur_out": dense_params(gen, cfg.dec_dur_hidden, 2),
        "init_input": free_param(gen, (2 * cfg.dec_emb_hidden,)),
        "dur_sos": free_param(gen, (spec.dur_width,)),
    }


def grid_lengths(x: torch.Tensor, spec: PianoTreeSpec) -> torch.Tensor:
    """(B, T, K, 6) int grid -> (B, T) int32 valid note counts (K minus the
    pad slots; sos and eos included)."""
    return (spec.max_simu_note
            - (x[..., 0] == spec.pitch_pad).sum(-1)).to(torch.int32)


def grid_to_multihot(x: torch.Tensor, spec: PianoTreeSpec) -> torch.Tensor:
    """(B, T, K, 6) int grid -> (B, T, K, note_size) float32: pitch one-hot
    over pitch_range (the pad index maps to zeros) ++ the raw dur values."""
    pitch_oh = torch.nn.functional.one_hot(
        x[..., 0].long(), spec.pitch_range + 1)[..., :spec.pitch_range]
    return torch.cat([pitch_oh, x[..., 1:]], -1).to(torch.float32)


def emb_x(p: dict, x: torch.Tensor, spec: PianoTreeSpec
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, K, 6) grid -> (embedded (B, T, K, E), lengths (B, T))."""
    mh = grid_to_multihot(x, spec).to(p["note_emb"]["w"].dtype)
    return dense_apply(p["note_emb"], mh), grid_lengths(x, spec)


def sos_token_raw(spec: PianoTreeSpec, device=None) -> torch.Tensor:
    """Raw sos note feature: pitch one-hot at sos, every dur digit 2."""
    sos = torch.zeros(spec.note_size, device=device)
    sos[spec.pitch_sos] = 1.0
    sos[spec.pitch_range:] = 2.0
    return sos


def dur_comb(w_dhh, b_dhh, w_dout, b_dout):
    """Combined dur-chain projection [w_dout (2) | w_dhh (3DH)]: one dot per
    dur step yields that step's logit and the next step's hidden gates."""
    return (torch.cat([w_dout, w_dhh], dim=1),
            torch.cat([b_dout, b_dhh], dim=0))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as an XLA dot on operands of their dtype: f32 sums,
    rounded once to that dtype (in float32, the plain product)."""
    if a.dtype == torch.float32:
        return a @ b
    return (a.float() @ b.float()).to(a.dtype)


def fold_inference_heads(p: dict, cfg: ModelConfig) -> dict:
    """Serial-path weight folds of the argmax decode, as in the JAX package:

    - dur-hidden init ``[h, h @ w_p + b_p] @ w_dhid`` folds to
      ``h @ w_dhid_eff + b_dhid_eff`` (pitch head pre-multiplied);
    - the first combined dur projection folds through it too
      (``w_dx0 = w_dhid_eff @ w_dcomb``);
    - the next slot's notes-GRU token projection of the embedded raw token
      folds to ``raw @ (w_emb @ w_tok)``, split at the pitch/dur boundary so
      the pitch row is a row select and the dur rows accumulate bit by bit.

    Regroupings of the same math; every decode path applies them so the
    paths agree on the argmax decisions. The folds take the params' dtype;
    on bf16 params each product and each sum rounds to bf16, as XLA's ops
    on bf16 params do.
    """
    nh = cfg.dec_notes_hidden
    th = cfg.dec_time_hidden
    P = cfg.pianotree.pitch_range
    w_dhid, b_dhid = p["dur_hid"]["w"], p["dur_hid"]["b"]
    w_p, b_p = p["pitch_out"]["w"], p["pitch_out"]["b"]
    w_tok = p["notes_gru"].w_ih[th:]
    w_dhid_eff = w_dhid[:nh] + _mm(w_p, w_dhid[nh:])
    b_dhid_eff = b_dhid + _mm(b_p, w_dhid[nh:])
    dg = p["dur_gru"]
    w_dcomb, b_dcomb = dur_comb(dg.w_hh, dg.b_hh, p["dur_out"]["w"],
                                p["dur_out"]["b"])
    w_raw_gi = _mm(p["note_emb"]["w"], w_tok)           # (note_size, 3NH)
    return {
        "w_dhid_eff": w_dhid_eff,
        "b_dhid_eff": b_dhid_eff,
        "w_dx0": _mm(w_dhid_eff, w_dcomb),
        "b_dx0": _mm(b_dhid_eff, w_dcomb) + b_dcomb,
        "w_dcomb": w_dcomb,
        "b_dcomb": b_dcomb,
        "w_pitch_gi": w_raw_gi[:P],
        "w_dur_gi": w_raw_gi[P:],
        "w_raw_gi": w_raw_gi,
        "b_raw_gi": _mm(p["note_emb"]["b"], w_tok),
    }


def _decode_dur_folded(p: dict, folds: dict, h_d0, X0, acc0,
                       spec: PianoTreeSpec):
    """Folded duration chain: each step consumes the previous combined
    projection ``X = [logit | gh]`` and emits the next with one dot; the
    token-feedback accumulator picks up ``bit_w * w_dur_gi[w]`` as each bit
    is decided (a bit is ``logit[1] > logit[0]``, ties to 0).

    Returns (dur_logits (B, W, 2), dur_bits (B, W) int32, acc (B, 3NH))."""
    B = h_d0.shape[0]
    dg = p["dur_gru"]
    gi_d = p["dur_sos"].expand(B, -1) @ dg.w_ih + dg.b_ih
    row0 = dg.w_ih[0:1] + dg.b_ih
    row1 = dg.w_ih[1:2] + dg.b_ih
    h_d, X, acc = h_d0, X0, acc0
    logits, bits = [], []
    for w in range(spec.dur_width):
        h_d = gru_gates_pre(gi_d, X[:, DUR_GH:], h_d)
        X = h_d @ folds["w_dcomb"] + folds["b_dcomb"]
        logit = X[:, 0:2]
        bitf = (logit[:, 1:2] > logit[:, 0:1]).to(h_d0.dtype)
        logits.append(logit)
        bits.append(bitf[:, 0].to(torch.int32))
        acc = acc + bitf * folds["w_dur_gi"][w:w + 1]
        gi_d = bitf * row1 + (1.0 - bitf) * row0
    return torch.stack(logits, 1), torch.stack(bits, 1), acc


def _decode_notes_folded(p: dict, spec: PianoTreeSpec, frame_h, sos_emb,
                         folds: dict):
    """Argmax decode of one frame's note slots from the time hidden.

    Returns (pitch_logits (B, K-1, P), dur_logits (B, K-1, W, 2),
    pred_notes (B, K, emb), lengths (B,) int32)."""
    B = frame_h.shape[0]
    K, P = spec.max_simu_note, spec.pitch_range
    th = frame_h.shape[-1]
    ng = p["notes_gru"]
    h = dense_apply(p["time2notes"], frame_h)
    gi_frame = frame_h @ ng.w_ih[:th] + ng.b_ih + folds["b_raw_gi"]
    gi_tok = (sos_token_raw(spec, frame_h.device)
              @ folds["w_raw_gi"]).expand(B, -1)
    lengths = torch.zeros(B, dtype=torch.int32, device=frame_h.device)
    pitch_o, dur_o, raws = [], [], []
    for k in range(1, K):
        h = gru_cell_pre(ng, gi_frame + gi_tok, h)
        est_pitch = dense_apply(p["pitch_out"], h)
        pitch_ind = est_pitch.argmax(-1)
        pitch_oh = torch.nn.functional.one_hot(pitch_ind, P).to(h.dtype)
        gi_pitch = pitch_oh @ folds["w_pitch_gi"]
        h_d0 = h @ folds["w_dhid_eff"] + folds["b_dhid_eff"]
        X0 = h @ folds["w_dx0"] + folds["b_dx0"]
        dur_logits, dur_bits, gi_tok = _decode_dur_folded(
            p, folds, h_d0, X0, gi_pitch, spec)
        raws.append(torch.cat([pitch_oh, dur_bits.to(h.dtype)], -1))
        is_eos = (pitch_ind == spec.pitch_eos) & (lengths == 0)
        lengths = torch.where(is_eos, torch.full_like(lengths, k), lengths)
        pitch_o.append(est_pitch)
        dur_o.append(dur_logits)
    lengths = torch.where(lengths == 0, torch.full_like(lengths, K - 1),
                          lengths)
    pred_embs = dense_apply(p["note_emb"], torch.stack(raws, 1))
    pred_notes = torch.cat([sos_emb[:, None], pred_embs], dim=1)
    return (torch.stack(pitch_o, 1), torch.stack(dur_o, 1), pred_notes,
            lengths)


class DecodeInputs(NamedTuple):
    """The z-derived inputs of the argmax decode."""
    h0: torch.Tensor       # (B, TH) initial time-GRU hidden
    gi_z: torch.Tensor     # (B, 3TH) z_in's share of the time-GRU gi + b_ih
    token0: torch.Tensor   # (B, 2EH) initial summary token
    sos_emb: torch.Tensor  # (B, E) embedded sos token


def decode_inputs(p: dict, cfg: ModelConfig, z: torch.Tensor
                  ) -> DecodeInputs:
    """The z-derived inputs of the argmax decode, in the dtype of ``z`` and
    ``p`` (float32, or bfloat16 for a bf16 decode: each op rounds)."""
    B = z.shape[0]
    z_in = dense_apply(p["z2in"], z)
    sos_emb = dense_apply(p["note_emb"],
                          sos_token_raw(cfg.pianotree, z.device).to(z.dtype))
    token0 = p["init_input"].expand(B, -1).contiguous()
    tg = p["time_gru"]
    tok_dim = token0.shape[-1]
    return DecodeInputs(dense_apply(p["z2hid"], z),
                        z_in @ tg.w_ih[tok_dim:] + tg.b_ih, token0,
                        sos_emb.expand(B, -1).contiguous())


def decode(p: dict, cfg: ModelConfig, z: torch.Tensor,
           x_emb: Optional[torch.Tensor] = None,
           lengths: Optional[torch.Tensor] = None,
           coins1: Optional[torch.Tensor] = None,
           coins2: Optional[torch.Tensor] = None) -> DecoderOutput:
    """The decode of ``z`` (B, z_dim) to logits, as the JAX package's
    ``decode``. Without ``x_emb``: argmax-feedback decode in plain ops (its
    inference mode with ``fold_heads=True``). Teacher-forced: pass x_emb
    (B, T, K, E) and lengths (B, T) from :func:`emb_x`, coins1 (T,) and
    coins2 (T, K) bool (see :func:`decode_recon`); each frame runs
    :func:`~pctd_tpu_torch.ops.kernels.train_frame.frame_core` (its
    ``train_frame_kernel=True`` configuration)."""
    if x_emb is not None:
        return _decode_teacher(p, cfg, z, x_emb, lengths, coins1, coins2)
    spec = cfg.pianotree
    folds = fold_inference_heads(p, cfg)
    h, gi_z, token, sos_emb = decode_inputs(p, cfg, z)
    tg = p["time_gru"]
    w_tok = tg.w_ih[:token.shape[-1]]
    pitch_outs, dur_outs = [], []
    for _ in range(spec.num_step):
        h = gru_cell_pre(tg, gi_z + token @ w_tok, h)
        pitch_o, dur_o, pred_notes, pred_lens = _decode_notes_folded(
            p, spec, h, sos_emb, folds)
        token = bigru_last_masked(p["emb_fwd"], p["emb_bwd"], pred_notes,
                                  pred_lens)
        pitch_outs.append(pitch_o)
        dur_outs.append(dur_o)
    return DecoderOutput(torch.stack(pitch_outs, 1),
                         torch.stack(dur_outs, 1))


def output_to_grid(out: DecoderOutput) -> torch.Tensor:
    """Argmax logits -> estimated grid (B, T, K-1, 6) int32 (ties go to
    the lowest index)."""
    est_pitch = out.pitch_logits.argmax(-1)[..., None]
    est_dur = out.dur_logits.argmax(-1)
    return torch.cat([est_pitch, est_dur], dim=-1).to(torch.int32)


def decode_grid(p: dict, cfg: ModelConfig, z: torch.Tensor,
                frame_decoder: str = "full", fw=None) -> torch.Tensor:
    """Serving decode of ``z`` (B, z_dim) to the estimated grid
    (B, T, K-1, 6) int32.

    ``frame_decoder="full"`` runs the whole decode in the K4 kernel;
    ``"frame"`` runs the time GRU here and each frame in the K3 kernel (the
    JAX package's ``frame_decoder="pallas"``). On CPU tensors both take
    their kernels' plain PyTorch versions. ``fw`` is
    :func:`~pctd_tpu_torch.ops.kernels.ar_decoder.folded_frame_weights` of
    ``p``, computed here when not given (a server folds once).

    ``p`` and ``z`` are in the compute dtype (``disentangle_vae.decode_z``
    casts them). In bfloat16 only ``"frame"`` serves (the JAX package's K4
    has no bf16 mode): the time GRU runs in bf16 ops, each rounding, and
    K3 takes the bf16 time hidden and returns the bf16 summary that is the
    next frame's token. Its products sum in f32 on the card only with
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off, which a bf16 ``Sampler`` sets.
    """
    return decode_grid_chunks(p, cfg, [z], frame_decoder, fw)[0][0]


def decode_grid_chunks(p: dict, cfg: ModelConfig, zs: List[torch.Tensor],
                       frame_decoder: str = "full", fw=None
                       ) -> Tuple[List[torch.Tensor], int]:
    """:func:`decode_grid` of the equal-sized chunks ``zs`` of one
    request, each chunk's inputs computed at its own shape, so that its
    rows decode to the bits of a decode of their own. ``"full"`` decodes
    them in
    :func:`~pctd_tpu_torch.ops.kernels.full_decoder.decode_grid_full_chunks`,
    which decides the chunks that share a K4 launch; ``"frame"`` runs each
    chunk through the K3 frame loop, counted as one launch a chunk.
    Returns (each chunk's grid, the launches made)."""
    check_config(cfg, frame_decoder)
    if fw is None:
        fw = ar_decoder.folded_frame_weights(p, cfg)
    spec = cfg.pianotree
    if frame_decoder == "full":
        return full_decoder.decode_grid_full_chunks(
            fw, spec, [decode_inputs(p, cfg, z) for z in zs])
    grids = []
    for z in zs:
        h, gi_z, token, sos_emb = decode_inputs(p, cfg, z)
        steps = []
        for _ in range(spec.num_step):
            h = gru_gates_pre(gi_z + token @ fw.wt_tok,
                              h @ fw.wt_hh + fw.bt_hh, h)
            pitch_idx, dur_bits, token, _ = ar_decoder.frame_decode(
                fw, spec, h, sos_emb)
            steps.append(torch.cat([pitch_idx[..., None], dur_bits], -1))
        grids.append(torch.stack(steps, 1))
    return grids, len(grids)


#: per-bit weights of the weighted duration loss
DUR_BIT_WEIGHTS = (1.0, 0.6, 0.4, 0.3, 0.3)


def _weigh(pitch_loss, per_bit, dur_num_den, weights, weighted_dur):
    """(loss, pitch_loss, dur_loss) from the pitch loss and the dur terms:
    ``per_bit`` are the per-bit losses (weighted_dur) and ``dur_num_den``
    the pooled (numerator, denominator)."""
    if weighted_dur:
        dur_loss = sum(w * l for w, l in zip(DUR_BIT_WEIGHTS, per_bit))
    else:
        num, den = dur_num_den
        dur_loss = num / den.clamp(min=1)
    return (weights[0] * pitch_loss + weights[1] * dur_loss, pitch_loss,
            dur_loss)


def _teacher_forced(p: dict, cfg: ModelConfig, z: torch.Tensor,
                    x_emb: torch.Tensor, lengths: torch.Tensor,
                    coins1: torch.Tensor, frame: Callable) -> List:
    """The time level of the teacher-forced decode: the time GRU in tensor
    ops, frame t decoded by ``frame(t, h)`` -> (predicted summary, out);
    where coins1[t] the ground-truth frame summary is the next time token,
    else the predicted one. Returns the T outs."""
    spec = cfg.pianotree
    B = z.shape[0]
    T, K = spec.num_step, spec.max_simu_note
    h = dense_apply(p["z2hid"], z)
    z_in = dense_apply(p["z2in"], z)
    x_summary = bigru_last_masked(
        p["emb_fwd"], p["emb_bwd"], x_emb.reshape(B * T, K, -1),
        lengths.reshape(B * T)).reshape(B, T, -1)
    tg = p["time_gru"]
    token = p["init_input"].expand(B, -1)
    tok_dim = token.shape[-1]
    w_tok = tg.w_ih[:tok_dim]
    gi_z = z_in @ tg.w_ih[tok_dim:] + tg.b_ih
    outs = []
    for t in range(T):
        h = gru_cell_pre(tg, gi_z + token @ w_tok, h)
        summary, out = frame(t, h)
        token = torch.where(coins1[t], x_summary[:, t], summary)
        outs.append(out)
    return outs


def _decode_teacher(p: dict, cfg: ModelConfig, z, x_emb, lengths, coins1,
                    coins2) -> DecoderOutput:
    """Teacher-forced decode with logits out (see :func:`decode`)."""
    spec = cfg.pianotree
    cw = train_frame.core_weights(p, cfg)

    def frame(t, h):
        out = train_frame.frame_core(cw, spec, h, x_emb[:, t], coins2[t, 1:])
        return out.summary, (out.pitch_logits, out.dur_logits)

    outs = _teacher_forced(p, cfg, z, x_emb, lengths, coins1, frame)
    return DecoderOutput(torch.stack([o[0] for o in outs], 1),
                         torch.stack([o[1] for o in outs], 1))


def decode_recon(p: dict, cfg: ModelConfig, z: torch.Tensor,
                 x_emb: torch.Tensor, lengths: torch.Tensor,
                 coins1: torch.Tensor, coins2: torch.Tensor,
                 x: torch.Tensor, weights=(1.0, 0.5),
                 weighted_dur: bool = False, group=None):
    """Teacher-forced decode fused with the reconstruction CE. z (B, z_dim);
    x_emb (B, T, K, E) and lengths (B, T) from :func:`emb_x`; coins1 (T,)
    bool selects the ground-truth frame summary as the next time token;
    coins2 (T, K) bool the ground-truth note as the next slot's token; x the
    (B, T, K, 6) grid. Returns (recon, pitch_loss, dur_loss).

    Each frame's :func:`~pctd_tpu_torch.ops.kernels.train_frame.frame_recon`
    returns its CE numerators, summed over frames; the denominators are the
    targets' mask counts. With ``group`` the numerators and the counts are
    summed over its ranks before the division (one all-reduce; see
    :mod:`pctd_tpu_torch.ops.losses`): the loss of the whole batch, whose
    gradient reaches the frame kernels' backward as scaled ``d_nums``."""
    spec = cfg.pianotree
    W = spec.dur_width
    cw = train_frame.core_weights(p, cfg)
    gt_pitch = x[:, :, 1:, 0].to(torch.int32)
    gt_dur = x[:, :, 1:, 1:].to(torch.int32)

    def frame(t, h):
        nums_t, summary = train_frame.frame_recon(
            cw, spec, h, x_emb[:, t], coins2[t, 1:], gt_pitch[:, t],
            gt_dur[:, t])
        return summary, nums_t

    outs = _teacher_forced(p, cfg, z, x_emb, lengths, coins1, frame)
    nums = outs[0]
    for nums_t in outs[1:]:
        nums = nums + nums_t
    den_p = (gt_pitch != spec.pitch_pad).sum()
    den_d = (gt_dur != spec.dur_pad).sum(dim=(0, 1, 2))          # (W,)
    if group is not None:
        summed = all_reduce_sum(torch.cat(
            [nums, den_p[None].to(nums.dtype), den_d.to(nums.dtype)]), group)
        nums, den_p, den_d = summed[:1 + W], summed[1 + W], summed[2 + W:]
    pitch_loss = nums[0] / den_p.clamp(min=1)
    per_bit = [nums[1 + i] / den_d[i].clamp(min=1) for i in range(W)]
    return _weigh(pitch_loss, per_bit, (nums[1:].sum(), den_d.sum()),
                  weights, weighted_dur)


def recon_loss(x: torch.Tensor, out: DecoderOutput, spec: PianoTreeSpec,
               weights=(1.0, 0.5), weighted_dur: bool = False, group=None):
    """Pitch + duration reconstruction loss from logits: CE over grid slots
    1..K-1 with pad targets ignored. Returns (loss, pitch_loss,
    dur_loss). The loss with ``fused_loss=False`` scores the teacher-forced
    :func:`decode`'s logits with it; with ``fused_loss=True``
    :func:`decode_recon` fuses the same CE into the frame kernel. ``group``
    takes each CE over the ranks of a process group
    (:mod:`pctd_tpu_torch.ops.losses`)."""
    gt_pitch = x[:, :, 1:, 0]
    gt_dur = x[:, :, 1:, 1:]
    pitch_loss = cross_entropy_ignore(out.pitch_logits, gt_pitch,
                                      spec.pitch_pad, group)
    if weighted_dur:
        per_bit = [cross_entropy_ignore(out.dur_logits[..., i, :],
                                        gt_dur[..., i], spec.dur_pad, group)
                   for i in range(spec.dur_width)]
        return _weigh(pitch_loss, per_bit, None, weights, True)
    dur = masked_ce_parts(out.dur_logits, gt_dur, spec.dur_pad, group)
    return _weigh(pitch_loss, None, dur, weights, False)
