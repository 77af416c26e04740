"""K3: argmax decode of ONE frame's note and duration levels, plus the
masked bi-GRU summary of the predicted notes, in float32 or bfloat16.

Replaces the Pallas kernel ``pctd_tpu/ops/pallas/ar_decoder.py::_frame_kernel``
(launched by ``frame_decode_pallas``). The CUDA source is
``csrc/decoder.cu`` (``frame_group_kernel``: a thread-block cluster decodes
a group of 16 rows, each block a share of every product's columns;
``build.decode_plan`` picks the cluster size); :func:`frame_decode_plain`
is its plain PyTorch version, which the wrapper takes for CPU tensors.

Both run the serving folds of
:func:`pctd_tpu_torch.models.pianotree_decoder.fold_inference_heads`, packed
by :func:`folded_frame_weights` into combined-column matrices (column slices
of one product are the same contractions as separate products):

- ``w_frame = [w_t2n | w_ih_frame]``: note-level init and the notes-GRU
  frame share from the time hidden;
- ``w_slot = [w_pitch | w_dhid_eff | w_dx0]``: pitch logits, dur-hidden
  init and first combined dur projection from the slot hidden;
- ``w_dcomb = [w_dout | w_dhh]``: each dur step's logit and next gates.

The bf16 mode is the Pallas kernel's on bf16 params and inputs: the folds
and weights are bf16, the arithmetic f32 (every product there is an f32
``dot``, and an f32 value times a bf16 weight is f32), the two sos
constants f32, the dur-GRU feedback rows rounded to bf16, and the summary
rounded to bf16 at the output. The JAX package's K4 has no bf16 mode, so
the port's K4 takes float32 only.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pctd_tpu_torch.config import ModelConfig, PianoTreeSpec
from pctd_tpu_torch.ops.gru import GRUParams, bigru_last_masked, \
    gru_gates_pre


class FoldedWeights(NamedTuple):
    """Packed weights of the folded decode, shared by K3 and K4 (K3 reads
    all but the three time-GRU fields), in the storage dtype of the params
    they were folded from (float32; bfloat16 for K3's bf16 mode), except
    ``gi_tok_sos`` and ``gi_d``, which are float32 in either (see
    :func:`folded_frame_weights`). Field order is the order of the pointer
    fields of ``DecoderWeightsT`` in ``csrc/decoder.cu``."""
    w_frame: torch.Tensor     # (TH, NH + 3NH)
    b_frame: torch.Tensor     # (NH + 3NH,)
    b_raw_gi: torch.Tensor    # (3NH,) token-embedding bias share of gi
    w_hh: torch.Tensor        # (NH, 3NH) notes GRU
    b_hh: torch.Tensor        # (3NH,)
    w_slot: torch.Tensor      # (NH, P + DH + 2 + 3DH)
    b_slot: torch.Tensor
    w_pitch_gi: torch.Tensor  # (P, 3NH)
    w_dur_gi: torch.Tensor    # (W, 3NH)
    gi_tok_sos: torch.Tensor  # (3NH,) sos token's folded gi, f32
    gi_d: torch.Tensor        # (3, 3DH) dur-GRU gi: [sos, bit 0, bit 1], f32
    w_dcomb: torch.Tensor     # (DH, 2 + 3DH)
    b_dcomb: torch.Tensor
    w_emb: torch.Tensor       # (P + W, E) note embedding
    b_emb: torch.Tensor       # (E,)
    we_ih: torch.Tensor       # (2, E, 3EH) summary bi-GRU [fwd, bwd]
    we_hh: torch.Tensor       # (2, EH, 3EH)
    be_ih: torch.Tensor       # (2, 3EH)
    be_hh: torch.Tensor       # (2, 3EH)
    wt_tok: torch.Tensor      # (2EH, 3TH) time GRU, summary-token share
    wt_hh: torch.Tensor       # (TH, 3TH)
    bt_hh: torch.Tensor       # (3TH,)


#: the fields of :class:`FoldedWeights` that are float32 in either storage
#: dtype: constants the Pallas kernel computes as f32 products
F32_FIELDS = ("gi_tok_sos", "gi_d")


def folded_frame_weights(p: dict, cfg: ModelConfig) -> FoldedWeights:
    """Fold and pack the decoder params ``p`` for the decode kernels, in the
    params' dtype. In bfloat16 the folds round as XLA's ops on bf16 params
    do (:func:`~pctd_tpu_torch.models.pianotree_decoder.fold_inference_heads`),
    and the two constants are what the Pallas kernel computes: the sos
    rows ``dur_sos @ w_dih + b_dih`` and ``sos_raw @ w_raw_gi`` are f32
    products (f32 operands), and the feedback rows ``w_dih[b] + b_dih``
    are bf16 + bf16 sums, rounded to bf16; both are stored in f32."""
    from pctd_tpu_torch.models.pianotree_decoder import (
        fold_inference_heads, sos_token_raw)

    spec = cfg.pianotree
    th = cfg.dec_time_hidden
    folds = fold_inference_heads(p, cfg)
    ng, dg, tg = p["notes_gru"], p["dur_gru"], p["time_gru"]
    tok = 2 * cfg.dec_emb_hidden
    ef, eb = p["emb_fwd"], p["emb_bwd"]
    gi_d_sos = p["dur_sos"][None].float() @ dg.w_ih.float() + dg.b_ih.float()
    c = lambda t: t.contiguous()
    return FoldedWeights(
        w_frame=c(torch.cat([p["time2notes"]["w"], ng.w_ih[:th]], 1)),
        b_frame=c(torch.cat([p["time2notes"]["b"], ng.b_ih])),
        b_raw_gi=c(folds["b_raw_gi"]),
        w_hh=c(ng.w_hh), b_hh=c(ng.b_hh),
        w_slot=c(torch.cat([p["pitch_out"]["w"], folds["w_dhid_eff"],
                            folds["w_dx0"]], 1)),
        b_slot=c(torch.cat([p["pitch_out"]["b"], folds["b_dhid_eff"],
                            folds["b_dx0"]])),
        w_pitch_gi=c(folds["w_pitch_gi"]), w_dur_gi=c(folds["w_dur_gi"]),
        gi_tok_sos=c(sos_token_raw(spec, ng.w_ih.device)
                     @ folds["w_raw_gi"].float()),
        gi_d=c(torch.cat([gi_d_sos, (dg.w_ih[0:2] + dg.b_ih).float()])),
        w_dcomb=c(folds["w_dcomb"]), b_dcomb=c(folds["b_dcomb"]),
        w_emb=c(p["note_emb"]["w"]), b_emb=c(p["note_emb"]["b"]),
        we_ih=torch.stack([ef.w_ih, eb.w_ih]),
        we_hh=torch.stack([ef.w_hh, eb.w_hh]),
        be_ih=torch.stack([ef.b_ih, eb.b_ih]),
        be_hh=torch.stack([ef.b_hh, eb.b_hh]),
        wt_tok=c(tg.w_ih[:tok]), wt_hh=c(tg.w_hh), bt_hh=c(tg.b_hh),
    )


def _f32(fw: FoldedWeights) -> FoldedWeights:
    """f32 views of the folded weights (the same tensors in float32)."""
    return FoldedWeights(*(w.float() for w in fw))


def frame_projection(fw: FoldedWeights, h_time: torch.Tensor):
    """(hid (B, NH), gi_frame (B, 3NH)) in f32 from the time hidden: one
    product with the combined ``w_frame``, then the token-bias share of
    gi."""
    nh = fw.w_hh.shape[0]
    Yf = h_time.float() @ fw.w_frame.float() + fw.b_frame.float()
    return Yf[:, :nh], Yf[:, nh:] + fw.b_raw_gi.float()


def slot_chain_plain(fw: FoldedWeights, spec: PianoTreeSpec,
                     hid: torch.Tensor, gi_frame: torch.Tensor,
                     logits: bool = False):
    """The serial 15-slot chain of one frame in f32 arithmetic: notes-GRU
    step, pitch argmax, 5-bit dur chain, folded token feedback. Returns
    (pitch_idx (B, K-1), dur_bits (B, K-1, W), lengths (B,)), all int32,
    and with ``logits`` also the pitch logits (B, K-1, P) and dur logits
    (B, K-1, W, 2) that decided them."""
    B = hid.shape[0]
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    fw = _f32(fw)
    DH = fw.w_dcomb.shape[0]
    h = hid
    gh = h @ fw.w_hh + fw.b_hh
    gi_tok = fw.gi_tok_sos.expand(B, -1)
    lengths = torch.zeros(B, dtype=torch.int32, device=hid.device)
    pitches, all_bits, pitch_logits, dur_logits = [], [], [], []
    for k in range(1, K):
        h = gru_gates_pre(gi_frame + gi_tok, gh, h)
        Y = h @ fw.w_slot + fw.b_slot
        gh = h @ fw.w_hh + fw.b_hh
        pitch = Y[:, :P].argmax(-1)
        acc = fw.w_pitch_gi[pitch]
        h_d, X = Y[:, P:P + DH], Y[:, P + DH:]
        gi_d = fw.gi_d[0:1]
        bits, dur = [], []
        for w in range(W):
            h_d = gru_gates_pre(gi_d, X[:, 2:], h_d)
            X = h_d @ fw.w_dcomb + fw.b_dcomb
            bitf = (X[:, 1:2] > X[:, 0:1]).to(h.dtype)
            bits.append(bitf[:, 0])
            dur.append(X[:, 0:2])
            acc = acc + bitf * fw.w_dur_gi[w:w + 1]
            gi_d = bitf * fw.gi_d[2:3] + (1.0 - bitf) * fw.gi_d[1:2]
        gi_tok = acc
        pitch = pitch.to(torch.int32)
        is_eos = (pitch == spec.pitch_eos) & (lengths == 0)
        lengths = torch.where(is_eos, torch.full_like(lengths, k), lengths)
        pitches.append(pitch)
        all_bits.append(torch.stack(bits, -1).to(torch.int32))
        if logits:
            pitch_logits.append(Y[:, :P])
            dur_logits.append(torch.stack(dur, 1))
    lengths = torch.where(lengths == 0, torch.full_like(lengths, K - 1),
                          lengths)
    out = (torch.stack(pitches, 1), torch.stack(all_bits, 1), lengths)
    if logits:
        out += (torch.stack(pitch_logits, 1), torch.stack(dur_logits, 1))
    return out


def summary_plain(fw: FoldedWeights, spec: PianoTreeSpec,
                  pitch_idx: torch.Tensor, dur_bits: torch.Tensor,
                  sos_emb: torch.Tensor, lengths: torch.Tensor
                  ) -> torch.Tensor:
    """Masked bi-GRU summary (B, 2EH) in f32 over [sos | predicted note
    embeddings] with pack_padded semantics."""
    P = spec.pitch_range
    raw = torch.cat([torch.nn.functional.one_hot(pitch_idx.long(), P),
                     dur_bits], -1).float()
    embs = raw @ fw.w_emb.float() + fw.b_emb.float()     # (B, K-1, E)
    notes = torch.cat([sos_emb.float()[:, None], embs], 1)
    fwd, bwd = (GRUParams(fw.we_ih[d].float(), fw.we_hh[d].float(),
                          fw.be_ih[d].float(), fw.be_hh[d].float())
                for d in range(2))
    return bigru_last_masked(fwd, bwd, notes, lengths)


def frame_decode_plain(fw: FoldedWeights, spec: PianoTreeSpec,
                       h_time: torch.Tensor, sos_emb: torch.Tensor):
    """Plain PyTorch version of K3. h_time (B, TH), sos_emb (B, E) ->
    (pitch_idx (B, K-1) i32, dur_bits (B, K-1, W) i32, summary (B, 2EH),
    lengths (B,) i32). The arithmetic is f32 in either storage dtype, as in
    the Pallas kernel (its products take ``preferred_element_type=f32``,
    and an f32 value times a bf16 weight is f32); the summary is rounded
    to the inputs' dtype once, at the output."""
    hid, gi_frame = frame_projection(fw, h_time)
    pitch_idx, dur_bits, lengths = slot_chain_plain(fw, spec, hid, gi_frame)
    summary = summary_plain(fw, spec, pitch_idx, dur_bits, sos_emb, lengths)
    return pitch_idx, dur_bits, summary.to(h_time.dtype), lengths


def frame_decode(fw: FoldedWeights, spec: PianoTreeSpec,
                 h_time: torch.Tensor, sos_emb: torch.Tensor,
                 cluster: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """K3 wrapper: launches ``frame_group_kernel`` for CUDA tensors in the
    weights' storage dtype (float32, or the ``pctd_frame_decode_bf16``
    entry point for bfloat16; ``h_time``, ``sos_emb`` and the summary in the
    same dtype); a CPU ``h_time`` takes :func:`frame_decode_plain`. Same
    contract as the plain version. ``cluster`` forces the blocks a cluster
    (0: ``build.decode_plan``'s). Counts its launches in
    ``frame_decode.launches``."""
    if h_time.device.type == "cpu":
        return frame_decode_plain(fw, spec, h_time, sos_emb)
    from pctd_tpu_torch.ops.kernels import build

    B = h_time.shape[0]
    K, W = spec.max_simu_note, spec.dur_width
    dims = build.decoder_dims(fw, spec)
    dtype = build.check_inputs(fw, h_time.device, [
        ("h_time", h_time, (B, dims.TH)), ("sos_emb", sos_emb, (B, dims.E))])
    dev = h_time.device
    pitch_idx = torch.empty((B, K - 1), dtype=torch.int32, device=dev)
    dur_bits = torch.empty((B, K - 1, W), dtype=torch.int32, device=dev)
    summary = torch.empty((B, 2 * dims.EH), dtype=dtype, device=dev)
    lengths = torch.empty((B,), dtype=torch.int32, device=dev)
    build.launch(build.FRAME_ENTRY[dtype], fw, dims, B,
                 [h_time, sos_emb, pitch_idx, dur_bits, summary, lengths],
                 cluster=cluster)
    frame_decode.launches += 1
    return pitch_idx, dur_bits, summary, lengths


frame_decode.launches = 0
