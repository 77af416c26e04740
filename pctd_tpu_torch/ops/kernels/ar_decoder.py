"""K3: argmax decode of ONE frame's note and duration levels, plus the
masked bi-GRU summary of the predicted notes.

Replaces the Pallas kernel ``pctd_tpu/ops/pallas/ar_decoder.py::_frame_kernel``
(launched by ``frame_decode_pallas``). The CUDA source is
``csrc/decoder.cu`` (``frame_kernel``); :func:`frame_decode_plain` is its
plain PyTorch version, which the wrapper takes for CPU tensors.

Both run the serving folds of
:func:`pctd_tpu_torch.models.pianotree_decoder.fold_inference_heads`, packed
by :func:`folded_frame_weights` into combined-column matrices (column slices
of one product are the same contractions as separate products):

- ``w_frame = [w_t2n | w_ih_frame]``: note-level init and the notes-GRU
  frame share from the time hidden;
- ``w_slot = [w_pitch | w_dhid_eff | w_dx0]``: pitch logits, dur-hidden
  init and first combined dur projection from the slot hidden;
- ``w_dcomb = [w_dout | w_dhh]``: each dur step's logit and next gates.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pctd_tpu_torch.config import ModelConfig, PianoTreeSpec
from pctd_tpu_torch.ops.gru import GRUParams, bigru_last_masked, \
    gru_gates_pre


class FoldedWeights(NamedTuple):
    """Packed f32 weights of the folded decode, shared by K3 and K4 (K3
    reads all but the three time-GRU fields). Field order is the order of
    the pointer fields of ``DecoderWeights`` in ``csrc/decoder.cu``."""
    w_frame: torch.Tensor     # (TH, NH + 3NH)
    b_frame: torch.Tensor     # (NH + 3NH,)
    b_raw_gi: torch.Tensor    # (3NH,) token-embedding bias share of gi
    w_hh: torch.Tensor        # (NH, 3NH) notes GRU
    b_hh: torch.Tensor        # (3NH,)
    w_slot: torch.Tensor      # (NH, P + DH + 2 + 3DH)
    b_slot: torch.Tensor
    w_pitch_gi: torch.Tensor  # (P, 3NH)
    w_dur_gi: torch.Tensor    # (W, 3NH)
    gi_tok_sos: torch.Tensor  # (3NH,) sos token's folded gi
    gi_d: torch.Tensor        # (3, 3DH) dur-GRU gi: [sos, bit 0, bit 1]
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


def folded_frame_weights(p: dict, cfg: ModelConfig) -> FoldedWeights:
    """Fold and pack the decoder params ``p`` for the decode kernels."""
    from pctd_tpu_torch.models.pianotree_decoder import (
        fold_inference_heads, sos_token_raw)

    spec = cfg.pianotree
    th = cfg.dec_time_hidden
    folds = fold_inference_heads(p, cfg)
    ng, dg, tg = p["notes_gru"], p["dur_gru"], p["time_gru"]
    tok = 2 * cfg.dec_emb_hidden
    ef, eb = p["emb_fwd"], p["emb_bwd"]
    gi_d_sos = p["dur_sos"][None] @ dg.w_ih + dg.b_ih
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
                     @ folds["w_raw_gi"]),
        gi_d=c(torch.cat([gi_d_sos, dg.w_ih[0:2] + dg.b_ih])),
        w_dcomb=c(folds["w_dcomb"]), b_dcomb=c(folds["b_dcomb"]),
        w_emb=c(p["note_emb"]["w"]), b_emb=c(p["note_emb"]["b"]),
        we_ih=torch.stack([ef.w_ih, eb.w_ih]),
        we_hh=torch.stack([ef.w_hh, eb.w_hh]),
        be_ih=torch.stack([ef.b_ih, eb.b_ih]),
        be_hh=torch.stack([ef.b_hh, eb.b_hh]),
        wt_tok=c(tg.w_ih[:tok]), wt_hh=c(tg.w_hh), bt_hh=c(tg.b_hh),
    )


def frame_projection(fw: FoldedWeights, h_time: torch.Tensor):
    """(hid (B, NH), gi_frame (B, 3NH)) from the time hidden: one product
    with the combined ``w_frame``, then the token-bias share of gi."""
    nh = fw.w_hh.shape[0]
    Yf = h_time @ fw.w_frame + fw.b_frame
    return Yf[:, :nh], Yf[:, nh:] + fw.b_raw_gi


def slot_chain_plain(fw: FoldedWeights, spec: PianoTreeSpec,
                     hid: torch.Tensor, gi_frame: torch.Tensor):
    """The serial 15-slot chain of one frame: notes-GRU step, pitch argmax,
    5-bit dur chain, folded token feedback. Returns (pitch_idx (B, K-1),
    dur_bits (B, K-1, W), lengths (B,)), all int32."""
    B = hid.shape[0]
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    DH = fw.w_dcomb.shape[0]
    h = hid
    gh = h @ fw.w_hh + fw.b_hh
    gi_tok = fw.gi_tok_sos.expand(B, -1)
    lengths = torch.zeros(B, dtype=torch.int32, device=hid.device)
    pitches, all_bits = [], []
    for k in range(1, K):
        h = gru_gates_pre(gi_frame + gi_tok, gh, h)
        Y = h @ fw.w_slot + fw.b_slot
        gh = h @ fw.w_hh + fw.b_hh
        pitch = Y[:, :P].argmax(-1)
        acc = fw.w_pitch_gi[pitch]
        h_d, X = Y[:, P:P + DH], Y[:, P + DH:]
        gi_d = fw.gi_d[0:1]
        bits = []
        for w in range(W):
            h_d = gru_gates_pre(gi_d, X[:, 2:], h_d)
            X = h_d @ fw.w_dcomb + fw.b_dcomb
            bitf = (X[:, 1:2] > X[:, 0:1]).to(h.dtype)
            bits.append(bitf[:, 0])
            acc = acc + bitf * fw.w_dur_gi[w:w + 1]
            gi_d = bitf * fw.gi_d[2:3] + (1.0 - bitf) * fw.gi_d[1:2]
        gi_tok = acc
        pitch = pitch.to(torch.int32)
        is_eos = (pitch == spec.pitch_eos) & (lengths == 0)
        lengths = torch.where(is_eos, torch.full_like(lengths, k), lengths)
        pitches.append(pitch)
        all_bits.append(torch.stack(bits, -1).to(torch.int32))
    lengths = torch.where(lengths == 0, torch.full_like(lengths, K - 1),
                          lengths)
    return torch.stack(pitches, 1), torch.stack(all_bits, 1), lengths


def summary_plain(fw: FoldedWeights, spec: PianoTreeSpec,
                  pitch_idx: torch.Tensor, dur_bits: torch.Tensor,
                  sos_emb: torch.Tensor, lengths: torch.Tensor
                  ) -> torch.Tensor:
    """Masked bi-GRU summary (B, 2EH) over [sos | predicted note
    embeddings] with pack_padded semantics."""
    P = spec.pitch_range
    raw = torch.cat([torch.nn.functional.one_hot(pitch_idx.long(), P),
                     dur_bits], -1).to(fw.w_emb.dtype)
    embs = raw @ fw.w_emb + fw.b_emb                     # (B, K-1, E)
    notes = torch.cat([sos_emb[:, None], embs], 1)
    fwd = GRUParams(fw.we_ih[0], fw.we_hh[0], fw.be_ih[0], fw.be_hh[0])
    bwd = GRUParams(fw.we_ih[1], fw.we_hh[1], fw.be_ih[1], fw.be_hh[1])
    return bigru_last_masked(fwd, bwd, notes, lengths)


def frame_decode_plain(fw: FoldedWeights, spec: PianoTreeSpec,
                       h_time: torch.Tensor, sos_emb: torch.Tensor):
    """Plain PyTorch version of K3. h_time (B, TH), sos_emb (B, E) ->
    (pitch_idx (B, K-1) i32, dur_bits (B, K-1, W) i32, summary (B, 2EH),
    lengths (B,) i32)."""
    hid, gi_frame = frame_projection(fw, h_time)
    pitch_idx, dur_bits, lengths = slot_chain_plain(fw, spec, hid, gi_frame)
    summary = summary_plain(fw, spec, pitch_idx, dur_bits, sos_emb, lengths)
    return pitch_idx, dur_bits, summary, lengths


def frame_decode(fw: FoldedWeights, spec: PianoTreeSpec,
                 h_time: torch.Tensor, sos_emb: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """K3 wrapper: launches ``frame_kernel`` for CUDA tensors; a CPU
    ``h_time`` takes :func:`frame_decode_plain`. Same contract as the plain
    version. Counts its launches in ``frame_decode.launches``."""
    if h_time.device.type == "cpu":
        return frame_decode_plain(fw, spec, h_time, sos_emb)
    from pctd_tpu_torch.ops.kernels import build

    B = h_time.shape[0]
    K, W = spec.max_simu_note, spec.dur_width
    dims = build.decoder_dims(fw, spec)
    build.check_inputs(fw, h_time.device, [
        ("h_time", h_time, (B, dims.TH)), ("sos_emb", sos_emb, (B, dims.E))])
    dev = h_time.device
    pitch_idx = torch.empty((B, K - 1), dtype=torch.int32, device=dev)
    dur_bits = torch.empty((B, K - 1, W), dtype=torch.int32, device=dev)
    summary = torch.empty((B, 2 * dims.EH), dtype=torch.float32, device=dev)
    lengths = torch.empty((B,), dtype=torch.int32, device=dev)
    build.launch("pctd_frame_decode", fw, dims, B,
                 [h_time, sos_emb, pitch_idx, dur_bits, summary, lengths])
    frame_decode.launches += 1
    return pitch_idx, dur_bits, summary, lengths


frame_decode.launches = 0
