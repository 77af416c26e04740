"""The yardstick's arithmetic: the card's peaks, the operations and bytes
each kernel's function needs (counted from the shapes, as the Pallas
function it replaces defines the work, whatever implements it), the
least time for that work, and the model FLOPs a served or trained
segment needs.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W): every
float32 product is bounded at the fastest float32-accurate rate of the
card, three TF32 passes (3xTF32) at 495 / 3 = 165 TFLOP/s, whether a
kernel runs on the tensor cores or on the CUDA cores; HBM3 at 3.35 TB/s.
A kernel moved onto the tensor cores then still reads at most 100%.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

from benchmark.reference.model import Widths

PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = PEAK_TF32_FLOPS / 3      # 3xTF32: f32-accurate products
PEAK_BYTES = 3.35e12
F32 = 4                                   # bytes of a float32 or int32


def bound_s(flops: float, nbytes: float) -> float:
    """The least time of the work: operations at the f32 peak or bytes at
    the HBM rate, whichever takes longer."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


# -- serving: K4, the whole T-frame argmax decode -----------------------------

def _slot_cols(w: Widths) -> Tuple[int, int]:
    """Columns of the folded slot product [pitch | dur-hidden init | first
    dur projection] and of the combined dur product [logit | gates]."""
    return w.P + w.dur_h + 2 + 3 * w.dur_h, 2 + 3 * w.dur_h


def folded_elements(w: Widths) -> Tuple[int, int]:
    """Elements of the folded decode weights: (those of one frame, those
    of the time GRU)."""
    NH, TH, DH, E, EH = w.notes_h, w.time_h, w.dur_h, w.note_emb, w.emb_h
    SL, DC = _slot_cols(w)
    frame = (TH * 4 * NH + 4 * NH + 3 * NH + NH * 3 * NH + 3 * NH
             + NH * SL + SL + w.P * 3 * NH + w.W * 3 * NH + 3 * NH
             + 3 * 3 * DH + DH * DC + DC + (w.P + w.W) * E + E
             + 2 * E * 3 * EH + 2 * EH * 3 * EH + 2 * 3 * EH + 2 * 3 * EH)
    time = 2 * EH * 3 * TH + TH * 3 * TH + 3 * TH
    return frame, time


def frame_flops_per_row(w: Widths) -> float:
    """FLOPs of one frame's argmax decode of a row (K3's function): the
    frame projection, the K slot products of the note chain, the slot
    heads and dur chains of K-1 slots, the summary bi-GRU."""
    NH, DH, E, EH = w.notes_h, w.dur_h, w.note_emb, w.emb_h
    SL, DC = _slot_cols(w)
    macs = (w.time_h * 4 * NH + w.K * NH * 3 * NH
            + (w.K - 1) * (NH * SL + w.W * DH * DC)
            + w.K * 2 * (E + EH) * 3 * EH)
    return 2.0 * macs


def k4_work(w: Widths, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K4 launch decoding ``rows`` rows over T
    frames: each weight read once, each row's inputs and grid once."""
    t_flops = 2.0 * (2 * w.emb_h + w.time_h) * 3 * w.time_h
    frame, time = folded_elements(w)
    io = (w.time_h + 3 * w.time_h + 2 * w.emb_h + w.note_emb
          + w.T * (w.K - 1) * (1 + w.W))
    return (w.T * (frame_flops_per_row(w) + t_flops) * rows,
            F32 * (frame + time + io * rows))


# -- training: K1, K2a and K2b, one frame of the teacher-forced decode --------

def core_elements(w: Widths) -> int:
    """Elements of the 24 decoder weights the train-frame kernels read."""
    NH, TH, DH, E, EH, P, W = (w.notes_h, w.time_h, w.dur_h, w.note_emb,
                               w.emb_h, w.P, w.W)
    return (TH * NH + NH + TH * 3 * NH + E * 3 * NH + 3 * NH + NH * 3 * NH
            + 3 * NH + NH * P + P + (NH + P) * DH + DH + W * 3 * DH + 3 * DH
            + DH * 3 * DH + 3 * DH + DH * 2 + 2 + (P + W) * E + E + W
            + 2 * E * 3 * EH + 2 * EH * 3 * EH + 2 * 3 * EH + 2 * 3 * EH)


def _k12_macs(w: Widths) -> Tuple[int, int]:
    NH, DH, E, EH, P, W = w.notes_h, w.dur_h, w.note_emb, w.emb_h, w.P, w.W
    S = w.K - 1
    slot = (E * 3 * NH + NH * 3 * NH + NH * P + (NH + P) * DH
            + W * DH * 3 * DH + W * DH * 2)
    summ = w.K * 2 * (E + EH) * 3 * EH
    frame = w.time_h * 4 * NH
    return frame + S * slot + summ, frame + S * (slot + W * 3 * DH) + summ


def k12_work(w: Widths, rows: int):
    """((FLOPs, bytes) of K1, (FLOPs, bytes) of K2a) for one frame of
    ``rows`` rows, CE fused in: the products, each weight once, each input
    and output once (frame_h, x_emb, the summary and their cotangents, the
    int32 targets and lengths, the CE numerators once a frame) and the
    stash the replaced pair passes, the K note hiddens of a row."""
    k1_macs, k2_macs = _k12_macs(w)
    S, W = w.K - 1, w.W
    weights = F32 * core_elements(w)
    hs = F32 * w.K * w.notes_h
    ins = F32 * (w.time_h + w.K * w.note_emb)
    summary = F32 * 2 * w.emb_h
    per_row = F32 * S * (1 + W)
    nums = F32 * (1 + W)
    k1_io = ins + per_row + summary + 4 + hs
    k2_io = ins + hs + per_row + summary + ins
    return ((2.0 * k1_macs * rows, weights + nums + k1_io * rows),
            (2.0 * k2_macs * rows, weights + nums + k2_io * rows))


class Reduction(NamedTuple):
    """One weight-gradient reduction gW = X^T dY (and gb = 1^T dY) over N
    samples, X of width I, dY of width O."""
    N: int
    I: int
    O: int
    bias: bool


def k2b_reductions(w: Widths, rows: int) -> List[Reduction]:
    """The 16 reductions of one frame's weight gradients."""
    S, W, NH, DH, EH, P, E = (w.K - 1, w.W, w.notes_h, w.dur_h, w.emb_h,
                              w.P, w.note_emb)
    SB, KB = S * rows, w.K * rows
    R = Reduction
    out = [R(rows, w.time_h, NH, True), R(rows, w.time_h, 3 * NH, True),
           R(SB, E, 3 * NH, False), R(SB, NH, 3 * NH, True),
           R(SB, NH, P, True), R(SB, NH, DH, True), R(SB, P, DH, False),
           R(SB * W, W, 3 * DH, True), R(SB * W, DH, 3 * DH, True),
           R(SB * W, DH, 2, True), R(SB, 0, W, True),
           R(SB, P + W, E, True)]
    for _ in range(2):
        out += [R(KB, E, 3 * EH, True), R(KB, EH, 3 * EH, True)]
    return out


def k2b_work(w: Widths, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the weight gradients of one frame: 2 N I O (+ N O
    for a bias) a reduction, each gradient written once."""
    red = k2b_reductions(w, rows)
    flops = sum((2.0 * r.I + (1 if r.bias else 0)) * r.N * r.O for r in red)
    nbytes = sum(F32 * (r.I * r.O + (r.O if r.bias else 0)) for r in red)
    return flops, nbytes


# -- model FLOPs of a segment -------------------------------------------------

def _gru_flops(steps: int, i: int, h: int) -> float:
    return 2.0 * steps * (i + h) * 3 * h


def encoder_flops(w: Widths) -> float:
    """Forward FLOPs of both encoders and their Gaussian heads for one
    segment."""
    S = w.chord_steps
    f = 2 * _gru_flops(S, w.chord_dim, w.chd_enc_h)
    f += 2.0 * 2 * (2 * w.chd_enc_h) * w.chd_z
    if w.txt_encoder == "conv":
        H, Wo = (w.T - 4) // 4 + 1, 128 - 12 + 1
        f += 2.0 * H * Wo * w.conv_ch * 4 * 12
        f += 2.0 * 8 * (w.conv_ch * H * (Wo // 4) // 8) * 1000
        f += 2.0 * 8 * 1000 * w.txt_emb
        f += 2 * _gru_flops(8, w.txt_emb, w.txt_enc_h)
        f += 2.0 * 2 * (2 * w.txt_enc_h) * w.txt_z
    else:
        steps = w.T * w.K
        f += 2.0 * steps * (w.pt_pitch_range + w.W) * w.pt_note_emb
        f += 2 * _gru_flops(steps, w.pt_note_emb, w.pt_notes_h)
        f += 2 * _gru_flops(w.T, 2 * w.pt_notes_h, w.pt_time_h)
        f += 2.0 * 2 * (2 * w.pt_time_h) * w.txt_z
    return f


def _latent_inputs_flops(w: Widths) -> float:
    """z -> the decoder's initial hidden, its z input and that input's
    share of the time GRU's gates."""
    return 2.0 * (w.z * w.time_h + w.z * w.dec_z_in
                  + w.dec_z_in * 3 * w.time_h)


def serve_segment_flops(w: Widths) -> float:
    """Model FLOPs of one served segment: the encoders, the latent inputs
    and the T-frame argmax decode as K4's function counts it."""
    return (encoder_flops(w) + _latent_inputs_flops(w)
            + k4_work(w, 1)[0])


def train_segment_flops(w: Widths) -> float:
    """Model FLOPs of one trained segment: 3x the forward (the backward
    twice the forward, nothing recomputed), where the forward is the
    encoders, the chord decoder, the latent inputs, the ground-truth note
    embeddings and their frame summaries, the time GRU and K1's
    teacher-forced frame, T times."""
    chord_dec = (_gru_flops(w.chord_steps, w.chord_dim + w.chd_dec_z_in,
                            w.chd_dec_h)
                 + 2.0 * w.chord_steps * w.chd_dec_h * 48
                 + 2.0 * w.chd_z * (w.chd_dec_h + w.chd_dec_z_in))
    frames = w.T * (k12_work(w, 1)[0][0]
                    + 2.0 * (2 * w.emb_h + w.time_h) * 3 * w.time_h
                    + 2 * _gru_flops(w.K, w.note_emb, w.emb_h)
                    + 2.0 * w.K * w.note_size * w.note_emb)
    fwd = encoder_flops(w) + chord_dec + _latent_inputs_flops(w) + frames
    return 3.0 * fwd
