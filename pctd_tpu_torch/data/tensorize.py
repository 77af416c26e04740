"""On-device batch tensorization (``pctd_tpu/data/tensorize.py``): raw
uint8 segments -> pitch-shifted duration matrix, PianoTree grid and
expanded chord, batched in tensor ops on the device that trains or
serves. :func:`tensorize_batch` is the one entry point, used by the train
step and the serving front end alike.

Integer outputs equal the JAX package's exactly. The chord-relative
``detrend`` features of the PianoTree texture encoder are in
:mod:`pctd_tpu_torch.data.detrend`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from pctd_tpu_torch.config import PianoTreeSpec
from pctd_tpu_torch.data.detrend import detrend_pianotree


def select_roll(x: torch.Tensor, shift: torch.Tensor, low: int, high: int
                ) -> torch.Tensor:
    """Per-sample circular roll of the last axis by ``shift`` (B,), as a
    select over the static rolls ``low..high`` (the JAX package's
    ``data/detrend.py::select_roll``); shifts outside the range give
    zeros."""
    cond = shift.reshape(shift.shape + (1,) * (x.dim() - shift.dim()))
    acc = torch.zeros_like(x)
    for s in range(low, high + 1):
        rolled = torch.roll(x, s, dims=-1) if s else x
        acc = torch.where(cond == s, rolled, acc)
    return acc


def shift_pr(pr: torch.Tensor, shift: torch.Tensor, low: int = -6,
             high: int = 6) -> torch.Tensor:
    """Per-sample circular pitch roll of (B, T, 128) by shift (B,)."""
    return select_roll(pr, shift.to(torch.int32), low, high)


def pr_to_dur_matrix(pr: torch.Tensor) -> torch.Tensor:
    """(B, 32, 128) onset(2)/sustain(1)/rest(0) roll -> (B, 32, 128) float32
    duration matrix by the reverse recurrence

        c[t] = s[t] + (1 - onset[t+1]) * c[t+1],  s = not(onset | silence)
        dur[t] = onset[t] * (c[t] + 1)
    """
    onset = (pr == 2).to(torch.int32)
    s = 1 - ((pr == 2) | (pr == 0)).to(torch.int32)
    T = pr.shape[1]
    c = torch.zeros_like(s)
    c_next = torch.zeros_like(s[:, 0])
    for t in range(T - 1, -1, -1):
        o_next = onset[:, t + 1] if t + 1 < T else torch.zeros_like(c_next)
        c_next = s[:, t] + (1 - o_next) * c_next
        c[:, t] = c_next
    return (onset * (c + 1)).to(torch.float32)


def dur_matrix_to_grid(pr_mat: torch.Tensor,
                       spec: PianoTreeSpec = PianoTreeSpec()
                       ) -> torch.Tensor:
    """(B, 32, 128) duration matrix -> (B, 32, K, 6) int32 PianoTree grid:
    [sos | up to K-2 notes, lowest pitches first | eos | pad], each slot
    (pitch, 5 duration bits of dur-1, most significant first)."""
    B, T, P = pr_mat.shape
    K = spec.max_simu_note
    n_slots = K - 2
    dev = pr_mat.device
    mask = pr_mat != 0
    slot = torch.cumsum(mask.to(torch.int32), dim=-1) * mask
    counts = mask.sum(dim=-1)
    k_ids = torch.arange(1, n_slots + 1, dtype=slot.dtype, device=dev)
    oh = ((slot[..., None] == k_ids) & mask[..., None]).to(torch.int32)
    pitches = torch.arange(P, dtype=torch.int32, device=dev)
    pitch_vals = (oh * pitches[:, None]).sum(dim=-2)              # (B,T,n)
    dur_m1 = (pr_mat.to(torch.int32) - 1)[..., None]
    dur_vals = (oh * dur_m1).sum(dim=-2)
    has = oh.sum(dim=-2) > 0

    pad = lambda v: torch.full((), v, dtype=torch.int32, device=dev)
    pitch_mid = torch.where(has, pitch_vals - spec.min_pitch,
                            pad(spec.pitch_pad))
    dur_int = dur_vals.clamp(0, 31)
    shifts = torch.arange(4, -1, -1, dtype=torch.int32, device=dev)
    bits = (dur_int[..., None] >> shifts) & 1
    dur_mid = torch.where(has[..., None], bits, pad(spec.dur_pad))

    pitch_col = torch.cat([
        torch.full((B, T, 1), spec.pitch_sos, dtype=torch.int32, device=dev),
        pitch_mid.to(torch.int32),
        torch.full((B, T, 1), spec.pitch_pad, dtype=torch.int32, device=dev),
    ], dim=-1)
    edge = torch.full((B, T, 1, 5), spec.dur_pad, dtype=torch.int32,
                      device=dev)
    dur_col = torch.cat([edge, dur_mid.to(torch.int32), edge], dim=-2)
    eos_slot = torch.clamp(counts + 1, max=K - 1)
    slot_ids = torch.arange(K, device=dev)
    pitch_col = torch.where(slot_ids == eos_slot[..., None],
                            pad(spec.pitch_eos), pitch_col)
    return torch.cat([pitch_col[..., None], dur_col], dim=-1)


def expand_chord_batch(chord_raw: torch.Tensor, shift: torch.Tensor
                       ) -> torch.Tensor:
    """(B, 8, 14) raw [root, chroma (12), bass] + (B,) shift -> (B, 8, 36)
    float32 expanded chord [root one-hot | chroma | bass one-hot]."""
    sh = shift.to(torch.int32)
    root = (chord_raw[..., 0].to(torch.int32) + sh[:, None]) % 12
    bass = (chord_raw[..., 13].to(torch.int32) + sh[:, None]) % 12
    chroma = select_roll(chord_raw[..., 1:13], sh % 12, 0, 11)
    one_hot = lambda i: torch.nn.functional.one_hot(i.long(), 12).float()
    return torch.cat([one_hot(root), chroma.float(), one_hot(bass)], dim=-1)


def tensorize_batch(pr: torch.Tensor, chord_raw: torch.Tensor,
                    shift: torch.Tensor, spec: PianoTreeSpec = PianoTreeSpec(),
                    with_detrend: bool = True) -> Dict[str, torch.Tensor]:
    """Tensorization of a batch on the inputs' device.

    Inputs (un-augmented, as the corpus stores them):
        pr        (B, 32, 128) uint8 onset/sustain/rest roll
        chord_raw (B, 8, 14)   raw chord rows
        shift     (B,)         per-sample transposition in semitones

    Returns a dict with pr_mat (B, 32, 128) f32, x (B, 32, K, 6) int32
    grid, c (B, 8, 36) f32 and, as asked, dt_x (B, 32, 16, 39) f32 (the
    detrended grid)."""
    pr_mat = pr_to_dur_matrix(shift_pr(pr.to(torch.int32), shift))
    x = dur_matrix_to_grid(pr_mat, spec)
    c = expand_chord_batch(chord_raw, shift)
    out = {"pr_mat": pr_mat, "x": x, "c": c}
    if with_detrend:
        out["dt_x"] = detrend_pianotree(x, c)
    return out


def window_features(pr, chord, spec: PianoTreeSpec, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw serving windows (pr (N, 32, 128) uint8, chord (N, 8, 14), numpy
    or tensors) -> (pr_mat, c) on ``device``, untransposed: the encoder
    inputs of the serving CLIs."""
    f = tensorize_batch(torch.as_tensor(pr, device=device),
                        torch.as_tensor(chord, device=device),
                        torch.zeros(len(pr), dtype=torch.int32,
                                    device=device),
                        spec=spec, with_detrend=False)
    return f["pr_mat"], f["c"]
