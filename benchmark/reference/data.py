"""Plain PyTorch reference of the data path: raw 2-bar segments (uint8
onset 2 / sustain 1 / rest 0 rolls, raw [root, chroma, bass] chord rows)
and a transposition -> duration matrix, PianoTree grid, expanded chord,
and the chord-relative ("detrended") grid the PianoTree texture encoder
reads. Written from the published preprocessing; it imports nothing of
the program under test."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.model import Widths

Tensor = torch.Tensor


def transpose_roll(x: Tensor, shift: Tensor) -> Tensor:
    """Roll each row's last axis by its shift (B,), circularly:
    ``out[..., i] = x[..., (i - shift) mod n]``."""
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device)[None, :]
           - shift.long()[:, None]) % n                       # (B, n)
    idx = idx.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (n,))
    return x.gather(-1, idx.expand(x.shape))


def duration_matrix(pr: Tensor) -> Tensor:
    """(B, T, 128) roll -> (B, T, 128) float durations: at an onset, 1 +
    the count c[t] given by c[t] = sustain[t] + (1 - onset[t+1]) c[t+1]."""
    onset = (pr == 2).long()
    sustain = (pr == 1).long()
    T = pr.shape[1]
    c = torch.zeros_like(onset)
    nxt = torch.zeros_like(onset[:, 0])
    for t in range(T - 1, -1, -1):
        o_next = onset[:, t + 1] if t + 1 < T else torch.zeros_like(nxt)
        nxt = sustain[:, t] + (1 - o_next) * nxt
        c[:, t] = nxt
    return (onset * (c + 1)).to(torch.float32)


def grid(pr_mat: Tensor, w: Widths) -> Tensor:
    """Duration matrix -> (B, T, K, 1 + W) int64 PianoTree grid: slot 0
    sos, then up to K-2 notes from the lowest pitch up, (pitch, W bits of
    duration - 1, most significant first), then eos, then pad; sos, eos
    and pad carry the duration pad value in every bit."""
    B, T, n_p = pr_mat.shape
    dev = pr_mat.device
    out = torch.empty((B, T, w.K, 1 + w.W), dtype=torch.int64, device=dev)
    out[..., 0] = w.pitch_pad
    out[..., 1:] = w.dur_pad
    out[:, :, 0, 0] = w.pitch_sos
    on = pr_mat != 0
    rank = torch.cumsum(on.long(), -1)                     # 1-based slot
    count = on.sum(-1)                                     # (B, T)
    keep = on & (rank <= w.K - 2)
    b, t, p = keep.nonzero(as_tuple=True)
    slot = rank[b, t, p]
    out[b, t, slot, 0] = p - w.min_pitch
    dur = (pr_mat[b, t, p].long() - 1).clamp(0, 2 ** w.W - 1)
    for i in range(w.W):
        out[b, t, slot, 1 + i] = (dur >> (w.W - 1 - i)) & 1
    eos = (count + 1).clamp(max=w.K - 1)
    out.scatter_(2, eos[..., None, None].expand(B, T, 1, 1),
                 torch.full((B, T, 1, 1), w.pitch_eos, device=dev))
    eos_dur = torch.full((B, T, 1, w.W), w.dur_pad, device=dev)
    out[..., 1:].scatter_(2, eos[..., None, None].expand(B, T, 1, w.W),
                          eos_dur)
    return out


def expand_chord(chord: Tensor, shift: Tensor) -> Tensor:
    """(B, 8, 14) raw chord rows + shift -> (B, 8, 36): root one-hot,
    chroma, bass one-hot, all transposed."""
    sh = shift.long()[:, None]
    root = (chord[..., 0].long() + sh) % 12
    bass = (chord[..., 13].long() + sh) % 12
    chroma = transpose_roll(chord[..., 1:13].float(), shift % 12)
    return torch.cat([F.one_hot(root, 12).float(), chroma,
                      F.one_hot(bass, 12).float()], -1)


# scale degree of each semitone above the root, whether that degree is a
# raised one, and the note state of (chroma state, raised)
_DEGREE = (0, 1, 1, 2, 2, 3, 3, 4, 5, 5, 6, 6)
_RAISED = (0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1)
_NOTE_STATE = ((1, 0), (0, 1), (2, 3), (4, 5))


def _pair(lo: Tensor, hi: Tensor) -> Tensor:
    """Chroma state of a pair of semitones: (1,0) 0, (0,1) 1, (0,0) 2,
    (1,1) 3."""
    return 2 - 2 * lo - hi + 4 * lo * hi


def detrend(x: Tensor, c: Tensor) -> Tensor:
    """Grid (B, 32, K, 6) + expanded chord (B, 8, 36) -> (B, 32, K, 39):
    each note relative to its beat's chord, [is_note (4) | is_bass (3) |
    octave (12) | scale degree (8) | note state (7) | duration bits (5)].
    The published quirks are kept: the raised-degree table is indexed by
    the scale degree, and is_bass is 2 on a beat's first slot of its first
    step and 0 elsewhere."""
    dev = x.device
    B = x.shape[0]
    root = c[..., 0:12].argmax(-1)                                # (B, 8)
    chroma = c[..., 12:24].long()
    rel = chroma.gather(-1, (torch.arange(12, device=dev)[None, None]
                             + root[..., None]) % 12)           # (B, 8, 12)
    states = torch.stack(
        [(1 - rel[..., 0]) * 2, _pair(rel[..., 1], rel[..., 2]),
         _pair(rel[..., 3], rel[..., 4]), _pair(rel[..., 5], rel[..., 6]),
         (1 - rel[..., 7]) * 2, _pair(rel[..., 8], rel[..., 9]),
         _pair(rel[..., 10], rel[..., 11])], -1)                # (B, 8, 7)
    K = x.shape[2]
    pitch = x[..., 0].long().reshape(B, 8, 4, K)
    dur = x[..., 1:].reshape(B, 8, 4, K, -1).float()
    special = pitch >= 128
    pc = torch.where(special, 0, pitch)
    degree = torch.tensor(_DEGREE, device=dev)[
        (pc - root[:, :, None, None]) % 12]
    raised = torch.tensor(_RAISED, device=dev)[degree]
    c_state = states[:, :, None, None, :].expand(*degree.shape, 7).gather(
        -1, degree[..., None])[..., 0]
    n_state = torch.tensor(_NOTE_STATE, device=dev)[c_state, raised]
    first = ((torch.arange(4, device=dev)[:, None] == 0)
             & (torch.arange(K, device=dev)[None, :] == 0))
    feats = [
        F.one_hot(torch.where(special, pitch - 127, 0), 4),
        F.one_hot(torch.where(first, 2, 0).expand(pitch.shape), 3),
        F.one_hot(torch.where(special, 11, pc // 12), 12),
        F.one_hot(torch.where(special, 7, degree), 8),
        F.one_hot(torch.where(special, 6, n_state), 7),
    ]
    out = torch.cat([f.float() for f in feats] + [dur], -1)
    return out.reshape(B, 32, K, 39)


def features(pr: Tensor, chord: Tensor, shift: Tensor, w: Widths
             ) -> Dict[str, Tensor]:
    """A raw batch (pr (B, 32, 128) uint8, chord (B, 8, 14), shift (B,)) ->
    {pr_mat, x, c} and, for the PianoTree encoder, dt_x."""
    pr_mat = duration_matrix(transpose_roll(pr.long(), shift))
    x = grid(pr_mat, w)
    c = expand_chord(chord, shift)
    out = {"pr_mat": pr_mat, "x": x, "c": c}
    if w.txt_encoder == "pianotree":
        out["dt_x"] = detrend(x, c)
    return out
