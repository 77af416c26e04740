"""Host-side symbolic-music tensorizers in numpy: the part of the JAX
package's ``pctd_tpu/data/converter.py`` that the corpus pipeline needs
(the nmat and note conversions, the piano-roll conversions and duration
matrix, the pitch augmentation and the chord expansion), copied because
the port may not import ``pctd_tpu``.

Extended note-matrix ("ext_nmat") row format:
    [start_beat, start_quantum, start_denom, end_beat, end_quantum,
     end_denom, pitch, velocity]
"""
from __future__ import annotations

import numpy as np


def bpm_to_rate(bpm: float) -> float:
    return 60.0 / bpm


def ext_nmat_to_nmat(ext_nmat: np.ndarray) -> np.ndarray:
    """(N, 8) extended nmat -> (N, 4) [start_beat, end_beat, pitch, vel]
    float-beat nmat."""
    nmat = np.zeros((ext_nmat.shape[0], 4))
    nmat[:, 0] = ext_nmat[:, 0] + ext_nmat[:, 1] / ext_nmat[:, 2]
    nmat[:, 1] = ext_nmat[:, 3] + ext_nmat[:, 4] / ext_nmat[:, 5]
    nmat[:, 2] = ext_nmat[:, 6]
    nmat[:, 3] = ext_nmat[:, 7]
    return nmat


def nmat_to_notes(nmat: np.ndarray, start: float, bpm: float):
    """(N, 4) nmat -> list of :class:`~pctd_tpu_torch.data.midi_io.Note`
    records (velocity, pitch, start seconds, end seconds)."""
    from pctd_tpu_torch.data.midi_io import Note

    notes = []
    rate = bpm_to_rate(bpm)
    for s, e, p, v in nmat:
        assert s < e
        assert 0 <= p < 128 and 0 <= v < 128
        notes.append(Note(int(v), int(p), start + s * rate, start + e * rate))
    return notes


def ext_nmat_to_pr(ext_nmat, num_step: int = 32) -> np.ndarray:
    """(N, 8) ext nmat -> (num_step, 128) roll with onset=2 / sustain=1 /
    rest=0."""
    pr = np.zeros((num_step, 128))
    if ext_nmat is not None and len(ext_nmat) > 0:
        arr = np.asarray(ext_nmat)
        s_ind = (arr[:, 0] * arr[:, 2] + arr[:, 1]).astype(int)
        e_ind = (arr[:, 3] * arr[:, 5] + arr[:, 4]).astype(int)
        pitch = arr[:, 6].astype(int)
        for s, e, p in zip(s_ind, e_ind, pitch):
            pr[s, p] = 2
            pr[s + 1:e, p] = 1
    return pr


def ext_nmat_to_mel_pr(ext_nmat, num_step: int = 32) -> np.ndarray:
    """(N, 8) ext nmat -> (num_step, 130) melody roll: col 128 = sustain,
    col 129 = rest."""
    pr = np.zeros((num_step, 130))
    pr[:, 129] = 1
    if ext_nmat is not None and len(ext_nmat) > 0:
        arr = np.asarray(ext_nmat)
        s_ind = (arr[:, 0] * arr[:, 2] + arr[:, 1]).astype(int)
        e_ind = (arr[:, 3] * arr[:, 5] + arr[:, 4]).astype(int)
        pitch = arr[:, 6].astype(int)
        for s, e, p in zip(s_ind, e_ind, pitch):
            pr[s, p] = 1
            pr[s:e, 129] = 0
            pr[s + 1:e, 128] = 1
    return pr


def augment_pr(pr: np.ndarray, shift: int = 0) -> np.ndarray:
    """Circular roll of the pitch axis."""
    return np.roll(pr, shift, axis=-1)


def augment_mel_pr(pr: np.ndarray, shift: int = 0) -> np.ndarray:
    """Roll pitch cols 0..127 only; keep the sustain/rest cols fixed."""
    pitch_part = np.roll(pr[:, 0:128], shift, axis=-1)
    return np.concatenate([pitch_part, pr[:, 128:]], axis=-1)


def pr_to_onehot_pr(pr: np.ndarray) -> np.ndarray:
    """(.., 32, 128) roll -> (.., 32, 128, 3) [onset, sustain, silence]
    planes. Works batched."""
    onset = pr == 2
    sustain = pr == 1
    silence = pr == 0
    return np.stack([onset, sustain, silence], axis=-1).astype(np.int64)


def piano_roll_to_target(pr_onehot: np.ndarray) -> np.ndarray:
    """(.., 32, 128, 3) onset/sustain/silence planes -> duration matrix
    (.., 32, 128) where entry [t, p] = duration (in steps) of a note whose
    onset is at (t, p), else 0, by the recurrence

        c[t] = s[t] + (1 - onset[t+1]) * c[t+1],   c[31] = s[31]
        dur[t] = onset[t] * (c[t] + 1)

    where s = not(onset | silence) is the recomputed sustain plane."""
    pr_onehot = np.asarray(pr_onehot)
    onset = pr_onehot[..., 0].astype(np.int64)
    silence = pr_onehot[..., 2].astype(np.int64)
    s = 1 - np.logical_or(onset, silence).astype(np.int64)
    T = onset.shape[-2]
    c = np.zeros_like(onset)
    c[..., T - 1, :] = s[..., T - 1, :]
    for t in range(T - 2, -1, -1):
        c[..., t, :] = (s[..., t, :]
                        + (1 - onset[..., t + 1, :]) * c[..., t + 1, :])
    return (onset * (c + 1)).astype(float)


def expand_chord(chord: np.ndarray, shift: int, relative: bool = False
                 ) -> np.ndarray:
    """Per-beat 14-d [root, chroma(12), bass] -> 36-d
    [root 1-hot | chroma | bass 1-hot], transposed by ``shift``."""
    root = (chord[0] + shift) % 12
    chroma = np.roll(chord[1:13], shift)
    bass = (chord[13] + shift) % 12
    root_onehot = np.zeros(12)
    root_onehot[int(root)] = 1
    bass_onehot = np.zeros(12)
    bass_onehot[int(bass)] = 1
    return np.concatenate([root_onehot, chroma, bass_onehot])


def batch_expand_chord(chords: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """(N, 8, 14) raw chords + (N,) shifts -> (N, 8, 36)."""
    chords = np.asarray(chords)
    N, S, _ = chords.shape
    shifts = np.asarray(shifts).astype(np.int64)
    root = (chords[..., 0].astype(np.int64) + shifts[:, None]) % 12
    bass = (chords[..., 13].astype(np.int64) + shifts[:, None]) % 12
    # circular roll of chroma by per-sample shift: out[j] = in[(j - shift) % 12]
    j = np.arange(12)
    src = (j[None, None, :] - shifts[:, None, None]) % 12      # (N, 1, 12)
    chroma = np.take_along_axis(chords[..., 1:13],
                                np.broadcast_to(src, (N, S, 12)), axis=-1)
    eye = np.eye(12)
    return np.concatenate([eye[root], chroma, eye[bass]], axis=-1)
