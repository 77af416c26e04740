"""Chord-relative ("detrended") PianoTree features, the input of the
PianoTree texture encoder (``pctd_tpu/data/detrend.py``): each note of the
(N, 32, 16, 6) grid re-expressed relative to its beat's chord as a 39-d
feature

    [is_note(4) | is_bass(3) | octave(12) | scale_degree(8) |
     note_state(7) | dur_bits(5)]

in two implementations on the same tables: :func:`detrend_pianotree` in
torch ops on the device that trains, and :func:`detrend_pianotree_batch` in
numpy. Both are integer-exact against the JAX package: the root is the
first maximum of the root one-hot (an all-zero row gives 0), and the
root-relative chroma is a gather along the pitch-class axis (the JAX
package's device path uses a select over static rolls, a TPU layout
choice).

The reference's quirks are kept as the JAX package keeps them:
``SEMI_TABLE`` is indexed by scale degree, and ``is_bass`` is index 2 on
the first slot of each beat and 0 elsewhere.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

DEG_TABLE = np.array([0, 1, 1, 2, 2, 3, 3, 4, 5, 5, 6, 6], dtype=np.int32)
SEMI_TABLE = np.array([0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1], dtype=np.int32)
# n_state = NSTATE_TABLE[c_state, semitone]
NSTATE_TABLE = np.array([[1, 0], [0, 1], [2, 3], [4, 5]], dtype=np.int32)


def _pair_state(lo, hi):
    """{(1,0): 0, (0,1): 1, (0,0): 2, (1,1): 3} for binary chroma."""
    return 2 - 2 * lo - hi + 4 * lo * hi


def _chroma_states(rolled, stack):
    """rolled: (..., 8, 12) root-relative chroma -> (..., 8, 7) states."""
    return stack([(1 - rolled[..., 0]) * 2,
                  _pair_state(rolled[..., 1], rolled[..., 2]),
                  _pair_state(rolled[..., 3], rolled[..., 4]),
                  _pair_state(rolled[..., 5], rolled[..., 6]),
                  (1 - rolled[..., 7]) * 2,
                  _pair_state(rolled[..., 8], rolled[..., 9]),
                  _pair_state(rolled[..., 10], rolled[..., 11])], -1)


def detrend_pianotree_batch(grids: np.ndarray, chords: np.ndarray
                            ) -> np.ndarray:
    """Numpy detrend: (N, 32, 16, 6) int grid + (N, 8, 36) expanded chord
    -> (N, 32, 16, 39) float32."""
    grids = np.asarray(grids).astype(np.int32)
    chords = np.asarray(chords)
    N = grids.shape[0]
    root = np.argmax(chords[..., 0:12], axis=-1).astype(np.int32)  # (N, 8)
    chroma = chords[..., 12:24].astype(np.int32)
    src = (np.arange(12, dtype=np.int32)[None, None, :]
           + root[..., None]) % 12
    states = _chroma_states(np.take_along_axis(chroma, src, axis=-1),
                            np.stack)                            # (N, 8, 7)

    pitch = grids[..., 0].reshape(N, 8, 4, 16)                   # beat-major
    dur = grids[..., 1:6].reshape(N, 8, 4, 16, 5)
    special = pitch >= 128
    safe_pitch = np.where(special, 0, pitch)
    octave = np.where(special, 11, safe_pitch // 12)
    degree = (safe_pitch - root[:, :, None, None]) % 12
    scale_deg = DEG_TABLE[degree]
    semitone = SEMI_TABLE[scale_deg]
    c_state = np.take_along_axis(states[:, :, None, None, :],
                                 scale_deg[..., None], axis=-1)[..., 0]
    n_state = NSTATE_TABLE.reshape(-1)[c_state * 2 + semitone]
    is_note = np.where(special, pitch - 127, 0)
    scale_deg = np.where(special, 7, scale_deg)
    n_state = np.where(special, 6, n_state)
    first = ((np.arange(4)[:, None] == 0) & (np.arange(16)[None, :] == 0))
    is_bass = np.broadcast_to(np.where(first, 2, 0), pitch.shape)

    eye = lambda i, k: np.eye(k, dtype=np.float32)[i]
    feats = np.concatenate([eye(is_note, 4), eye(is_bass, 3),
                            eye(octave, 12), eye(scale_deg, 8),
                            eye(n_state, 7), dur.astype(np.float32)], -1)
    return feats.reshape(N, 32, 16, 39)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """DEG_TABLE, SEMI_TABLE and NSTATE_TABLE (flat) as int64 tensors on
    ``device``, copied there once: a detrend inside a captured CUDA graph
    copies nothing from the host."""
    return tuple(torch.as_tensor(t, device=device).long().reshape(-1)
                 for t in (DEG_TABLE, SEMI_TABLE, NSTATE_TABLE))


def detrend_pianotree(grids: torch.Tensor, chords: torch.Tensor
                      ) -> torch.Tensor:
    """The device detrend in torch ops: (N, 32, 16, 6) int grid + (N, 8, 36)
    expanded chord on one device -> (N, 32, 16, 39) float32."""
    dev = grids.device
    grids = grids.to(torch.int64)
    N = grids.shape[0]
    root = torch.argmax(chords[..., 0:12], dim=-1)               # (N, 8)
    chroma = chords[..., 12:24].to(torch.int64)
    src = (torch.arange(12, device=dev)[None, None, :]
           + root[..., None]) % 12
    states = _chroma_states(chroma.gather(-1, src), torch.stack)

    pitch = grids[..., 0].reshape(N, 8, 4, 16)
    dur = grids[..., 1:6].reshape(N, 8, 4, 16, 5)
    special = pitch >= 128
    safe_pitch = torch.where(special, 0, pitch)
    octave = torch.where(special, 11, safe_pitch // 12)
    degree = (safe_pitch - root[:, :, None, None]) % 12
    deg_t, semi_t, nstate_t = _tables(dev)
    scale_deg = deg_t[degree]
    semitone = semi_t[scale_deg]
    c_state = states[:, :, None, None, :].expand(
        *scale_deg.shape, 7).gather(-1, scale_deg[..., None])[..., 0]
    n_state = nstate_t[c_state * 2 + semitone]
    is_note = torch.where(special, pitch - 127, 0)
    scale_deg = torch.where(special, 7, scale_deg)
    n_state = torch.where(special, 6, n_state)
    first = ((torch.arange(4, device=dev)[:, None] == 0)
             & (torch.arange(16, device=dev)[None, :] == 0))
    is_bass = torch.where(first, 2, 0).expand(pitch.shape)

    feats = torch.cat([F.one_hot(is_note, 4), F.one_hot(is_bass, 3),
                       F.one_hot(octave, 12), F.one_hot(scale_deg, 8),
                       F.one_hot(n_state, 7), dur], -1).to(torch.float32)
    return feats.reshape(N, 32, 16, 39)
