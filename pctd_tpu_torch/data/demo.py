"""Demo assembly (a copy of ``pctd_tpu/data/demo.py``): decoded grids ->
piano rolls / notes -> multi-track MIDI, laid out 2-bar segment after
segment on one timeline, through the port's own MIDI writer.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from pctd_tpu_torch.config import PianoTreeSpec
from pctd_tpu_torch.data.midi_io import MidiFile, MidiTrack, Note


def grid_to_pr_and_notes(grid: np.ndarray, bpm: float = 60.0,
                         start: float = 0.0,
                         spec: PianoTreeSpec = PianoTreeSpec(),
                         max_notes: Optional[int] = None
                         ) -> Tuple[np.ndarray, List[Note]]:
    """Decoded (32, K or K-1, 6) grid -> ((32, 128) duration roll, Note list)
    (reference ptvae.py:558-575).

    ``max_notes`` limits how many note slots are read per step; the reference
    hardcodes 10 of 15 (ptvae.py:565) — default here reads all slots.
    """
    grid = np.asarray(grid)
    if grid.shape[1] == spec.max_simu_note:      # drop sos slot
        grid = grid[:, 1:]
    n_read = max_notes if max_notes is not None else grid.shape[1]
    T = grid.shape[0]
    pr = np.zeros((T, 128), dtype=int)
    alpha = 0.25 * 60 / bpm
    notes: List[Note] = []
    for t in range(T):
        for n in range(n_read):
            note = grid[t, n]
            if note[0] == spec.pitch_eos:
                break
            pitch = int(note[0]) + spec.min_pitch
            if not (0 <= pitch < 128):
                continue
            dur = int("".join(str(int(b)) for b in note[1:6]), 2) + 1
            pr[t, pitch] = min(dur, T - t)
            notes.append(Note(100, pitch, start + t * alpha,
                              start + (t + dur) * alpha))
    return pr, notes


def pr_matrix_to_notes(pr_mat: np.ndarray, bpm: float = 80.0,
                       start: float = 0.0) -> List[Note]:
    """(32, 128) duration matrix -> Note list (reference pr_to_notes,
    ptvae.py:546-556)."""
    alpha = 0.25 * 60 / bpm
    notes = []
    ts, ps = np.nonzero(np.asarray(pr_mat) >= 1)
    for t, p in zip(ts, ps):
        s = alpha * float(t) + start
        e = alpha * float(t + pr_mat[t, p]) + start
        notes.append(Note(100, int(p), s, e))
    return notes


def mel_pr_to_notes(mel: np.ndarray, bpm: float = 80.0, start: float = 0.0
                    ) -> List[Note]:
    """(32, 130) melody roll (sustain col 128, rest col 129) -> Note list."""
    alpha = 0.25 * 60 / bpm
    mel = np.asarray(mel)
    notes = []
    T = mel.shape[0]
    for t in range(T):
        on = np.nonzero(mel[t, :128])[0]
        for p in on:
            d = 1
            while t + d < T and mel[t + d, 128] == 1 and \
                    not mel[t + d, :128].any():
                d += 1
            notes.append(Note(100, int(p), start + t * alpha,
                              start + (t + d) * alpha))
    return notes


def add_notes(track_segments: Sequence[List[Note]], shift_second: float
              ) -> List[Note]:
    """Lay per-segment note lists onto a timeline
    (reference demo_maker.add_notes, demo_maker.py:12-20)."""
    notes = []
    ss = 0.0
    for seg in track_segments:
        notes += [Note(n.velocity, n.pitch, n.start + ss, n.end + ss)
                  for n in seg]
        ss += shift_second
    return notes


def demo_to_midi(data: Sequence[Sequence[List[Note]]], names: Sequence[str],
                 bpm: float = 90.0, shift_second: Optional[float] = None,
                 shift_beat: Optional[float] = None) -> MidiFile:
    """data[track][segment] -> multi-track MIDI
    (reference demo_maker.demo_to_midi, demo_maker.py:23-33)."""
    alpha = 60.0 / bpm
    if shift_second is None:
        shift_second = alpha * shift_beat
    midi = MidiFile(bpm=bpm)
    for track, name in zip(data, names):
        midi.tracks.append(MidiTrack(name=name,
                                     notes=add_notes(track, shift_second)))
    return midi


def write_demo(fn: str, data, names, bpm: float = 90.0,
               shift_second: Optional[float] = None,
               shift_beat: Optional[float] = None):
    demo_to_midi(data, names, bpm, shift_second, shift_beat).write(fn)
