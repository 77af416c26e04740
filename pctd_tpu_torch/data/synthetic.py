"""Synthetic POP909-style songs for self-contained training, tests and
chip runs (a numpy copy of ``pctd_tpu/data/synthetic.py``; the same seed
gives the same songs and corpora bit for bit): melody / bridge / piano
ext-nmat tracks with a beat table and a chord table, diatonic progressions
in a random key, block or arpeggiated accompaniment and a scale-wise
melody.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pctd_tpu_torch.config import DataConfig
from pctd_tpu_torch.data.corpus import SegmentCorpus, build_corpora
from pctd_tpu_torch.data.score import PolyphonicMusic

MAJOR_SCALE = np.array([0, 2, 4, 5, 7, 9, 11])
# I, ii, iii, IV, V, vi — (root degree, triad degrees)
DIATONIC = [(0, (0, 2, 4)), (1, (1, 3, 5)), (2, (2, 4, 6)),
            (3, (3, 5, 0)), (4, (4, 6, 1)), (5, (5, 0, 2))]


def _note(start_q: int, dur_q: int, pitch: int, vel: int = 100):
    """quanta (16th notes) -> ext nmat row [sb, sq, 4, eb, eq, 4, pitch, vel]."""
    e = start_q + dur_q
    return [start_q // 4, start_q % 4, 4, e // 4, e % 4, 4, pitch, vel]


def synthetic_song(rng: np.random.RandomState, n_bars: int = 16, ts: int = 4
                   ) -> PolyphonicMusic:
    key = int(rng.randint(0, 12))
    n_beats = n_bars * ts
    beat = np.zeros((n_beats, 6), dtype=np.int64)
    b = np.arange(n_beats)
    beat[:, 0] = beat[:, 3] = b % ts
    beat[:, 1] = beat[:, 4] = b // ts
    beat[:, 2] = beat[:, 5] = ts

    # chord per bar, two chords per bar half the time
    chord = np.zeros((n_beats, 14), dtype=np.float32)
    mel_rows, acc_rows = [], []
    prog = rng.randint(0, len(DIATONIC), size=n_bars * 2)
    for bar in range(n_bars):
        for half in range(2):
            deg, triad = DIATONIC[prog[2 * bar + half]]
            root_pc = (key + MAJOR_SCALE[deg]) % 12
            chroma = np.zeros(12)
            pcs = [(key + MAJOR_SCALE[d]) % 12 for d in triad]
            for pc in pcs:
                chroma[pc] = 1
            beats = range(bar * ts + half * 2, bar * ts + (half + 1) * 2)
            for bt in beats:
                chord[bt, 0] = root_pc
                chord[bt, 1:13] = chroma
                chord[bt, 13] = root_pc

            # accompaniment: block chord or arpeggio over the half bar
            base_q = bar * ts * 4 + half * 8
            chord_pitches = sorted(48 + ((pc - key) % 12) + 12 * rng.randint(0, 2)
                                   for pc in pcs)
            if rng.rand() < 0.5:  # block
                for p in chord_pitches:
                    acc_rows.append(_note(base_q, 8, int(p)))
                acc_rows.append(_note(base_q, 8, int(chord_pitches[0]) - 12))
            else:                  # arpeggio, eighths
                seq = chord_pitches + chord_pitches[1:-1][::-1]
                for k in range(4):
                    p = seq[k % len(seq)]
                    acc_rows.append(_note(base_q + 2 * k, 2, int(p)))
                acc_rows.append(_note(base_q, 8, int(chord_pitches[0]) - 12))

            # melody: scale steps around the chord
            q = base_q
            cur = 72 + (pcs[rng.randint(0, 3)] - key) % 12
            while q < base_q + 8:
                dur = int(rng.choice([2, 2, 4]))
                dur = min(dur, base_q + 8 - q)
                mel_rows.append(_note(q, dur, int(np.clip(cur, 60, 95))))
                step = int(rng.choice([-2, -1, 1, 2]))
                cur = cur + step
                q += dur

    mel = np.array(mel_rows, dtype=float)
    acc = np.array(acc_rows, dtype=float)
    bridge = np.zeros((0, 8), dtype=float)
    return PolyphonicMusic([mel, bridge, acc], beat, chord, [70, 0, 0])


def synthetic_corpora(n_songs: int = 20, seed: int = 3345,
                      n_bars: int = 16, cfg: DataConfig = DataConfig()
                      ) -> Tuple[SegmentCorpus, SegmentCorpus]:
    """Generate songs and run them through the real corpus pipeline
    (score -> prepare_data -> packed segments -> song-level split)."""
    rng = np.random.RandomState(seed)
    musics: List[PolyphonicMusic] = [synthetic_song(rng, n_bars=n_bars,
                                                    ts=cfg.ts)
                                     for _ in range(n_songs)]
    return build_corpora(musics, cfg)


def example_batch(batch_size: int, seed: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw uint8 segments + chords + shifts, the train-step input format
    (pr (B,32,128) uint8, chord (B,8,14) float32, shift (B,) int32)."""
    import dataclasses

    cfg = dataclasses.replace(DataConfig(), portion=4)
    train, _ = synthetic_corpora(n_songs=4, seed=seed, n_bars=8, cfg=cfg)
    n = len(train)
    idx = np.arange(batch_size) % n
    rng = np.random.RandomState(seed)
    return (train.pr[idx], train.chord[idx],
            rng.randint(-6, 6, batch_size).astype(np.int32))
