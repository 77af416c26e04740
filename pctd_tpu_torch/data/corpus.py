"""Corpus assembly: songs -> packed per-segment arrays (a numpy copy of
``pctd_tpu/data/corpus.py``).

Each valid 2-bar window is tensorized once into a compact base
representation

    pr    (N, 32, 128) uint8   onset(2)/sustain(1)/rest(0) accompaniment roll
    mel   (N, 32, 130) uint8   melody roll (sustain col 128, rest col 129)
    chord (N, 8, 14)   float32 raw per-beat chord rows

and augmentation and the derived features are made on the device at batch
time (:mod:`pctd_tpu_torch.data.tensorize`). A song index in ``.csv`` is
read with the standard ``csv`` module; pandas is imported only for an
``.xlsx`` index.
"""
from __future__ import annotations

import csv
import glob
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pctd_tpu_torch.config import DataConfig
from pctd_tpu_torch.data.converter import ext_nmat_to_mel_pr, ext_nmat_to_pr
from pctd_tpu_torch.data.score import PolyphonicMusic

FIELDS = ("pr", "mel", "chord", "song_id", "bar_pos")


@dataclass
class SegmentCorpus:
    """Packed, un-augmented 2-bar segments (one split). The loaders read
    ``pr`` and ``chord`` only, so ``SegmentCorpus(pr, chord)`` is a corpus
    too; ``mel``, ``song_id`` and ``bar_pos`` come from the pipeline."""

    pr: np.ndarray                        # (N, 32, 128) uint8
    chord: np.ndarray                     # (N, 8, 14) float32
    mel: Optional[np.ndarray] = None      # (N, 32, 130) uint8
    song_id: Optional[np.ndarray] = None  # (N,) int32, provenance
    bar_pos: Optional[np.ndarray] = None  # (N,) int32, the first bar

    def __len__(self):
        return self.pr.shape[0]

    def save(self, fn: str):
        np.savez_compressed(fn, **{f: getattr(self, f) for f in FIELDS})

    @staticmethod
    def load(fn: str) -> "SegmentCorpus":
        d = np.load(fn)
        return SegmentCorpus(**{f: d[f] for f in FIELDS})

    @staticmethod
    def concat(parts: Sequence["SegmentCorpus"]) -> "SegmentCorpus":
        return SegmentCorpus(**{f: np.concatenate([getattr(p, f)
                                                   for p in parts])
                                for f in FIELDS})


def _translate(nmat: Optional[np.ndarray], translation: float):
    """Shift a bar-relative nmat by ``translation`` beats."""
    if nmat is None:
        return None
    nmat = nmat.copy()
    nmat[:, 0] -= translation
    nmat[:, 3] -= translation
    return nmat


def combine_segments(*bars, ts: int = 4):
    """Consecutive 1-bar nmats -> one multi-bar nmat: bar j is shifted to
    beats [j*ts, (j+1)*ts)."""
    parts = [_translate(bar, -ts * j) for j, bar in enumerate(bars)
             if bar is not None]
    if not parts:
        return None
    return np.concatenate(parts, axis=0)


def song_to_segments(music: PolyphonicMusic, song_id: int, num_bar: int = 2,
                     ts: int = 4) -> Optional[SegmentCorpus]:
    """All valid ``num_bar`` windows of one song -> packed arrays (shift 0),
    ``num_bar * ts * 4`` sixteenth-steps long."""
    data_track, indicator, _ = music.prepare_data(num_bar=num_bar, ts=ts)
    valid = np.where(indicator == 1)[0]
    if len(valid) == 0:
        return None
    num_step = num_bar * ts * 4
    prs, mels, chords = [], [], []
    for i in valid:
        bars = data_track[i:i + num_bar]
        mel_nmat = combine_segments(*[b[0] for b in bars], ts=ts)
        acc_nmat = combine_segments(*[b[1] for b in bars], ts=ts)
        prs.append(ext_nmat_to_pr(acc_nmat, num_step).astype(np.uint8))
        mels.append(ext_nmat_to_mel_pr(mel_nmat, num_step).astype(np.uint8))
        chords.append(np.concatenate([b[2] for b in bars],
                                     axis=0).astype(np.float32))
    return SegmentCorpus(
        pr=np.stack(prs), mel=np.stack(mels), chord=np.stack(chords),
        song_id=np.full(len(valid), song_id, np.int32),
        bar_pos=valid.astype(np.int32))


def valid_song_runs(corpus: SegmentCorpus, min_bars: int = 16,
                    num_bar: int = 2) -> List[Tuple[int, int]]:
    """(start_index, length) of the runs of consecutive valid bars of each
    song, keeping runs with length + num_bar + 1 >= min_bars (a run of L
    window starts spans L + num_bar - 1 bars). ``num_bar`` is the window
    size the corpus was built with."""
    runs = []
    n = len(corpus)
    i = 0
    while i < n:
        j = i
        while (j + 1 < n and corpus.song_id[j + 1] == corpus.song_id[i]
               and corpus.bar_pos[j + 1] == corpus.bar_pos[j] + 1):
            j += 1
        length = j - i + 1
        if length + num_bar + 1 >= min_bars:
            runs.append((i, length))
        i = j + 1
    return runs


def init_music_from_npz(fn: str) -> PolyphonicMusic:
    """npz with keys beat/chord/melody/bridge/piano -> PolyphonicMusic."""
    d = np.load(fn)
    return PolyphonicMusic([d["melody"], d["bridge"], d["piano"]],
                           d["beat"], d["chord"], [70, 0, 0])


def _beats_per_measure(index_path: str) -> dict:
    """song_id -> num_beats_per_measure of its first row in the index
    (``.csv`` by the csv module, else ``.xlsx`` by pandas)."""
    if index_path.endswith(".csv"):
        with open(index_path, newline="") as f:
            rows = [(r["song_id"], r["num_beats_per_measure"])
                    for r in csv.DictReader(f)]
    else:
        import pandas as pd

        df = pd.read_excel(index_path)
        rows = zip(df.song_id, df.num_beats_per_measure)
    meter = {}
    for song, beats in rows:
        meter.setdefault(int(float(song)), int(float(beats)))
    return meter


def collect_data_fns(cfg: DataConfig) -> List[str]:
    """The npz corpus's files; ``ind.pkl`` beside the data directory, when
    present, is the list. Else the songs whose ``num_beats_per_measure`` in
    the index (when it exists) equals ``cfg.ts``, or 2 with
    ``cfg.ref_meter_filter``."""
    ind_pkl = os.path.join(os.path.dirname(cfg.data_path), "ind.pkl")
    if os.path.exists(ind_pkl):
        with open(ind_pkl, "rb") as f:
            return pickle.load(f)
    fns = sorted(glob.glob(os.path.join(cfg.data_path, "*.npz")))
    if os.path.exists(cfg.index_path):
        want = 2 if cfg.ref_meter_filter else cfg.ts
        meter = _beats_per_measure(cfg.index_path)
        fns = [fn for fn in fns
               if meter.get(int(os.path.basename(fn)[0:3])) == want]
    return fns


def split_ids(length: int, portion: int, seed: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Random train/val song split, portion:1."""
    rng = np.random.RandomState(seed)
    train = rng.choice(length, int(length * portion / (portion + 1)),
                       replace=False)
    val = np.setdiff1d(np.arange(length), train)
    return train, val


def build_corpora(musics: Sequence[PolyphonicMusic], cfg: DataConfig
                  ) -> Tuple[SegmentCorpus, SegmentCorpus]:
    """Song-level split -> (train, val) packed corpora."""
    train_ids, val_ids = split_ids(len(musics), cfg.portion, cfg.seed)

    def pack(ids):
        parts = [song_to_segments(musics[i], i, cfg.num_bar, cfg.ts)
                 for i in ids]
        parts = [p for p in parts if p is not None]
        if not parts:
            raise ValueError("no valid segments in corpus split")
        return SegmentCorpus.concat(parts)

    return pack(train_ids), pack(val_ids)


def prepare_dataset(cfg: DataConfig) -> Tuple[SegmentCorpus, SegmentCorpus]:
    """npz corpus on disk -> (train, val) corpora."""
    fns = collect_data_fns(cfg)
    if not fns:
        raise FileNotFoundError(
            f"no npz files under {cfg.data_path}; use "
            "pctd_tpu_torch.data.synthetic.synthetic_corpora for a "
            "self-contained corpus")
    musics = [init_music_from_npz(fn) for fn in fns]
    return build_corpora(musics, cfg)
