"""Raw-MIDI ingestion (a copy of ``pctd_tpu/data/ingest.py``): a directory
of MIDI files -> training corpora, and one file -> scores for serving:

    SMF --(midi_io.read_beats, tick-exact)--> beat-domain notes
        --(quantize, 4 bins/beat)--> ext-nmat tracks
        --(beat table inference)--> POP909-style 6-col beat table
        --(chroma template matching + Viterbi)--> per-beat 14-d chord table
        --> PolyphonicMusic --> SegmentCorpus (pctd_tpu_torch.data.corpus)

- Quantization happens in musical time (ticks / division), never seconds,
  so tempo changes cannot skew the grid.
- Each non-drum track of a multi-track file is ingested as an independent
  score, unless ``split_tracks=False``.
- A track named like "melody" is the melody; otherwise every track is
  accompaniment (the model trains on the accompaniment roll).
- Chords are estimated per beat from duration-weighted chroma with triad /
  seventh template matching; the emitted row is the raw 14-d format
  [root pc, chord-tone chroma (12), bass pc] that
  ``converter.expand_chord`` reads.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pctd_tpu_torch.config import DataConfig
from pctd_tpu_torch.data import midi_io
from pctd_tpu_torch.data.corpus import SegmentCorpus, build_corpora
from pctd_tpu_torch.data.score import PolyphonicMusic

QUANTA_PER_BEAT = 4  # sixteenth-note grid (POP909 "4-bin-quantization")


# ---------------------------------------------------------------------------
# quantization: beat-domain notes -> ext nmat
# ---------------------------------------------------------------------------


def quantize_notes(notes: Sequence[tuple], quanta: int = QUANTA_PER_BEAT
                   ) -> np.ndarray:
    """(start_beat, end_beat, pitch, vel) float rows -> (N, 8) ext nmat
    [start_beat, start_quantum, start_denom, end_beat, end_quantum,
    end_denom, pitch, velocity] on a ``quanta``-per-beat grid. Zero-length
    notes after rounding are extended to one quantum."""
    if not len(notes):
        return np.zeros((0, 8), dtype=float)
    arr = np.asarray([(s, e, p, v) for (s, e, p, v) in notes], dtype=float)
    qs = np.rint(arr[:, 0] * quanta).astype(np.int64)
    qe = np.rint(arr[:, 1] * quanta).astype(np.int64)
    qe = np.maximum(qe, qs + 1)
    out = np.zeros((len(arr), 8), dtype=float)
    out[:, 0] = qs // quanta
    out[:, 1] = qs % quanta
    out[:, 2] = quanta
    out[:, 3] = qe // quanta
    out[:, 4] = qe % quanta
    out[:, 5] = quanta
    out[:, 6] = arr[:, 2]
    out[:, 7] = arr[:, 3]
    return out


# ---------------------------------------------------------------------------
# beat-table inference
# ---------------------------------------------------------------------------


def infer_beat_table(n_beats: int, time_signatures: Sequence[tuple],
                     default_bpb: int = 4) -> np.ndarray:
    """POP909-convention 6-col beat table
    [beat_in_bar, bar, beats_per_bar] x2 for beats 0..n_beats-1, honoring
    time-signature changes (rows are what score.BeatTrack reads: cols 3, 5)."""
    # (start_beat, beats_per_bar) regions; x/8 meters count eighth-note beats,
    # which this quarter-note grid folds to numerator/2 when even.
    regions = [(0.0, default_bpb)]
    for (beat, num, den) in sorted(time_signatures):
        bpb = num if den <= 4 else max(1, num * 4 // den)
        if regions and regions[-1][0] == beat:
            regions[-1] = (beat, bpb)
        else:
            regions.append((beat, bpb))
    table = np.zeros((n_beats, 6), dtype=np.int64)
    bar, bib = 0, 0
    ri = 0
    for b in range(n_beats):
        while ri + 1 < len(regions) and regions[ri + 1][0] <= b:
            ri += 1
            bar, bib = bar + (1 if bib else 0), 0  # TS change starts a bar
        bpb = regions[ri][1]
        table[b] = [bib, bar, bpb, bib, bar, bpb]
        bib += 1
        if bib >= bpb:
            bib = 0
            bar += 1
    return table


# ---------------------------------------------------------------------------
# chord estimation (per-beat chroma template matching)
# ---------------------------------------------------------------------------

# (name, intervals) — triads first so ties prefer simpler chords
_CHORD_TEMPLATES: List[Tuple[str, Tuple[int, ...]]] = [
    ("maj", (0, 4, 7)),
    ("min", (0, 3, 7)),
    ("dim", (0, 3, 6)),
    ("aug", (0, 4, 8)),
    ("dom7", (0, 4, 7, 10)),
    ("min7", (0, 3, 7, 10)),
    ("maj7", (0, 4, 7, 11)),
]


def _beat_chroma_and_bass(nmat: np.ndarray, n_beats: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Duration-weighted chroma (n_beats, 12) + lowest sounding pitch per
    beat (n_beats,), -1 where silent, from an ext nmat."""
    chroma = np.zeros((n_beats, 12))
    bass = np.full(n_beats, -1, dtype=np.int64)
    low = np.full(n_beats, 1 << 30, dtype=np.int64)
    if not len(nmat):
        return chroma, bass
    starts = nmat[:, 0] + nmat[:, 1] / nmat[:, 2]
    ends = nmat[:, 3] + nmat[:, 4] / nmat[:, 5]
    pitches = nmat[:, 6].astype(np.int64)
    for s, e, p in zip(starts, ends, pitches):
        b0, b1 = int(np.floor(s)), int(np.ceil(e))
        for b in range(max(b0, 0), min(b1, n_beats)):
            w = min(e, b + 1) - max(s, b)
            if w <= 0:
                continue
            chroma[b, p % 12] += w
            if p < low[b]:
                low[b] = p
                bass[b] = p % 12
    return chroma, bass


def _template_bank() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (root, quality) states as a (S, 12) chord-tone bitmask matrix plus
    per-state root pc and tone count. S = 12 roots x len(_CHORD_TEMPLATES)."""
    masks, roots, sizes = [], [], []
    for root in range(12):
        for _, ivs in _CHORD_TEMPLATES:
            m = np.zeros(12)
            m[[(root + i) % 12 for i in ivs]] = 1.0
            masks.append(m)
            roots.append(root)
            sizes.append(len(ivs))
    return np.asarray(masks), np.asarray(roots), np.asarray(sizes, float)


def estimate_chords(nmat: np.ndarray, n_beats: int,
                    switch_penalty: float = 0.4,
                    bass_bonus: float = 0.1) -> np.ndarray:
    """Per-beat 14-d chord rows [root, chroma(12), bass] from an ext nmat.

    Chroma-HMM chord estimation: per-beat emission scores over all
    (root, quality) template states from duration-weighted chroma, Viterbi
    decoding with a chord-switch penalty (suppresses one-beat blips in
    arpeggiated textures). The emitted chroma is the TEMPLATE bitmap (chord
    tones), matching POP909-style annotations. Leading silence stays
    all-zero; interior silence inherits via the zero-emission + switch
    penalty, i.e. the chord sustains.

    ``bass_bonus`` rewards states whose root is the beat's lowest sounding
    pitch class — the relative-major/minor disambiguator (a {C,E,G,A} beat
    is C6 over a C bass, Am7 over an A bass). Calibrated on the reference
    demo corpus: 0.1 recovers the C-bass openings the root-presence term
    alone mislabels Am, while staying below the ~0.15 threshold where
    inverted chords (A-bass F beats) start flipping to the relative minor."""
    obs, bass = _beat_chroma_and_bass(nmat, n_beats)
    masks, roots, sizes = _template_bank()
    totals = obs.sum(axis=1, keepdims=True)                       # (T, 1)
    sounding = totals[:, 0] > 1e-9
    c = np.where(totals > 1e-9, obs / np.maximum(totals, 1e-9), 0.0)
    in_w = c @ masks.T                                            # (T, S)
    coverage = ((c > 1e-9).astype(float) @ masks.T) / sizes       # (T, S)
    emit = in_w - 0.6 * (1.0 - in_w) + 0.3 * coverage + 0.2 * c[:, roots]
    if bass_bonus:
        # lowest sounding pitch == state root: the classic relative-
        # major/minor disambiguator on sparse arpeggiated beats
        emit += bass_bonus * (bass[:, None] == roots[None, :])
    emit[~sounding] = 0.0                                         # no signal

    S = masks.shape[0]
    # Viterbi: stay free, switch costs switch_penalty
    score = emit[0].copy()
    back = np.zeros((n_beats, S), dtype=np.int64)
    for t in range(1, n_beats):
        switch_best = score.max()
        switch_arg = int(score.argmax())
        stay = score
        switched = switch_best - switch_penalty
        take_stay = stay >= switched
        back[t] = np.where(take_stay, np.arange(S), switch_arg)
        score = np.where(take_stay, stay, switched) + emit[t]
    path = np.zeros(n_beats, dtype=np.int64)
    path[-1] = int(score.argmax())
    for t in range(n_beats - 1, 0, -1):
        path[t - 1] = back[t, path[t]]

    out = np.zeros((n_beats, 14))
    seen_sound = False
    for b in range(n_beats):
        seen_sound = seen_sound or sounding[b]
        if not seen_sound:
            continue  # leading silence: no chord
        s = path[b]
        out[b, 0] = roots[s]
        out[b, 1:13] = masks[s]
        out[b, 13] = bass[b] if bass[b] >= 0 else roots[s]
    return out


# ---------------------------------------------------------------------------
# file -> PolyphonicMusic scores
# ---------------------------------------------------------------------------


def _is_melody_name(name: str) -> bool:
    return "mel" in name.lower()


def midi_to_musics(fn: str, split_tracks: bool = True,
                   default_bpb: int = 4) -> List[PolyphonicMusic]:
    """One MIDI file -> standalone scores (one per non-drum track when
    ``split_tracks``, else a single score with melody/accompaniment roles).

    Track layout of each returned score is POP909-shaped:
    [melody, accompaniment, (empty)] so ``corpus.song_to_segments`` applies
    unchanged (mel_id=(0,), acc_id=(1, 2), reference score.py:68-123)."""
    bm = midi_io.read_beats(fn)
    tracks = [t for t in bm.tracks if not t.is_drum and t.notes]
    if not tracks:
        return []
    empty = np.zeros((0, 8), dtype=float)

    def make_music(mel_nmat, acc_nmat, names):
        end_q = 0.0
        for t in (mel_nmat, acc_nmat):
            if len(t):
                end_q = max(end_q, (t[:, 3] + t[:, 4] / t[:, 5]).max())
        n_beats = max(int(np.ceil(end_q)), 1)
        beat = infer_beat_table(n_beats, bm.time_signatures, default_bpb)
        chord_src = acc_nmat if len(acc_nmat) else mel_nmat
        chord = estimate_chords(chord_src, n_beats)
        return PolyphonicMusic([mel_nmat, acc_nmat, empty], beat, chord,
                               instrument_list=[70, 0, 0],
                               track_name_list=names + [""],
                               bpm=bm.bpm)

    if split_tracks:
        out = []
        for t in tracks:
            nmat = quantize_notes(t.notes)
            if _is_melody_name(t.name) and len(tracks) > 1:
                continue  # melody-only track is not a standalone piece
            out.append(make_music(empty, nmat, ["", t.name or "track"]))
        return out

    mel = [t for t in tracks if _is_melody_name(t.name)]
    acc = [t for t in tracks if not _is_melody_name(t.name)] or tracks
    mel_nmat = (quantize_notes([n for t in mel for n in t.notes])
                if mel else empty)
    acc_nmat = quantize_notes([n for t in acc for n in t.notes])
    order = np.argsort(acc_nmat[:, 0] * QUANTA_PER_BEAT + acc_nmat[:, 1],
                       kind="stable")
    acc_nmat = acc_nmat[order]
    return [make_music(mel_nmat, acc_nmat,
                       ["melody" if mel else "", "acc"])]


# ---------------------------------------------------------------------------
# directory -> corpora
# ---------------------------------------------------------------------------


def collect_midi_fns(root: str) -> List[str]:
    return sorted(glob.glob(os.path.join(root, "**", "*.mid"),
                            recursive=True))


def ingest_directory(root: str, cfg: Optional[DataConfig] = None,
                     split_tracks: bool = True,
                     cache: Optional[str] = None,
                     ) -> Tuple[SegmentCorpus, SegmentCorpus]:
    """Every MIDI under ``root`` -> (train, val) SegmentCorpus via the same
    song-level split discipline as the npz path (corpus.build_corpora).

    ``cache``: optional path prefix; when both ``<cache>.train.npz`` and
    ``<cache>.val.npz`` exist they are loaded instead of re-ingesting, and
    they are written after a fresh ingest (packed corpora are ~5 KB/segment,
    so the demo corpus caches at ~15 MB)."""
    if cache:
        tr_fn, va_fn = f"{cache}.train.npz", f"{cache}.val.npz"
        if os.path.exists(tr_fn) and os.path.exists(va_fn):
            return SegmentCorpus.load(tr_fn), SegmentCorpus.load(va_fn)
    cfg = cfg or DataConfig()
    musics = []
    skipped = []
    for fn in collect_midi_fns(root):
        try:
            musics.extend(midi_to_musics(fn, split_tracks=split_tracks))
        except Exception as e:  # malformed files: skip, don't abort ingest
            skipped.append((fn, str(e)))
    if skipped:
        print(f"ingest: skipped {len(skipped)} unreadable files "
              f"(first: {skipped[0]})")
    if not musics:
        raise FileNotFoundError(f"no ingestable MIDI files under {root}")
    train, val = build_corpora(musics, cfg)
    if cache:
        os.makedirs(os.path.dirname(os.path.abspath(tr_fn)), exist_ok=True)
        train.save(tr_fn)
        val.save(va_fn)
    return train, val
