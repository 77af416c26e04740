"""Symbolic-music score model (a numpy copy of ``pctd_tpu/data/score.py``):
multi-track note matrices with aligned beat and chord tables, partial bars
regularized, everything split into bars, the (data_track, indicator,
db_pos) training index where ``indicator[i] == 1`` iff bar ``i`` starts a
valid ``num_bar`` window of ``ts``-beat bars with data, and MIDI export
(``to_midi``, ``write_midi``) through the port's own writer
(:mod:`pctd_tpu_torch.data.midi_io`).

Beat-table row format (POP909 convention):
    [beat_in_bar, bar_no, beats_per_bar, beat_in_bar, bar_no, beats_per_bar]
(columns 3 and 5 are read).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from pctd_tpu_torch.data.converter import ext_nmat_to_nmat, nmat_to_notes


class BeatTrack:
    """Beat-table regularization + downbeat / time-signature extraction."""

    def __init__(self, beat_table: np.ndarray, require_regularize: bool = True):
        self.beat_table = np.asarray(beat_table).copy()
        self.translation = 0
        self.post_translation = 0
        if require_regularize:
            self.regularize()

    def _fill_pre_beat(self):
        cur = self.beat_table[0]
        pre = cur.copy()
        pre[0] = (pre[0] - 1) % pre[2]
        pre[3] = (pre[3] - 1) % pre[5]
        if cur[0] == 0:
            pre[1] -= 1
        if cur[3] == 0:
            pre[4] -= 1
        self.beat_table = np.concatenate([pre[None], self.beat_table], axis=0)

    def _fill_post_beat(self):
        cur = self.beat_table[-1]
        post = cur.copy()
        post[0] = (post[0] + 1) % post[2]
        post[3] = (post[3] + 1) % post[5]
        if post[0] == 0:
            post[1] += 1
        if post[3] == 0:
            post[4] += 1
        self.beat_table = np.concatenate([self.beat_table, post[None]], axis=0)

    def regularize(self):
        while self.beat_table[0, 3] != 0:
            self._fill_pre_beat()
            self.translation += 1
        while self.beat_table[-1, 3] != self.beat_table[-1, 5] - 1:
            self._fill_post_beat()
            self.post_translation += 1

    def get_downbeats(self) -> Tuple[np.ndarray, np.ndarray]:
        db_pos = np.where(self.beat_table[:, 3] == 0)[0]
        db_ts = self.beat_table[db_pos, 5]
        return db_pos, db_ts

    def get_time_signature_change(self):
        ts = self.beat_table[:, 5]
        change = np.concatenate(
            [np.zeros(1, dtype=int),
             np.where(ts[1:] != np.roll(ts, 1)[1:])[0] + 1])
        return change, self.beat_table[change, 5]


class PolyphonicMusic:
    """Multi-track score: tracks (list of (Ni, 8) ext nmats), beat table,
    chord table."""

    def __init__(self, tracks: Sequence[np.ndarray], beat_table: np.ndarray,
                 chord_table: np.ndarray,
                 instrument_list: Optional[Sequence[int]] = None,
                 track_name_list: Optional[Sequence[str]] = None,
                 bpm: float = 120.0):
        assert beat_table.shape[0] == chord_table.shape[0]
        self.tracks = [np.asarray(t, dtype=float).copy().reshape(-1, 8)
                       for t in tracks]
        self.beat_track = BeatTrack(beat_table, require_regularize=True)
        self.chord_table = np.asarray(chord_table).copy()
        self._regularize_chord_table()
        self._regularize_tracks()
        self.num_track = len(self.tracks)
        self.instrument_list = (list(instrument_list) if instrument_list
                                is not None else [0] * self.num_track)
        self.track_name_list = (list(track_name_list) if track_name_list
                                is not None else
                                [str(i) for i in range(self.num_track)])
        self.bpm = bpm

    # -- regularization ------------------------------------------------------

    def _regularize_chord_table(self):
        pre = np.zeros((self.beat_track.translation,
                        self.chord_table.shape[1]), self.chord_table.dtype)
        post = np.zeros((self.beat_track.post_translation,
                         self.chord_table.shape[1]), self.chord_table.dtype)
        self.chord_table = np.concatenate([pre, self.chord_table, post], 0)

    def _regularize_tracks(self):
        for t in self.tracks:
            if len(t):
                t[:, 0] += self.beat_track.translation
                t[:, 3] += self.beat_track.translation

    # -- bar splitting ---------------------------------------------------------

    def _bar_bounds(self, db_pos, db_ts):
        return list(zip(db_pos, np.append(db_pos[1:], db_pos[-1] + db_ts[-1])))

    def break_track_to_bars(self, track, db_pos=None, db_ts=None) -> List:
        if db_pos is None or db_ts is None:
            db_pos, db_ts = self.beat_track.get_downbeats()
        bars = []
        for s, e in self._bar_bounds(db_pos, db_ts):
            inds = np.where((track[:, 0] >= s) & (track[:, 0] < e))[0] \
                if len(track) else np.array([], dtype=int)
            bars.append(track[inds] if len(track) else
                        np.zeros((0, 8), dtype=float))
        return bars

    def break_chord_to_bars(self, db_pos=None, db_ts=None) -> List:
        if db_pos is None or db_ts is None:
            db_pos, db_ts = self.beat_track.get_downbeats()
        return [self.chord_table[s:e] for s, e in self._bar_bounds(db_pos,
                                                                   db_ts)]

    # -- training index --------------------------------------------------------

    def prepare_data(self, num_bar: int = 8, ts: int = 4,
                     mel_id: Tuple[int, ...] = (0,),
                     acc_id: Tuple[int, ...] = (1, 2)):
        """Build (data_track, indicator, db_pos): per bar, the bar-relative
        merged melody nmat, accompaniment nmat and chord rows; indicator[i]==1
        iff bars i..i+num_bar-1 all have ts beats, complete chords, and bar i
        has notes."""

        def merge(bars, ids):
            chosen = [b for i, b in enumerate(bars) if i in ids and len(b)]
            if not chosen:
                return None
            merged = np.concatenate(chosen, axis=0)
            return merged[merged[:, 0].argsort(kind="stable")]

        def translate(track, shift):
            if track is None:
                return None
            track = track.copy()
            track[:, 0] -= shift
            track[:, 3] -= shift
            return track

        db_pos, db_ts = self.beat_track.get_downbeats()
        broken_tracks = [self.break_track_to_bars(t, db_pos, db_ts)
                         for t in self.tracks]
        per_bar = [list(bar) for bar in zip(*broken_tracks)]
        broken_chords = self.break_chord_to_bars(db_pos, db_ts)
        n = len(db_pos)
        indicator = np.zeros(n)
        for i, chord in enumerate(broken_chords):
            if chord.shape[0] != ts:
                indicator[i] = -1
        data_track = []
        for i in range(n):
            mel = translate(merge(per_bar[i], mel_id), db_pos[i])
            acc = translate(merge(per_bar[i], acc_id), db_pos[i])
            data_track.append([mel, acc, broken_chords[i]])
            if mel is None and acc is None:
                indicator[i] = 0
                continue
            if i > n - num_bar:
                indicator[i] = 0
                continue
            if not (db_ts[i:i + num_bar] == ts).all():
                indicator[i] = 0
                continue
            if (indicator[i:i + num_bar] == -1).any():
                indicator[i] = 0
                continue
            indicator[i] = 1
        return data_track, indicator, db_pos

    # -- export ----------------------------------------------------------------

    def convert_track_to_notes(self, track_ind=0, start=0.0, bpm=None):
        bpm = bpm or self.bpm
        nmat = ext_nmat_to_nmat(self.tracks[track_ind])
        return nmat_to_notes(nmat, start, bpm)

    def to_midi(self, track_ids=None, start=0.0, bpm=None):
        from pctd_tpu_torch.data.midi_io import MidiFile, MidiTrack

        bpm = bpm or self.bpm
        if track_ids is None:
            track_ids = [i for i in range(self.num_track)
                         if len(self.tracks[i])]
        midi = MidiFile(bpm=bpm)
        for i in track_ids:
            midi.tracks.append(MidiTrack(
                name=self.track_name_list[i],
                program=self.instrument_list[i],
                notes=self.convert_track_to_notes(i, start, bpm)))
        return midi

    def write_midi(self, fn, track_ids=None, start=0.0, bpm=None):
        self.to_midi(track_ids, start, bpm).write(fn)
