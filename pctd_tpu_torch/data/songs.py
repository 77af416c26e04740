"""Whole-song batching (a copy of ``pctd_tpu/data/songs.py``): songs are
runs of consecutive valid bars of a corpus, and every other 2-bar segment
(stride 2, so segments tile the song without overlap) is stacked into one
batch; ``midi_to_windows`` does the same to a MIDI file through the
ingestion front end, for the serving daemon and the arrange CLI.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pctd_tpu_torch.data.corpus import SegmentCorpus, valid_song_runs


class SongDataset:
    """Songs = runs of >= min_bars consecutive valid segments
    (reference collect_song.SongDataset, collect_song.py:60-83)."""

    def __init__(self, corpus: SegmentCorpus, min_bars: int = 16,
                 num_bar: int = 2):
        self.corpus = corpus
        self.num_bar = num_bar
        runs = valid_song_runs(corpus, min_bars=min_bars, num_bar=num_bar)
        self.song_ind = [r[0] for r in runs]
        self.song_len = [r[1] for r in runs]

    def __len__(self):
        return len(self.song_ind)

    def get_song_batch(self, song_id: int, length: Optional[int] = None,
                       shift: int = 0) -> Dict[str, np.ndarray]:
        """Stack every num_bar-th segment of a song (stride-num_bar tiling
        of num_bar-bar windows so segments cover the song without overlap;
        the reference's stride-2 walk over 2-bar windows,
        collect_song.get_whole_song_data, collect_song.py:34-57). Returns
        raw arrays ready for the on-device tensorizer: pr (S,T,128),
        mel (S,T,130), chord (S,T//4,14)."""
        if length is None:
            length = self.song_len[song_id]
        assert length + shift <= self.song_len[song_id]
        start = self.song_ind[song_id] + shift
        idx = np.arange(start, self.song_ind[song_id] + length + shift)
        idx = idx[(idx - start) % self.num_bar == 0]
        return {
            "pr": self.corpus.pr[idx],
            "mel": self.corpus.mel[idx],
            "chord": self.corpus.chord[idx],
            "shift": np.zeros(len(idx), np.int32),
        }


def midi_to_windows(path: str, max_windows: Optional[int] = None):
    """Raw MIDI file -> consecutive non-overlapping 2-bar windows:
    (pr (N,32,128), mel (N,32,130), chord (N,8,14), bpm).

    The whole-song batching of reference collect_song.py:34-57 (stride-2
    walk over valid segments) applied directly to a MIDI file through the
    ingestion front end; shared by ``cli.serve`` and ``cli.arrange``.
    """
    from pctd_tpu_torch.data.corpus import song_to_segments
    from pctd_tpu_torch.data.ingest import midi_to_musics

    music = midi_to_musics(path, split_tracks=False)[0]
    seg = song_to_segments(music, 0)
    keep = [] if seg is None else [
        i for i in range(len(seg)) if seg.bar_pos[i] % 2 == 0]
    if not keep:
        raise ValueError(f"{path}: no valid aligned 2-bar windows")
    if max_windows is not None:
        keep = keep[:max_windows]
    return seg.pr[keep], seg.mel[keep], seg.chord[keep], music.bpm
