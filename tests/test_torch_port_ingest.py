"""The port's ingestion front end against the JAX package (CPU): quantize,
beat table, chord estimation with its Viterbi smoothing, MIDI -> scores ->
2-bar windows, directory ingest, song batching and the on-device
tensorizer, all exactly equal on synthetic songs written as MIDI
in-process."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.config import DataConfig as JDataConfig
from pctd_tpu.data import ingest as jing
from pctd_tpu.data import songs as jsongs
from pctd_tpu.data import tensorize as jtz
from pctd_tpu_torch.config import DataConfig, PianoTreeSpec
from pctd_tpu_torch.data import ingest as ting
from pctd_tpu_torch.data import songs as tsongs
from pctd_tpu_torch.data import tensorize as tz
from pctd_tpu_torch.data.synthetic import synthetic_song
from tests.torch_port_helpers import raw_segments


def write_song(path, seed, n_bars=12, names=("melody", "bridge", "piano")):
    """A synthetic song as MIDI at ``path``: melody and piano tracks (the
    empty bridge is not written)."""
    music = synthetic_song(np.random.RandomState(seed), n_bars=n_bars)
    music.track_name_list = list(names)
    music.write_midi(path)
    return path


def _beat_notes(seed, n=60, span=24.0):
    rng = np.random.RandomState(seed)
    s = rng.rand(n) * span
    return [(float(a), float(a + d), int(p), int(v)) for a, d, p, v in zip(
        s, rng.rand(n) * 2, rng.randint(30, 90, n), rng.randint(1, 128, n))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_estimate_chords_equal_jax(seed):
    notes = _beat_notes(seed)
    nm = ting.quantize_notes(notes)
    np.testing.assert_array_equal(nm, jing.quantize_notes(notes))
    for quanta in (2, 3):
        np.testing.assert_array_equal(ting.quantize_notes(notes, quanta),
                                      jing.quantize_notes(notes, quanta))
    # leading silence, a gap and one-beat blips for the Viterbi to smooth
    n_beats = 30
    nm = nm[(nm[:, 0] >= 2) & ((nm[:, 0] < 12) | (nm[:, 0] >= 15))]
    for kw in ({}, {"switch_penalty": 0.0}, {"switch_penalty": 2.0,
                                             "bass_bonus": 0.0}):
        got = ting.estimate_chords(nm, n_beats, **kw)
        want = jing.estimate_chords(nm, n_beats, **kw)
        np.testing.assert_array_equal(got, want)
    assert (got[:2] == 0).all() and got[20:].any()
    np.testing.assert_array_equal(ting.estimate_chords(nm[:0], 5),
                                  jing.estimate_chords(nm[:0], 5))


@pytest.mark.parametrize("sigs", [[], [(0.0, 4, 4), (4.0, 3, 4)],
                                  [(0.0, 6, 8), (6.0, 2, 2), (7.5, 5, 4)],
                                  [(2.0, 3, 4), (2.0, 7, 8)]])
def test_infer_beat_table_equals_jax(sigs):
    for default_bpb in (4, 3):
        np.testing.assert_array_equal(
            ting.infer_beat_table(23, sigs, default_bpb),
            jing.infer_beat_table(23, sigs, default_bpb))


def _same_musics(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.bpm == b.bpm and a.track_name_list == b.track_name_list
        assert a.instrument_list == b.instrument_list
        for ta, tb in zip(a.tracks, b.tracks, strict=True):
            np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(a.beat_track.beat_table,
                                      b.beat_track.beat_table)
        np.testing.assert_array_equal(a.chord_table, b.chord_table)


@pytest.mark.parametrize("names", [("melody", "bridge", "piano"),
                                   ("lead", "b", "acc"), ("a", "b", "c")])
def test_midi_to_musics_and_windows_equal_jax(tmp_path, names):
    fn = write_song(str(tmp_path / "song.mid"), seed=len(names[0]),
                    names=names)
    for split in (True, False):
        _same_musics(ting.midi_to_musics(fn, split_tracks=split),
                     jing.midi_to_musics(fn, split_tracks=split))
    for cap in (None, 3):
        got = tsongs.midi_to_windows(fn, cap)
        want = jsongs.midi_to_windows(fn, cap)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 3


def test_ingest_directory_equals_jax(tmp_path):
    root = tmp_path / "midi"
    os.makedirs(root / "sub")
    for i in range(5):
        write_song(str(root / ("sub" if i % 2 else "") / f"s{i}.mid"), i,
                   n_bars=8 + i)
    (root / "broken.mid").write_bytes(b"not a midi file")
    assert ting.collect_midi_fns(str(root)) == \
        jing.collect_midi_fns(str(root))
    cfg = dataclasses.replace(DataConfig(), portion=2)
    jcfg = dataclasses.replace(JDataConfig(), portion=2)
    for split in (True, False):
        got = ting.ingest_directory(str(root), cfg, split_tracks=split)
        want = jing.ingest_directory(str(root), jcfg, split_tracks=split)
        for a, b in zip(got, want):
            for f in ("pr", "mel", "chord", "song_id", "bar_pos"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # the cache is written once, then read
    prefix = str(tmp_path / "cache" / "c")
    first = ting.ingest_directory(str(root), cfg, cache=prefix)
    assert os.path.isfile(prefix + ".train.npz")
    again = ting.ingest_directory(str(tmp_path / "nowhere"), cfg,
                                  cache=prefix)
    np.testing.assert_array_equal(first[1].pr, again[1].pr)
    with pytest.raises(FileNotFoundError):
        ting.ingest_directory(str(tmp_path / "nowhere"), cfg)


def test_song_batching_equals_jax(tmp_path):
    for i in range(3):
        write_song(str(tmp_path / f"s{i}.mid"), 10 + i, n_bars=20)
    cfg = dataclasses.replace(DataConfig(), portion=1)
    jcfg = dataclasses.replace(JDataConfig(), portion=1)
    tr, va = ting.ingest_directory(str(tmp_path), cfg, split_tracks=False)
    jtr, jva = jing.ingest_directory(str(tmp_path), jcfg, split_tracks=False)
    for corpus, jcorpus in ((tr, jtr), (va, jva)):
        mine = tsongs.SongDataset(corpus, min_bars=8)
        theirs = jsongs.SongDataset(jcorpus, min_bars=8)
        assert (mine.song_ind, mine.song_len) == \
            (theirs.song_ind, theirs.song_len)
        for song in range(len(mine)):
            for length, shift in ((None, 0), (4, 1)):
                a = mine.get_song_batch(song, length, shift)
                b = theirs.get_song_batch(song, length, shift)
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    assert len(tsongs.SongDataset(tr, min_bars=8)) > 0


@pytest.mark.parametrize("with_detrend", [False, True])
@pytest.mark.parametrize("shifted", [False, True],
                         ids=["serving-unshifted", "train-shifted"])
def test_tensorize_batch_equals_jax(with_detrend, shifted):
    pr, chord = raw_segments(12, seed=3)
    shift = (np.arange(-6, 6, dtype=np.int32) if shifted
             else np.zeros(12, np.int32))
    got = tz.tensorize_batch(torch.from_numpy(pr), torch.from_numpy(chord),
                             torch.from_numpy(shift),
                             with_detrend=with_detrend)
    want = jtz.tensorize_batch(jnp.asarray(pr), jnp.asarray(chord),
                               jnp.asarray(shift),
                               with_detrend=with_detrend)
    assert got.keys() == want.keys()
    for k in got:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    if not shifted:
        pr_mat, c = tz.window_features(pr, chord, PianoTreeSpec(), "cpu")
        np.testing.assert_array_equal(pr_mat.numpy(), np.asarray(
            want["pr_mat"]))
        np.testing.assert_array_equal(c.numpy(), np.asarray(want["c"]))
