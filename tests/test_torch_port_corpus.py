"""The port's corpus pipeline against the JAX package's on the CPU: the
synthetic corpora and example batch bit for bit, ``prepare_dataset`` on npz
songs (with a ``.csv`` index and with an ``ind.pkl`` list), the song split,
the loaders' batch order, and a ``SegmentCorpus`` save/load round trip."""
import dataclasses
import pickle

import numpy as np
import pytest

from pctd_tpu.config import DataConfig as JDataConfig
from pctd_tpu.data import corpus as jcorpus
from pctd_tpu.data import loaders as jloaders
from pctd_tpu.data import synthetic as jsyn
from pctd_tpu_torch.config import DataConfig
from pctd_tpu_torch.data import corpus, loaders, synthetic

FIELDS = ("pr", "mel", "chord", "song_id", "bar_pos")


def _same_corpus(got, want):
    assert len(got) == len(want)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("seed", [3345, 11])
def test_synthetic_corpora_and_example_batch_equal_jax(seed):
    cfg = dict(portion=3)
    got = synthetic.synthetic_corpora(
        n_songs=5, seed=seed, n_bars=8,
        cfg=dataclasses.replace(DataConfig(), **cfg))
    want = jsyn.synthetic_corpora(
        n_songs=5, seed=seed, n_bars=8,
        cfg=dataclasses.replace(JDataConfig(), **cfg))
    for g, w in zip(got, want):
        _same_corpus(g, w)
    for g, w in zip(synthetic.example_batch(24, seed),
                    jsyn.example_batch(24, seed)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_the_cli_corpus_has_the_documented_size():
    """8 songs at the default seed: 105 train / 15 val segments (the
    corpus of chip_smoke.py's training run)."""
    train, val = synthetic.synthetic_corpora(n_songs=8, seed=3345)
    assert (len(train), len(val)) == (105, 15)


def _write_songs(root, n=6):
    """npz songs in the POP909 layout (beat, chord, melody, bridge, piano),
    named by a three-digit song id, from the JAX synthetic generator."""
    data = root / "data"
    data.mkdir()
    rng = np.random.RandomState(5)
    for i in range(n):
        m = jsyn.synthetic_song(rng, n_bars=8)
        np.savez(data / f"{i + 1:03d}.npz", beat=m.beat_track.beat_table,
                 chord=m.chord_table, melody=m.tracks[0],
                 bridge=m.tracks[1], piano=m.tracks[2])
    return data


@pytest.mark.parametrize("index", ["csv", "ind.pkl"])
def test_prepare_dataset_equals_jax(tmp_path, index):
    data = _write_songs(tmp_path)
    if index == "csv":
        # song 3 is in 3/4 and song 6 is not indexed: both are left out
        rows = ["song_id,num_beats_per_measure,other"] + [
            f"{i},{3 if i == 3 else 4},x" for i in range(1, 6)]
        (tmp_path / "index.csv").write_text("\n".join(rows) + "\n")
    else:
        with open(tmp_path / "ind.pkl", "wb") as f:
            pickle.dump([str(data / f"{i:03d}.npz") for i in (2, 4, 5, 6)],
                        f)
    kw = dict(data_path=str(data), index_path=str(tmp_path / "index.csv"),
              portion=2)
    assert len(corpus.collect_data_fns(DataConfig(**kw))) == 4
    assert corpus.collect_data_fns(DataConfig(**kw)) == \
        jcorpus.collect_data_fns(JDataConfig(**kw))
    got = corpus.prepare_dataset(DataConfig(**kw))
    want = jcorpus.prepare_dataset(JDataConfig(**kw))
    for g, w in zip(got, want):
        _same_corpus(g, w)


def test_split_ids_and_loader_order_equal_jax():
    for n, portion, seed in ((9, 8, 3345), (20, 4, 1), (2, 8, 0)):
        for g, w in zip(corpus.split_ids(n, portion, seed),
                        jcorpus.split_ids(n, portion, seed)):
            np.testing.assert_array_equal(g, w)
    train, val = jsyn.synthetic_corpora(n_songs=4, seed=2, n_bars=8,
                                        cfg=dataclasses.replace(
                                            JDataConfig(), portion=3))
    got = loaders.make_loaders(train, val, 16, seed=4)
    want = jloaders.make_loaders(train, val, 16, seed=4)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        for _ in range(2):                   # two epochs: the shuffle moves
            for gb, wb in zip(g.epoch(), w.epoch(), strict=True):
                assert sorted(gb) == ["chord", "pr", "shift"]
                for k in gb:
                    np.testing.assert_array_equal(gb[k], wb[k])


def test_segment_corpus_round_trip(tmp_path):
    """save/load keeps every field; a JAX-saved corpus loads too; concat
    joins corpora; a (pr, chord) corpus feeds the loaders."""
    train, val = synthetic.synthetic_corpora(
        n_songs=4, seed=3, n_bars=8,
        cfg=dataclasses.replace(DataConfig(), portion=3))
    train.save(str(tmp_path / "c.npz"))
    _same_corpus(corpus.SegmentCorpus.load(str(tmp_path / "c.npz")), train)
    jtrain, _ = jsyn.synthetic_corpora(
        n_songs=4, seed=3, n_bars=8,
        cfg=dataclasses.replace(JDataConfig(), portion=3))
    jtrain.save(str(tmp_path / "j.npz"))
    _same_corpus(corpus.SegmentCorpus.load(str(tmp_path / "j.npz")), train)
    both = corpus.SegmentCorpus.concat([train, val])
    _same_corpus(both, jcorpus.SegmentCorpus.concat(
        [jcorpus.SegmentCorpus(*(getattr(c, f) for f in FIELDS))
         for c in (train, val)]))
    rolls = loaders.SegmentCorpus(train.pr, train.chord)
    assert rolls.mel is None and len(rolls) == len(train)
    batch = next(loaders.make_loaders(rolls, rolls, 8)[0].epoch())
    assert batch["pr"].shape == (8, 32, 128)


def test_valid_song_runs_equal_jax():
    train, _ = jsyn.synthetic_corpora(n_songs=6, seed=9)
    port = corpus.SegmentCorpus(**{f: getattr(train, f) for f in FIELDS})
    for min_bars in (4, 16):
        assert corpus.valid_song_runs(port, min_bars) == \
            jcorpus.valid_song_runs(train, min_bars)


def test_converter_equals_jax():
    """The numpy converter copy (rolls, augmentation, chord expansion,
    float-beat nmat) gives the JAX package's arrays."""
    from pctd_tpu.data import converter as jconv
    from pctd_tpu_torch.data import converter

    rng = np.random.RandomState(1)
    song = jsyn.synthetic_song(rng, n_bars=2)
    for track in song.tracks[::2]:
        for fn in ("ext_nmat_to_nmat", "ext_nmat_to_pr",
                   "ext_nmat_to_mel_pr"):
            np.testing.assert_array_equal(getattr(converter, fn)(track),
                                          getattr(jconv, fn)(track), fn)
    pr = converter.ext_nmat_to_mel_pr(song.tracks[0])
    for shift in (-6, 0, 5):
        np.testing.assert_array_equal(converter.augment_pr(pr, shift),
                                      jconv.augment_pr(pr, shift))
        np.testing.assert_array_equal(converter.augment_mel_pr(pr, shift),
                                      jconv.augment_mel_pr(pr, shift))
        np.testing.assert_array_equal(
            converter.expand_chord(song.chord_table[3], shift),
            jconv.expand_chord(song.chord_table[3], shift))
    chords = song.chord_table.reshape(-1, 8, 14)
    shifts = np.arange(len(chords)) - 1
    np.testing.assert_array_equal(
        converter.batch_expand_chord(chords, shifts),
        jconv.batch_expand_chord(chords, shifts))
