"""The port's on-device tensorize and batch loaders against the JAX
package: integer outputs exactly equal, for random raw batches and every
augmentation shift -6..5 (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.data import loaders as jloaders
from pctd_tpu.data import tensorize as jtz
from pctd_tpu.data.corpus import SegmentCorpus as JCorpus
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch.data import loaders, tensorize as tz
from pctd_tpu_torch.train import trainer
from tests.torch_port_helpers import JAX_TINY, TINY, raw_segments

SHIFTS = np.arange(-6, 6, dtype=np.int32)


def test_batch_features_equal_jax_for_every_shift():
    pr, chord = raw_segments(len(SHIFTS), seed=0)
    x, c, pr_mat, _ = jtrainer.batch_features(
        jnp.asarray(pr), jnp.asarray(chord), jnp.asarray(SHIFTS), JAX_TINY)
    tx, tc, tpr, dt_x = trainer.batch_features(
        torch.from_numpy(pr), torch.from_numpy(chord),
        torch.from_numpy(SHIFTS), TINY)
    assert dt_x is None     # the conv texture encoder reads no detrend
    assert tx.dtype == torch.int32 and tx.shape == (12, 32, 16, 6)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
    np.testing.assert_array_equal(tpr.numpy(), np.asarray(pr_mat))


@pytest.mark.parametrize("seed", [1, 2])
def test_tensorize_pieces_equal_jax(seed):
    rng = np.random.RandomState(seed)
    pr, chord = raw_segments(8, seed=seed)
    shift = rng.randint(-6, 6, 8).astype(np.int32)
    tpr, tsh = torch.from_numpy(pr.astype(np.int32)), torch.from_numpy(shift)
    rolled = tz.shift_pr(tpr, tsh)
    np.testing.assert_array_equal(
        rolled.numpy(), np.asarray(jtz.shift_pr(jnp.asarray(pr, jnp.int32),
                                                jnp.asarray(shift))))
    # a dense duration matrix overflows the 14 note slots of a frame
    dense = rng.randint(0, 9, (2, 32, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        tz.dur_matrix_to_grid(torch.from_numpy(dense)).numpy(),
        np.asarray(jtz.dur_matrix_to_grid(jnp.asarray(dense))))
    np.testing.assert_array_equal(
        tz.pr_to_dur_matrix(rolled).numpy(),
        np.asarray(jtz.pr_to_dur_matrix(jnp.asarray(rolled.numpy()))))
    np.testing.assert_array_equal(
        tz.expand_chord_batch(torch.from_numpy(chord), tsh).numpy(),
        np.asarray(jtz.expand_chord_batch(jnp.asarray(chord),
                                          jnp.asarray(shift))))


def _jcorpus(pr, chord):
    n = len(pr)
    return JCorpus(pr=pr, mel=np.zeros((n, 32, 130), np.uint8), chord=chord,
                   song_id=np.zeros(n, np.int32), bar_pos=np.zeros(n, np.int32))


def test_loaders_yield_the_jax_batches():
    pr, chord = raw_segments(10, seed=3)
    vpr, vchord = raw_segments(3, seed=4)
    jtrain, jval = jloaders.make_loaders(_jcorpus(pr, chord),
                                         _jcorpus(vpr, vchord), 16, seed=5)
    ttrain, tval = loaders.make_loaders(
        loaders.SegmentCorpus(pr, chord), loaders.SegmentCorpus(vpr, vchord),
        16, seed=5)
    assert len(ttrain) == len(jtrain) == 7 and tval.batch_size == 3
    for _ in range(2):                        # two epochs: the shuffle moves
        for a, b in zip(ttrain.epoch(), jtrain.epoch()):
            for k in ("pr", "chord", "shift"):
                np.testing.assert_array_equal(a[k], b[k])
    vb = list(tval.epoch())
    assert len(vb) == 1 and (vb[0]["shift"] == 0).all()
    np.testing.assert_array_equal(vb[0]["pr"], next(jval.epoch())["pr"])
