"""The port's detrend (the PianoTree texture encoder's input) against the
JAX package's ``detrend_pianotree_jnp`` on the CPU: the torch (device) and
numpy versions give the same (N, 32, 16, 39) features exactly, over every
shift and with an all-zero chord row."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.data.detrend import detrend_pianotree_batch as jdetrend_np
from pctd_tpu.data.detrend import detrend_pianotree_jnp
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch.data import detrend
from tests.torch_port_helpers import JAX_TINY, raw_segments

SHIFTS = np.arange(-6, 6, dtype=np.int32)


def _grid_and_chord(seed):
    """Every shift twice; chord rows with an all-zero root one-hot (the
    argmax takes index 0), an all-zero row and random chroma."""
    pr, chord = raw_segments(2 * len(SHIFTS), seed=seed)
    shift = np.concatenate([SHIFTS, SHIFTS])
    x, c, _, _ = jtrainer.batch_features(jnp.asarray(pr), jnp.asarray(chord),
                                         jnp.asarray(shift), JAX_TINY)
    c = np.array(c)
    c[0, 3, :12] = 0.0
    c[1, 5, :] = 0.0
    return np.array(x), c


@pytest.mark.parametrize("impl", ["torch", "numpy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_detrend_equals_jax(impl, seed):
    x, c = _grid_and_chord(seed)
    want = np.asarray(detrend_pianotree_jnp(jnp.asarray(x), jnp.asarray(c)))
    if impl == "torch":
        got = detrend.detrend_pianotree(torch.from_numpy(x),
                                        torch.from_numpy(c)).numpy()
    else:
        got = detrend.detrend_pianotree_batch(x, c)
    assert got.dtype == np.float32 and got.shape == (24, 32, 16, 39)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jdetrend_np(x, c))


def test_detrend_features_are_one_hot_groups():
    """Each note's five one-hot groups hold exactly one 1, and the zero
    root row reads as root 0: its notes' scale degrees are their pitch
    classes' degrees from C."""
    x, c = _grid_and_chord(2)
    f = detrend.detrend_pianotree(torch.from_numpy(x), torch.from_numpy(c))
    for a, b in ((0, 4), (4, 7), (7, 19), (19, 27), (27, 34)):
        assert torch.all(f[..., a:b].sum(-1) == 1), (a, b)
    beat = f[0].reshape(8, 4, 16, 39)[3]               # row 0, beat 3
    pitch = torch.from_numpy(x[0]).reshape(8, 4, 16, 6)[3][..., 0]
    note = pitch < 128
    deg = torch.as_tensor(detrend.DEG_TABLE)[(pitch % 12).long()]
    assert torch.equal(beat[..., 19:27].argmax(-1)[note], deg[note].long())
