"""Shared fixtures for the pctd_tpu_torch tests: the same weights and inputs
for the JAX package and the port, made from seeds with numpy."""
import copy
import functools

import jax
import numpy as np
import torch

from pctd_tpu import config as jcfg
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.utils.weights import params_from_jax

JAX_TINY = jcfg.tiny_model_config()
TINY = tcfg.tiny_model_config()


@functools.lru_cache(maxsize=None)
def _jax_init(cfg, seed):
    # one compiled program: eager init compiles every random op on its own
    tree = jax.jit(jdv.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params(cfg=JAX_TINY, seed=0):
    """The JAX package's parameter tree as numpy leaves (a fresh copy)."""
    return copy.deepcopy(_jax_init(cfg, seed))


def port_params(jp):
    return params_from_jax(jp, "cpu")


def with_eos_bias(jp, offset, eos=129):
    """A copy of ``jp`` whose pitch head favours eos by ``offset``, so frame
    lengths spread below 15 and the masked summary is exercised."""
    q = copy.deepcopy(jp)
    q["dec"]["pitch_out"]["b"][eos] += np.float32(offset)
    return q


def eos_biased(jp, offset, lengths_of):
    """The eos-biased variant of ``jp`` (see :func:`with_eos_bias`); with
    random weights no eos occurs, and the tests' offsets spread the frame
    lengths of their inputs, which this checks."""
    q = with_eos_bias(jp, offset)
    assert len(np.unique(lengths_of(q))) >= 3
    return q


def requests(B, seed):
    """Synthetic (pr_mat (B, 32, 128), chord (B, 8, 36)) float32 inputs:
    sparse onsets with durations 1..8, and root / chroma / bass chords."""
    rng = np.random.RandomState(seed)
    pr = np.zeros((B, 32, 128), np.float32)
    on = rng.rand(B, 32, 128) < 0.02
    pr[on] = rng.randint(1, 9, on.sum())
    c = np.zeros((B, 8, 36), np.float32)
    rows = np.arange(B)[:, None]
    steps = np.arange(8)[None, :]
    c[rows, steps, rng.randint(0, 12, (B, 8))] = 1.0
    c[..., 12:24] = rng.randint(0, 2, (B, 8, 12))
    c[rows, steps, 24 + rng.randint(0, 12, (B, 8))] = 1.0
    return pr, c


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def raw_segments(B, seed):
    """Synthetic raw segments in the loader's format: pr (B, 32, 128) uint8
    onset (2) / sustain (1) / rest (0) rolls and chord (B, 8, 14) float32
    [root, chroma (12), bass] rows."""
    rng = np.random.RandomState(seed)
    pr = np.zeros((B, 32, 128), np.uint8)
    pr[rng.rand(B, 32, 128) < 0.03] = 2
    for step in range(1, 32):
        held = ((pr[:, step - 1] > 0) & (pr[:, step] == 0)
                & (rng.rand(B, 128) < 0.6))
        pr[:, step][held] = 1
    chord = np.zeros((B, 8, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (B, 8))
    chord[..., 1:13] = rng.randint(0, 2, (B, 8, 12))
    chord[..., 13] = rng.randint(0, 12, (B, 8))
    return pr, chord


def jax_noise(key, cfg, B, tfr1, tfr2, tfr3):
    """The latent noise and teacher coins the JAX loss draws from ``key``
    (``disentangle_vae._forward_parts`` and ``pianotree_decoder.draw_coins``
    key splits), as numpy arrays for the port's ``Noise``."""
    from pctd_tpu.models import pianotree_decoder as jptd

    k_chd, k_rhy, k_coins, k_coin3 = jax.random.split(key, 4)
    eps_chd = jax.random.normal(k_chd, (B, cfg.chd_z_dim), np.float32)
    eps_rhy = jax.random.normal(k_rhy, (B, cfg.txt_z_dim), np.float32)
    coins1, coins2 = jptd.draw_coins(k_coins, cfg, tfr1, tfr2)
    coins3 = jax.random.uniform(k_coin3, (cfg.chord.num_step,)) < tfr3
    return tuple(np.array(a) for a in (eps_chd, eps_rhy, coins1, coins2,
                                       coins3))
