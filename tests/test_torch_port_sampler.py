"""The port's Sampler and latent-control workflows against the JAX package
on the same weights, inputs and noise (CPU, tiny dims)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models.sampler import Sampler

from tests.torch_port_helpers import (JAX_TINY, TINY, jax_params,
                                      port_params, requests, t)


@pytest.fixture(scope="module")
def weights():
    jp = jax_params(seed=7)
    return jp, port_params(jp)


def test_interp_path_matches_jax():
    rng = np.random.RandomState(0)
    for z1, z2 in ((rng.randn(16), rng.randn(16)),
                   (np.ones(4), np.ones(4) * 3.0)):     # parallel: lerp
        np.testing.assert_allclose(tdv.interp_path(z1, z2, 7),
                                   jdv.interp_path(z1, z2, 7), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 5, 9])
def test_fixed_batch_padding_and_chunking_match_unpadded(weights, n):
    _, tp = weights
    pr, c = requests(n, seed=n)
    fixed = Sampler(tp, TINY, fixed_batch=4, device="cpu")
    free = Sampler(tp, TINY, device="cpu")
    a_chd, a_rhy = fixed.encode(pr, c)
    b_chd, b_rhy = free.encode(pr, c)
    for a, b in zip(a_chd + a_rhy, b_chd + b_rhy):
        assert a.shape == b.shape == (n, a.shape[-1])
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    got = fixed.swap(pr, pr, c, c, fix_rhy=True, fix_chd=True)
    assert got.shape == (n, 32, 15, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, free.reconstruct(pr, c))


def _noise(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_decode(jp, zc, zr):
    return np.asarray(jdv.decode_z(jp, JAX_TINY, jnp.asarray(zc),
                                   jnp.asarray(zr)))


@pytest.mark.parametrize("workflow", ["swap_fix_rhy", "swap_fix_chd",
                                      "posterior_sample", "prior_sample",
                                      "interp"])
def test_workflow_matches_jax(weights, workflow):
    """Each workflow gives the JAX package's grid when both get the same z:
    deterministic workflows directly, sampling ones through the same
    numpy noise (the port draws from a torch.Generator, whose draws the
    Sampler's own call is checked against)."""
    jp, tp = weights
    pr1, c1 = requests(3, seed=11)
    pr2, c2 = requests(3, seed=12)
    s = Sampler(tp, TINY, fixed_batch=2, device="cpu")
    if workflow.startswith("swap"):
        fix_rhy = workflow == "swap_fix_rhy"
        got = s.swap(pr1, pr2, c1, c2, fix_rhy=fix_rhy, fix_chd=not fix_rhy)
        want = np.asarray(jdv.swap(jp, JAX_TINY, jnp.asarray(pr1),
                                   jnp.asarray(pr2), jnp.asarray(c1),
                                   jnp.asarray(c2), fix_rhy, not fix_rhy))
        np.testing.assert_array_equal(got, want)
        return
    if workflow == "interp":
        got = s.interp(pr1, c1, pr2, c2, interp_chd=True, int_count=3)
        want = jdv.interp(jp, JAX_TINY, jnp.asarray(pr1), jnp.asarray(c1),
                          jnp.asarray(pr2), jnp.asarray(c2),
                          interp_chd=True, int_count=3)
        assert got.shape == (3, 3, 32, 15, 6)
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    # the same noise on both sides: eps_chd, eps_rhy
    e_chd = _noise((3, TINY.chd_z_dim), 1)
    e_rhy = _noise((3, TINY.txt_z_dim), 2)
    j_chd, j_rhy = jdv.encode(jp, JAX_TINY, jnp.asarray(pr1),
                              jnp.asarray(c1))
    t_chd, t_rhy = s.encode(pr1, c1)
    if workflow == "posterior_sample":
        scale = 0.5
        zc = lambda d, e: d.mean + d.std * scale * e
        zr = zc
        call = lambda g: s.posterior_sample(g, pr1, c1, scale=scale)
    else:
        zc = lambda d, e: d.mean + d.std * e
        zr = lambda d, e: e * 1.0
        call = lambda g: s.prior_sample(g, pr1, c1, sample_rhy=True)
    want = _jax_decode(jp, zc(j_chd, e_chd), zr(j_rhy, e_rhy))
    got = s.decode(zc(t_chd, t(e_chd)), zr(t_rhy, t(e_rhy)))
    np.testing.assert_array_equal(got, want)
    # the Sampler's own call draws eps_chd then eps_rhy from its generator
    g = torch.Generator().manual_seed(3)
    eps = torch.Generator().manual_seed(3)
    draws = (torch.randn(t_chd.mean.shape, generator=eps),
             torch.randn(t_rhy.mean.shape, generator=eps))
    np.testing.assert_array_equal(
        call(g), s.decode(zc(t_chd, draws[0]), zr(t_rhy, draws[1])))


def test_functional_api_matches_sampler(weights):
    """The pure-function workflows compute what the Sampler serves."""
    _, tp = weights
    pr1, c1 = requests(2, seed=21)
    pr2, c2 = requests(2, seed=22)
    s = Sampler(tp, TINY, device="cpu")
    np.testing.assert_array_equal(
        tdv.swap(tp, TINY, t(pr1), t(pr2), t(c1), t(c2), False, True)
        .numpy(),
        s.swap(pr1, pr2, c1, c2, fix_rhy=False, fix_chd=True))
    np.testing.assert_array_equal(
        tdv.interp(tp, TINY, t(pr1), t(c1), t(pr2), t(c2), interp_rhy=True,
                   int_count=2),
        s.interp(pr1, c1, pr2, c2, interp_rhy=True, int_count=2))
    for name in ("posterior_sample", "prior_sample"):
        a = getattr(tdv, name)(tp, TINY, torch.Generator().manual_seed(5),
                               t(pr1), t(c1))
        b = getattr(s, name)(torch.Generator().manual_seed(5), pr1, c1)
        np.testing.assert_array_equal(a.numpy(), b)


def test_sampler_rejects_bad_arguments(weights):
    _, tp = weights
    with pytest.raises(ValueError):
        Sampler(tp, TINY, frame_decoder="xla", device="cpu")
    with pytest.raises(ValueError):
        Sampler(tp, TINY, fixed_batch=0, device="cpu")
    with pytest.raises(ValueError):
        Sampler(tp, TINY, device="cpu").decode(np.zeros((0, 8)),
                                               np.zeros((0, 8)))
