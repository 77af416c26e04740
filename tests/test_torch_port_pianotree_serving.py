"""Serving a model of the PianoTree texture encoder on the CPU at tiny
width, against the JAX package on the same weights and inputs:
``Sampler.encode`` with the detrended grid (unchunked, and chunked with a
partial last chunk) against the JAX ``Sampler.encode``; the
``disentangle_vae`` workflows with ``dt_x`` against the JAX functions,
grids exact (the sampled ones on equal latents); the ``Sampler``'s
workflows, which take no detrended grid, refuse the model; and the variant
at the stretch's 128 steps is refused."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu import config as jcfg
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models.sampler import Sampler as JSampler
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models.sampler import Sampler
from tests.torch_port_helpers import (jax_params, port_params, raw_segments,
                                      t)

JCFG = jcfg.tiny_model_config(txt_encoder="pianotree")
CFG = tcfg.tiny_model_config(txt_encoder="pianotree")


@pytest.fixture(scope="module")
def weights():
    jp = jax_params(JCFG, seed=3)
    return jp, port_params(jp)


def _inputs(n, seed):
    """(pr_mat, c, dt_x) of n raw segments, tensorized by the JAX
    package."""
    pr, chord = raw_segments(n, seed=seed)
    shift = np.arange(n, dtype=np.int32) % 5 - 2
    _, c, pr_mat, dt_x = jtrainer.batch_features(
        jnp.asarray(pr), jnp.asarray(chord), jnp.asarray(shift), JCFG)
    return np.array(pr_mat), np.array(c), np.array(dt_x)


def _jax_decode(jp, zc, zr):
    return np.asarray(jdv.decode_z(jp, JCFG, jnp.asarray(zc),
                                   jnp.asarray(zr)))


@pytest.mark.parametrize("fixed_batch", [None, 2])
def test_sampler_encode_with_dt_x_equals_jax(weights, fixed_batch):
    """3 rows: unchunked, and in chunks of 2 (the last one partial)."""
    jp, tp = weights
    pr_mat, c, dt_x = _inputs(3, seed=0)
    js = JSampler(jp, JCFG, frame_decoder="xla", fixed_batch=fixed_batch)
    want = js.encode(pr_mat, c, dt_x)
    got = Sampler(tp, CFG, fixed_batch=fixed_batch,
                  device="cpu").encode(pr_mat, c, dt_x)
    for g_dist, w_dist in zip(got, want):
        for g, w in zip(g_dist, w_dist):
            assert g.shape == (3, 8)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    with pytest.raises(ValueError, match="dt_x"):
        Sampler(tp, CFG, device="cpu").encode(pr_mat, c)


@pytest.mark.parametrize("workflow", ["swap_fix_rhy", "swap_fix_chd",
                                      "inference", "interp"])
def test_workflows_with_dt_x_equal_jax(weights, workflow):
    jp, tp = weights
    pr1, c1, d1 = _inputs(3, seed=1)
    pr2, c2, d2 = _inputs(3, seed=2)
    j = lambda *a: tuple(jnp.asarray(x) for x in a)
    if workflow.startswith("swap"):
        fix = workflow == "swap_fix_rhy"
        got = tdv.swap(tp, CFG, t(pr1), t(pr2), t(c1), t(c2), fix,
                       not fix, dt_x1=t(d1), dt_x2=t(d2)).numpy()
        want = jdv.swap(jp, JCFG, *j(pr1, pr2, c1, c2), fix, not fix,
                        dt_x1=jnp.asarray(d1), dt_x2=jnp.asarray(d2))
    elif workflow == "inference":
        got = tdv.inference(tp, CFG, t(pr1), t(c1), sample=False,
                            dt_x=t(d1)).numpy()
        want = jdv.inference(jp, JCFG, *j(pr1, c1), sample=False,
                             dt_x=jnp.asarray(d1))
    else:
        got = tdv.interp(tp, CFG, t(pr1), t(c1), t(pr2), t(c2),
                         interp_chd=True, interp_rhy=True, int_count=3,
                         dt_x1=t(d1), dt_x2=t(d2))
        want = jdv.interp(jp, JCFG, *j(pr1, c1, pr2, c2), interp_chd=True,
                          interp_rhy=True, int_count=3,
                          dt_x1=jnp.asarray(d1), dt_x2=jnp.asarray(d2))
        assert got.shape == (3, 3, 32, 15, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("workflow", ["posterior_sample", "prior_sample"])
def test_sampled_workflows_with_dt_x(weights, workflow):
    """A sampled workflow with dt_x decodes the latents its generator's
    draws give, and the JAX decode of those latents is the same grid."""
    jp, tp = weights
    pr, c, dt_x = _inputs(3, seed=4)
    d_chd, d_rhy = tdv.encode(tp, CFG, t(pr), t(c), t(dt_x))
    eps = torch.Generator().manual_seed(9)
    e_chd = torch.randn(d_chd.mean.shape, generator=eps)
    e_rhy = torch.randn(d_rhy.mean.shape, generator=eps)
    if workflow == "posterior_sample":
        got = tdv.posterior_sample(tp, CFG, torch.Generator().manual_seed(9),
                                   t(pr), t(c), scale=0.5, dt_x=t(dt_x))
        zc = d_chd.mean + d_chd.std * 0.5 * e_chd
        zr = d_rhy.mean + d_rhy.std * 0.5 * e_rhy
    else:
        got = tdv.prior_sample(tp, CFG, torch.Generator().manual_seed(9),
                               t(pr), t(c), sample_rhy=True, dt_x=t(dt_x))
        zc = d_chd.mean + d_chd.std * e_chd
        zr = e_rhy * 1.0
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_decode(jp, zc.numpy(), zr.numpy()))


def test_sampler_workflows_refuse_the_variant(weights):
    """The Sampler's workflows keep the JAX signatures (no dt_x) and raise,
    naming the disentangle_vae function that takes it; its decode serves
    the model."""
    jp, tp = weights
    pr, c, _ = _inputs(3, seed=5)
    s = Sampler(tp, CFG, fixed_batch=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    calls = {"swap": lambda: s.swap(pr, pr, c, c, True, False),
             "posterior_sample": lambda: s.posterior_sample(g, pr, c),
             "prior_sample": lambda: s.prior_sample(g, pr, c),
             "interp": lambda: s.interp(pr, c, pr, c, interp_chd=True),
             "inference": lambda: s.reconstruct(pr, c)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"disentangle_vae.{name}"):
            call()
    z = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    np.testing.assert_array_equal(s.decode(z, z), _jax_decode(jp, z, z))


def test_pianotree_at_the_stretch_is_refused():
    cfg = dataclasses.replace(CFG, pianotree=tcfg.PianoTreeSpec(num_step=128),
                              chord=tcfg.ChordSpec(num_step=32))
    for call in (lambda: tcfg.check_config(cfg),
                 lambda: tcfg.check_config(cfg, "full"),
                 lambda: tdv.init_params(cfg, device="cpu")):
        with pytest.raises(ValueError, match="32 steps"):
            call()
    tcfg.check_config(dataclasses.replace(cfg, txt_encoder="conv"), "full")
