"""The port's logits-out training path against the JAX package at tiny
width on the CPU: the teacher-forced ``decode``, ``run`` and the parameter
gradients of ``loss(fused_loss=False)``, against the JAX functions with
``train_frame_kernel=True`` (the Pallas frame kernels in interpret mode).
The noise and teacher coins are the JAX key splits' draws, handed to the
port as inputs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models import pianotree_decoder as jptd
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import pianotree_decoder as tptd
from tests.test_torch_port_training import B, BETA, TFR, _case, _named
from tests.torch_port_helpers import JAX_TINY, TINY, jax_noise, jax_params, \
    port_params

JAX_LOGITS = dataclasses.replace(JAX_TINY, train_frame_kernel=True,
                                 fused_loss=False)
LOGITS = dataclasses.replace(TINY, fused_loss=False)


def _noise(noise_np):
    return tdv.Noise(*(torch.from_numpy(a) for a in noise_np))


@pytest.fixture(scope="module")
def case():
    jp = jax_params(seed=1)
    x, c, pr_mat = _case()
    key = jax.random.PRNGKey(7)
    return jp, x, c, pr_mat, key, jax_noise(key, JAX_TINY, B, *TFR)


def test_teacher_forced_decode_matches_jax(case):
    jp, x, _, _, _, noise = case
    _, _, coins1, coins2, _ = noise
    z = np.random.RandomState(3).randn(B, TINY.z_dim).astype(np.float32)
    jx_emb, jlens = jptd.emb_x(jp["dec"], x, JAX_TINY.pianotree)
    want = jptd.decode(jp["dec"], JAX_LOGITS, z, jx_emb, jlens, coins1,
                       coins2)
    dec = port_params(jp)["dec"]
    x_emb, lens = tptd.emb_x(dec, torch.from_numpy(x), TINY.pianotree)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    got = tptd.decode(dec, TINY, torch.from_numpy(z), x_emb, lens,
                      torch.from_numpy(coins1), torch.from_numpy(coins2))
    spec = TINY.pianotree
    assert got.pitch_logits.shape == (B, spec.num_step,
                                      spec.max_simu_note - 1,
                                      spec.pitch_range)
    assert got.dur_logits.shape == (B, spec.num_step,
                                    spec.max_simu_note - 1,
                                    spec.dur_width, 2)
    np.testing.assert_allclose(got.pitch_logits.numpy(),
                               np.asarray(want.pitch_logits), atol=1e-5)
    np.testing.assert_allclose(got.dur_logits.numpy(),
                               np.asarray(want.dur_logits), atol=1e-5)


def test_run_matches_jax(case):
    jp, x, c, pr_mat, key, noise = case
    want = jdv.run(jp, JAX_LOGITS, key, x, c, pr_mat, None, *TFR)
    params = port_params(jp)
    got = tdv.run(params, LOGITS, torch.from_numpy(x), torch.from_numpy(c),
                  torch.from_numpy(pr_mat), _noise(noise))
    again = tdv.DisentangleVAE(LOGITS, params).run(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(pr_mat),
        _noise(noise))
    assert torch.equal(again[0].pitch_logits, got[0].pitch_logits)
    out, jout = got[0], want[0]
    np.testing.assert_allclose(out.pitch_logits.numpy(),
                               np.asarray(jout.pitch_logits), atol=1e-5)
    np.testing.assert_allclose(out.dur_logits.numpy(),
                               np.asarray(jout.dur_logits), atol=1e-5)
    for name, a, b in (("dist_chd", got[1], want[1]),
                       ("dist_rhy", got[2], want[2])):
        np.testing.assert_allclose(a.mean.numpy(), np.asarray(b.mean),
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a.std.numpy(), np.asarray(b.std),
                                   atol=1e-5, err_msg=name)
    for name, a, b in zip(("root", "chroma", "bass"), got[3:], want[3:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=name)


def test_logits_out_loss_and_param_grads_match_jax(case):
    jp, x, c, pr_mat, key, noise = case
    (_, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jdv.loss(p, JAX_LOGITS, key, x, c, pr_mat, None, *TFR,
                           beta=BETA), has_aux=True)(jp)
    params = port_params(jp)
    leaves = _named(params)
    for v in leaves.values():
        v.requires_grad_(True)
    total, metrics = tdv.loss(params, LOGITS, torch.from_numpy(x),
                              torch.from_numpy(c), torch.from_numpy(pr_mat),
                              _noise(noise), beta=BETA)
    for name in tdv.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].item(),
                                   float(jmetrics[name]), rtol=1e-5,
                                   err_msg=name)
    total.backward()
    want = _named(jgrads)
    assert sorted(want) == sorted(leaves)
    for name, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[name]),
                                   atol=2e-4, err_msg=name)
