"""The port's training path against the JAX package at tiny width on the
CPU: the whole-VAE loss and its 11 metrics (against the JAX loss through the
Pallas frame kernels in interpret mode and through the XLA path, in both
loss modes), the eval step (the parameter gradients are in
``test_torch_port_training_grads.py``, the Trainer in
``test_torch_port_trainer.py``). The noise and teacher coins are
the JAX key splits' draws, handed to the port as inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.train import trainer
from tests.torch_port_helpers import JAX_TINY, TINY, jax_noise, jax_params, \
    port_params, raw_segments

B = 3
TFR = (0.5, 0.5, 0.5)
BETA = 0.1


def _case(seed=0):
    pr, chord = raw_segments(B, seed=seed)
    shift = np.array([-3, 0, 4], np.int32)
    x, c, pr_mat, _ = jtrainer.batch_features(
        jnp.asarray(pr), jnp.asarray(chord), jnp.asarray(shift), JAX_TINY)
    return np.array(x), np.array(c), np.array(pr_mat)


def _port_loss(params, x, c, pr_mat, noise_np):
    noise = tdv.Noise(*(torch.from_numpy(a) for a in noise_np))
    return tdv.loss(params, TINY, torch.from_numpy(x), torch.from_numpy(c),
                    torch.from_numpy(pr_mat), noise, beta=BETA)


@pytest.fixture(scope="module")
def case():
    jp = jax_params(seed=1)
    x, c, pr_mat = _case()
    key = jax.random.PRNGKey(7)
    noise = jax_noise(key, JAX_TINY, B, *TFR)
    total, metrics = _port_loss(port_params(jp), x, c, pr_mat, noise)
    return jp, x, c, pr_mat, key, noise, total, metrics


@pytest.mark.parametrize("path", ["kernel_interpret", "xla"])
def test_vae_loss_and_metrics_match_jax(case, path):
    jp, x, c, pr_mat, key, _, total, metrics = case
    cfg = dataclasses.replace(JAX_TINY,
                              train_frame_kernel=path != "xla")
    jtotal, jmetrics = jdv.loss(jp, cfg, key, x, c, pr_mat, None, *TFR,
                                beta=BETA)
    assert list(metrics) == list(jdv.METRIC_NAMES) == list(tdv.METRIC_NAMES)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=2e-5)
    for name in tdv.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].item(),
                                   float(jmetrics[name]), rtol=2e-5,
                                   err_msg=name)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in tree
                for n, v in _named(tree[k], f"{prefix}/{k}").items()}
    if hasattr(tree, "_fields"):
        return _named(tree._asdict(), prefix)
    return {prefix: tree}


@pytest.mark.parametrize("fused_loss", [True, False])
def test_loss_matches_jax_in_both_modes(case, fused_loss):
    """Loss mode (CE fused into the frame kernels) and logits out (the
    frame kernels' logits scored by recon_loss) each equal the JAX loss in
    the same mode, through its Pallas frame kernels in interpret mode."""
    jp, x, c, pr_mat, key, noise, _, _ = case
    total, metrics = tdv.loss(
        port_params(jp), dataclasses.replace(TINY, fused_loss=fused_loss),
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(pr_mat),
        tdv.Noise(*(torch.from_numpy(a) for a in noise)), beta=BETA)
    cfg = dataclasses.replace(JAX_TINY, train_frame_kernel=True,
                              fused_loss=fused_loss)
    jtotal, jmetrics = jdv.loss(jp, cfg, key, x, c, pr_mat, None, *TFR,
                                beta=BETA)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for name in tdv.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].item(),
                                   float(jmetrics[name]), rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("fixed", [False, True])
def test_eval_metrics_use_the_schedule_asked_for(fixed):
    """The eval step's loss is the training loss, without gradients, at the
    current schedules or, with eval_fixed_schedule, at their end values."""
    from pctd_tpu_torch.train import schedules

    pr, chord = raw_segments(2, seed=8)
    shift = np.array([1, -2], np.int32)
    params = port_params(jax_params(seed=5))
    cfg = tcfg.TrainConfig(batch_size=2, eval_fixed_schedule=fixed)
    got = trainer.eval_metrics(params, TINY, cfg, 0,
                               torch.Generator().manual_seed(3),
                               torch.from_numpy(pr), torch.from_numpy(chord),
                               torch.from_numpy(shift))
    sched = (schedules.final_params(cfg) if fixed
             else schedules.train_params_at(0, cfg))
    x, c, pr_mat, _ = trainer.batch_features(
        torch.from_numpy(pr), torch.from_numpy(chord),
        torch.from_numpy(shift), TINY)
    noise = tdv.draw_noise(torch.Generator().manual_seed(3), TINY, 2,
                           sched["tfr1"], sched["tfr2"], sched["tfr3"])
    _, want = tdv.loss(params, TINY, x, c, pr_mat, noise,
                       beta=sched["beta"])
    for name in tdv.METRIC_NAMES:
        assert got[name].item() == want[name].item(), name
        assert not got[name].requires_grad
