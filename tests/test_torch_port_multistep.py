"""Three train steps of the port's Trainer against three JAX train steps at
tiny width on the CPU, in both loss modes: tensorize, the loss (the JAX side
through its Pallas frame kernels in interpret mode), the gradients and clip
+ Adam, step after step from the same weights. Each step's noise and
teacher coins are the JAX step key's draws, handed to the port in place of
its own generator's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu import config as jcfg
from pctd_tpu.train import schedules as jschedules
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.train import trainer
from pctd_tpu_torch.utils.weights import export_params, params_from_jax
from tests.test_torch_port_training import _named
from tests.torch_port_helpers import JAX_TINY, TINY, jax_noise, jax_params, \
    raw_segments

B, STEPS = 3, 3
# teacher forcing high throughout the three steps, so both coin branches run
TRAIN = dict(batch_size=B, accum_steps=1, sched_horizon=1e4,
             tf_rates=((0.6, 0.0), (0.5, 0.0), (0.5, 0.0)))


def _batches():
    out = []
    for i in range(STEPS):
        pr, chord = raw_segments(B, seed=20 + i)
        shift = np.array([-2 + i, 0, 3 - i], np.int32)
        out.append({"pr": pr, "chord": chord, "shift": shift})
    return out


def _jax_steps(jp, cfg, batches, base_key):
    jt = jcfg.TrainConfig(**TRAIN)
    tx = jschedules.make_optimizer(jt)
    grad_fn, update_fn = jtrainer._train_fns(cfg, jt, tx)
    grad_fn = jax.jit(grad_fn)
    state = jtrainer.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32),
                                base_key)
    rows = []
    for batch in batches:
        x, c, pr_mat, dt_x = jtrainer.batch_features(
            jnp.asarray(batch["pr"]), jnp.asarray(batch["chord"]),
            jnp.asarray(batch["shift"]), cfg)
        key = jax.random.fold_in(state.key, state.step)
        metrics, grads = grad_fn(state.params, state.step, key, x, c,
                                 pr_mat, dt_x)
        state = update_fn(state, grads)
        rows.append({k: float(v) for k, v in metrics.items()})
    return rows, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("fused_loss", [True, False])
def test_three_train_steps_match_jax(fused_loss, monkeypatch):
    jp = jax_params(seed=6)
    batches = _batches()
    base_key = jax.random.PRNGKey(11)
    jrows, jparams = _jax_steps(
        jp, dataclasses.replace(JAX_TINY, train_frame_kernel=True,
                                fused_loss=fused_loss), batches, base_key)

    run = trainer.Trainer(dataclasses.replace(TINY, fused_loss=fused_loss),
                          tcfg.TrainConfig(**TRAIN), None, device="cpu",
                          params=params_from_jax(jp, "cpu"))

    def jax_step_noise(gen, cfg, batch, tfr1, tfr2, tfr3):
        # the Trainer's scheduled rates are 0-d tensors of the step's
        # scalars
        assert batch == B
        key = jax.random.fold_in(base_key, run.step_count)
        return tdv.Noise(*(torch.from_numpy(a) for a in jax_noise(
            key, JAX_TINY, B, *(float(t) for t in (tfr1, tfr2, tfr3)))))

    monkeypatch.setattr(trainer.dv, "draw_noise", jax_step_noise)
    for step, (batch, want) in enumerate(zip(batches, jrows)):
        got = run.train_step(batch)
        for name in tdv.METRIC_NAMES:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       err_msg=f"step {step + 1} {name}")
    got = _named(export_params(run.params))
    want = _named(jparams)
    assert sorted(got) == sorted(want)
    for name, arr in got.items():
        np.testing.assert_allclose(arr, want[name], atol=2e-4, err_msg=name)
