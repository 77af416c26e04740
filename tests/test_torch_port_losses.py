"""The port's losses, KL, chord decoder, schedules and optimizer against the
JAX package on the same numpy inputs (CPU)."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pctd_tpu import config as jcfg
from pctd_tpu.models import chord_decoder as jchd
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models import pianotree_decoder as jptd
from pctd_tpu.ops import DiagNormal as JDiagNormal
from pctd_tpu.ops import kl_std_normal as j_kl
from pctd_tpu.ops import losses as jl
from pctd_tpu.train import schedules as jsched
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.models import chord_decoder as tchd
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import pianotree_decoder as tptd
from pctd_tpu_torch.ops import DiagNormal, kl_std_normal
from pctd_tpu_torch.ops import losses as tl
from pctd_tpu_torch.train import optim, schedules
from tests.torch_port_helpers import JAX_TINY, TINY, jax_params, \
    port_params, t

RTOL = 1e-6


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach")
                                          else a), np.asarray(b),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("ignore", [None, 2, 130])
def test_cross_entropy_matches_jax(ignore):
    rng = np.random.RandomState(0)
    C = 131 if ignore == 130 else 3
    logits = rng.randn(4, 6, C).astype(np.float32) * 3
    targets = rng.randint(0, C, (4, 6)).astype(np.int32)
    if ignore is None:
        _close(tl.cross_entropy_mean(t(logits), torch.from_numpy(targets)),
               jl.cross_entropy_mean(logits, targets))
        return
    targets[0] = ignore
    num, den = tl.masked_ce_parts(t(logits), torch.from_numpy(targets),
                                  ignore)
    assert int(den) == int((targets != ignore).sum())
    _close(num / den, jl.cross_entropy_ignore(logits, targets, ignore))
    _close(tl.cross_entropy_ignore(t(logits), torch.from_numpy(targets),
                                   ignore),
           jl.cross_entropy_ignore(logits, targets, ignore))


def test_all_ignored_gives_zero():
    logits = torch.zeros(2, 3)
    assert tl.cross_entropy_ignore(logits, torch.full((2,), 2), 2) == 0


def test_kl_and_reparameterised_sample_match_jax():
    rng = np.random.RandomState(1)
    mu = rng.randn(5, 7).astype(np.float32)
    std = np.exp(rng.randn(5, 7).astype(np.float32) * 0.3)
    eps = rng.randn(5, 7).astype(np.float32)
    _close(kl_std_normal(DiagNormal(t(mu), t(std))),
           j_kl(JDiagNormal(mu, std)), rtol=2e-6)
    _close(DiagNormal(t(mu), t(std)).rsample_eps(t(eps)), mu + std * eps)


@pytest.mark.parametrize("weighted_dur", [False, True])
def test_recon_loss_matches_jax(weighted_dur):
    spec = TINY.pianotree
    rng = np.random.RandomState(2)
    B, T, K, W, P = 2, 32, 16, 5, spec.pitch_range
    x = np.zeros((B, T, K, 6), np.int32)
    x[..., 0] = rng.randint(0, P + 1, (B, T, K))
    x[..., 1:] = rng.randint(0, 3, (B, T, K, W))
    pitch = rng.randn(B, T, K - 1, P).astype(np.float32)
    dur = rng.randn(B, T, K - 1, W, 2).astype(np.float32)
    got = tptd.recon_loss(torch.from_numpy(x),
                          tptd.DecoderOutput(t(pitch), t(dur)), spec,
                          weighted_dur=weighted_dur)
    want = jptd.recon_loss(x, jptd.DecoderOutput(pitch, dur),
                           JAX_TINY.pianotree, weighted_dur=weighted_dur)
    for a, b in zip(got, want):
        _close(a, b, rtol=2e-6)


def test_chord_decoder_and_chord_loss_match_jax():
    jp = jax_params()
    tp = port_params(jp)
    rng = np.random.RandomState(3)
    B = 4
    z = rng.randn(B, TINY.chd_z_dim).astype(np.float32)
    c = np.zeros((B, 8, 36), np.float32)
    c[np.arange(B)[:, None], np.arange(8), rng.randint(0, 12, (B, 8))] = 1
    c[..., 12:24] = rng.randint(0, 2, (B, 8, 12))
    c[np.arange(B)[:, None], np.arange(8), 24 + rng.randint(0, 12, (B, 8))] = 1
    coins = rng.rand(8) < 0.5
    got = tchd.apply(tp["chd_dec"], t(z), t(c), torch.from_numpy(coins))
    want = jchd.apply(jp["chd_dec"], z, c, coins)
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5, atol=1e-6)
    _close(tdv.chord_loss(t(c), *got)[0], jdv.chord_loss(c, *want)[0],
           rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 3, 100])
@pytest.mark.parametrize("horizon", [1.0, 50.0])
def test_schedules_and_lr_match_jax(step, horizon):
    import dataclasses

    cfg = dataclasses.replace(jcfg.TrainConfig(), sched_horizon=horizon,
                              lr_decay=0.9)
    pcfg = tcfg.TrainConfig(**dataclasses.asdict(cfg))
    want = jsched.train_params_at(jnp.asarray(step), cfg)
    got = schedules.train_params_at(step, pcfg)
    for k in want:
        _close(got[k], want[k], rtol=1e-6)
    _close(schedules.lr_at(step, pcfg),
           jsched.lr_schedule(cfg)(jnp.asarray(step)), rtol=1e-6)
    assert schedules.final_params(pcfg) == jsched.final_params(cfg)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_clip_and_adam_match_optax(clip):
    """Three updates on identical gradients (one clipped, one not)."""
    import dataclasses

    jc = dataclasses.replace(jcfg.TrainConfig(), clip_norm=clip,
                             lr_decay=0.5, lr_min=1e-4)
    pc = tcfg.TrainConfig(**dataclasses.asdict(jc))
    rng = np.random.RandomState(4)
    params = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    tx = jsched.make_optimizer(jc)
    jstate = tx.init(params)
    jp = list(params)
    tp = [t(p) for p in params]
    opt = optim.Adam(tp, pc)
    for i in range(3):
        grads = [rng.randn(*p.shape).astype(np.float32) * (i + 1)
                 for p in params]
        upd, jstate = tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([t(g) for g in grads])
        _close(norm, optax.global_norm(grads), rtol=1e-6, atol=0)
        for a, b in zip(tp, jp):
            _close(a, b, rtol=0, atol=1e-6)
    assert opt.count == 3
