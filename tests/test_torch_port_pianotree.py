"""The PianoTree texture-encoder variant of the port against the JAX
package on the CPU at tiny width, on the same weights (``params_from_jax``)
and inputs: the encoder, ``encode`` with the detrended grid, the loss and
its 11 metrics (against the JAX loss through the Pallas frame kernels in
interpret mode and through the XLA path), the parameter gradients, and the
bf16 loss; the Sampler's workflows and the serving CLIs refuse the
variant."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu import config as jcfg
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models import texture_encoder as jtxt
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import texture_encoder as ttxt
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.gru import GRUParams
from pctd_tpu_torch.utils.weights import export_params
from tests.test_torch_port_training import _named
from tests.torch_port_helpers import jax_noise, jax_params, port_params, \
    raw_segments

JCFG = jcfg.tiny_model_config(txt_encoder="pianotree")
CFG = tcfg.tiny_model_config(txt_encoder="pianotree")
B = 3
TFR = (0.5, 0.5, 0.5)
BETA = 0.1


def _case(seed=0):
    pr, chord = raw_segments(B, seed=seed)
    shift = np.array([-5, 0, 3], np.int32)
    out = jtrainer.batch_features(jnp.asarray(pr), jnp.asarray(chord),
                                  jnp.asarray(shift), JCFG)
    return tuple(np.array(a) for a in out)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.fixture(scope="module")
def case():
    jp = jax_params(JCFG, seed=1)
    x, c, pr_mat, dt_x = _case()
    key = jax.random.PRNGKey(7)
    return jp, x, c, pr_mat, dt_x, key, jax_noise(key, JCFG, B, *TFR)


def _port_loss(params, cfg, x, c, pr_mat, dt_x, noise_np):
    noise = tdv.Noise(*_t(*noise_np))
    return tdv.loss(params, cfg, *_t(x, c, pr_mat), noise, beta=BETA,
                    dt_x=torch.from_numpy(dt_x))


@pytest.mark.parametrize("seed", [0, 4])
def test_apply_pianotree_matches_jax(seed):
    jp = jax_params(JCFG, seed=1)["txt_enc"]
    *_, dt_x = _case(seed)
    lengths = np.asarray(jtxt.lengths_from_detrended(jnp.asarray(dt_x)))
    got_len = ttxt.lengths_from_detrended(torch.from_numpy(dt_x))
    assert got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_len.numpy(), lengths)
    assert len(np.unique(lengths)) >= 3
    want = jax.jit(jtxt.apply_pianotree)(jp, jnp.asarray(dt_x),
                                          jnp.asarray(lengths))
    got = ttxt.apply_pianotree(port_params(jp), torch.from_numpy(dt_x),
                               got_len)
    for g, w in ((got.mean, want.mean), (got.std, want.std)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_the_variant_params_carry_across():
    """init_params draws the variant's encoder with the JAX tree's names
    and shapes; params_from_jax carries its GRUs and dense leaves, and
    export_params carries them back bit for bit."""
    jp = jax_params(JCFG, seed=1)
    mine = tdv.init_params(CFG, seed=0, device="cpu")
    assert sorted(mine["txt_enc"]) == sorted(jp["txt_enc"]) == [
        "mu", "note_emb", "notes_bwd", "notes_fwd", "std", "time_bwd",
        "time_fwd"]
    shapes = lambda tree: {k: tuple(v.shape) for k, v in _named(tree).items()}
    assert shapes(mine) == shapes(jp)
    tp = port_params(jp)
    for k in ("notes_fwd", "notes_bwd", "time_fwd", "time_bwd"):
        assert isinstance(tp["txt_enc"][k], GRUParams)
    back = _named(export_params(tp))
    for name, arr in _named(jp).items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_encode_takes_the_detrended_grid(case):
    jp, x, c, pr_mat, dt_x, *_ = case
    j_chd, j_rhy = jdv.encode(jp, JCFG, jnp.asarray(pr_mat), jnp.asarray(c),
                              jnp.asarray(dt_x))
    t_chd, t_rhy = tdv.encode(port_params(jp), CFG, *_t(pr_mat, c, dt_x))
    for got, want in ((t_chd, j_chd), (t_rhy, j_rhy)):
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   atol=1e-5)
        np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std),
                                   atol=1e-5)


@pytest.mark.parametrize("path", ["kernel_interpret", "xla"])
def test_loss_matches_jax(case, path):
    jp, x, c, pr_mat, dt_x, key, noise = case
    cfg = dataclasses.replace(JCFG, train_frame_kernel=path != "xla")
    jtotal, jmetrics = jdv.loss(jp, cfg, key, x, c, pr_mat, dt_x, *TFR,
                                beta=BETA)
    total, metrics = _port_loss(port_params(jp), CFG, x, c, pr_mat, dt_x,
                                noise)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for name in tdv.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].item(),
                                   float(jmetrics[name]), rtol=1e-5,
                                   err_msg=name)


def test_param_grads_match_jax(case):
    jp, x, c, pr_mat, dt_x, key, noise = case
    jgrads = jax.jit(jax.grad(lambda p: jdv.loss(
        p, JCFG, key, x, c, pr_mat, dt_x, *TFR, beta=BETA)[0]))(jp)
    params = port_params(jp)
    leaves = _named(params)
    for v in leaves.values():
        v.requires_grad_(True)
    total, _ = _port_loss(params, CFG, x, c, pr_mat, dt_x, noise)
    total.backward()
    want = _named(jgrads)
    assert sorted(want) == sorted(leaves)
    for name, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[name]),
                                   atol=2e-4, err_msg=name)


def test_bf16_loss_matches_jax(case):
    """The bf16 policy casts the detrended grid with the params; the
    variant's bf16 metrics match the JAX bf16 XLA loss within the bf16
    loss parity's bar (1.4e-4 relative)."""
    jp, x, c, pr_mat, dt_x, key, noise = case
    jb = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    jmetrics = jax.jit(lambda p: jdv.loss(p, jb, key, x, c, pr_mat, dt_x,
                                          *TFR, beta=BETA)[1])(jp)
    _, metrics = _port_loss(port_params(jp), dataclasses.replace(
        CFG, compute_dtype="bfloat16"), x, c, pr_mat, dt_x, noise)
    for name in tdv.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].item(),
                                   float(jmetrics[name]), rtol=1.4e-4,
                                   err_msg=name)


def test_serving_refuses_the_variant_and_training_takes_it():
    """The Sampler's workflows (the JAX signatures: no detrended grid) and
    the serving CLIs refuse the variant; its Sampler builds and decodes,
    and the disentangle_vae workflows take dt_x
    (tests/test_torch_port_pianotree_serving.py)."""
    from pctd_tpu_torch.cli import serve

    tcfg.check_config(CFG)
    tcfg.check_config(CFG, "full")
    params = tdv.init_params(CFG, seed=0, device="cpu")
    sampler = Sampler(params, CFG, device="cpu")
    pr = np.zeros((1, 32, 128), np.float32)
    c = np.zeros((1, 8, 36), np.float32)
    with pytest.raises(ValueError, match="pianotree"):
        sampler.swap(pr, pr, c, c, True, True)
    z = torch.zeros(1, CFG.chd_z_dim)
    assert tdv.decode_z(params, CFG, z, z).shape == (1, 32, 15, 6)
    with pytest.raises(ValueError, match="detrended grid"):
        serve.main(["--device", "cpu"], model_config=CFG)
    with pytest.raises(ValueError, match="texture encoder"):
        tcfg.check_config(dataclasses.replace(CFG, txt_encoder="rnn"))
