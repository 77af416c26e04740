"""The port's bf16 training loss (``compute_dtype="bfloat16"``) against the
JAX package's at tiny width on the CPU, in both loss modes: the 11 metrics
and the parameter gradients against the JAX loss through its bf16 Pallas
frame kernels in interpret mode, with the JAX key splits' noise and coins
handed to the port.

Tolerances, from the JAX package's own two bf16 paths (Pallas interpret vs
XLA, the same config): metrics 1.4e-4 relative; gradients 2.07e-2
relative L2 and 4.7e-4 in max|err| / (1 + max|ref|), each the maximum
over the leaves. The metrics (measured 1.26e-4) and every leaf's relative
L2 (measured 1.23e-2) are held to those bounds against the JAX gradients
as they are. The scaled max is held against a second JAX reference whose
bf16 sums run in f32 (measured 4.61e-4, on ``chd_dec/gru/w_ih``): XLA's
CPU compiler sums a bf16 reduction (a bias gradient over the batch, the
transpose of a broadcast) with its partial sums rounded to bf16 after
every add, where the Pallas kernels, XLA on an accelerator and the port
sum in f32 and round once. Against the JAX gradients as they are the
scaled max reads 8.7e-4, on ``chd_dec/root/b``; summed in f32 that leaf
reads under 1e-4 and no weight leaf changes. The metrics' gap is the
interpret-mode kernels': XLA keeps the duration GRU's bf16 feedback rows
in f32 there (excess precision); with
``--xla_allow_excess_precision=false`` the metrics agree within 4e-6 (see
``test_torch_port_bf16_frame.py``). The JAX references are compiled, as a
JAX training step runs."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax import lax as jax_lax

from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.train.trainer import param_list
from tests.test_torch_port_training import BETA, TFR, B, _case, _named
from tests.torch_port_helpers import JAX_TINY, TINY, jax_noise, jax_params, \
    port_params

METRICS_RTOL = 1.4e-4
REL_L2 = 2.07e-2
SCALED_MAX = 4.7e-4


def _jax_cfg(fused):
    return dataclasses.replace(JAX_TINY, compute_dtype="bfloat16",
                               train_frame_kernel=True, fused_loss=fused)


def _port_cfg(fused, dtype="bfloat16"):
    return dataclasses.replace(TINY, compute_dtype=dtype, fused_loss=fused)


def _f32_sums(reduce_sum):
    """``lax.reduce_sum`` summing a bf16 operand in f32, rounding once."""
    def summed(x, axes, **kw):
        if x.dtype == jnp.bfloat16:
            return reduce_sum(x.astype(jnp.float32), axes,
                              **kw).astype(jnp.bfloat16)
        return reduce_sum(x, axes, **kw)
    return summed


def _port_loss(params, cfg, x, c, pr_mat, noise):
    return tdv.loss(params, cfg, torch.from_numpy(x), torch.from_numpy(c),
                    torch.from_numpy(pr_mat),
                    tdv.Noise(*(torch.from_numpy(a) for a in noise)),
                    beta=BETA)


@pytest.fixture(scope="module")
def case():
    """The JAX bf16 references, computed once: the fused loss's metrics and
    parameter gradients, the same gradients with bf16 sums run in f32, and
    the logits-out loss's metrics."""
    jp = jax_params(seed=1)
    x, c, pr_mat = _case()
    key = jax.random.PRNGKey(7)
    noise = jax_noise(key, JAX_TINY, B, *TFR)
    loss = lambda p, fused: jdv.loss(p, _jax_cfg(fused), key, x, c, pr_mat,
                                     None, *TFR, beta=BETA)
    # compiled, as a JAX training step runs (and in half the time)
    (_, fused_m), grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, True), has_aux=True))(jp)
    with mock.patch.object(jax_lax, "reduce_sum",
                           _f32_sums(jax_lax.reduce_sum)):
        grads_f32 = jax.jit(jax.grad(lambda p: loss(p, True)[0]))(jp)
    _, logits_m = jax.jit(lambda p: loss(p, False))(jp)
    as_float = lambda m: {k: float(v) for k, v in m.items()}
    refs = {True: as_float(fused_m), False: as_float(logits_m)}
    named = lambda g: _named(jax.tree_util.tree_map(np.asarray, g))
    return jp, x, c, pr_mat, noise, refs, (named(grads), named(grads_f32))


@pytest.mark.parametrize("fused_loss", [True, False])
def test_bf16_loss_and_metrics_match_jax(case, fused_loss):
    jp, x, c, pr_mat, noise, refs, _ = case
    total, metrics = _port_loss(port_params(jp), _port_cfg(fused_loss), x, c,
                                pr_mat, noise)
    assert total.dtype == torch.float32          # the loss math stays f32
    assert list(metrics) == list(tdv.METRIC_NAMES)
    for name in tdv.METRIC_NAMES:
        np.testing.assert_allclose(metrics[name].item(),
                                   refs[fused_loss][name],
                                   rtol=METRICS_RTOL, err_msg=name)


def test_bf16_grads_match_jax(case):
    """The fused loss's gradients, on the f32 master params through the
    cast, against ``jax.grad`` of the JAX bf16 loss: relative L2 against
    it as it is, relative L2 and the scaled max against it with its bf16
    sums in f32."""
    jp, x, c, pr_mat, noise, _, (want, want_f32) = case
    params = port_params(jp)
    leaves = param_list(params)
    for v in leaves:
        v.requires_grad_(True)
    total, _ = _port_loss(params, _port_cfg(True), x, c, pr_mat, noise)
    total.backward()
    got = {k: v.grad for k, v in _named(params).items()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g.dtype == torch.float32, name      # f32 master gradients
        g = g.numpy()
        for ref in (want[name], want_f32[name]):
            rel_l2 = np.linalg.norm(g - ref) / max(np.linalg.norm(ref),
                                                   1e-30)
            assert rel_l2 <= REL_L2, (name, rel_l2)
        ref = want_f32[name]
        scaled = np.abs(g - ref).max() / (1.0 + np.abs(ref).max())
        assert scaled <= SCALED_MAX, (name, scaled)


@pytest.mark.parametrize("fused_loss", [True, False])
def test_port_really_runs_bf16(case, fused_loss):
    """The bf16 metrics differ from the f32 ones by more than the parity
    tolerance, so the parity above is not an f32 run's."""
    jp, x, c, pr_mat, noise, refs, _ = case
    params = port_params(jp)
    _, m16 = _port_loss(params, _port_cfg(fused_loss), x, c, pr_mat, noise)
    _, m32 = _port_loss(params, _port_cfg(fused_loss, "float32"), x, c,
                        pr_mat, noise)
    gap = max(abs(m16[k].item() - m32[k].item()) / abs(m32[k].item())
              for k in tdv.METRIC_NAMES)
    assert gap > METRICS_RTOL


def test_serving_refuses_bf16_and_encode_takes_it():
    """The decode entry points' default route (K4, ``"full"``) serves
    float32 only, naming the JAX K4's missing bf16 mode (bf16 serving takes
    ``frame_decoder="frame"``, tests/test_torch_port_bf16_decoder.py);
    encode runs the bf16 policy and returns f32 distributions (its Gaussian
    heads are f32)."""
    from pctd_tpu_torch.models import pianotree_decoder as ptd
    from pctd_tpu_torch.models.sampler import Sampler

    cfg = _port_cfg(True)
    params = tdv.init_params(cfg, seed=0, device="cpu")
    z = torch.zeros(2, cfg.z_dim)
    for call in (lambda: tdv.decode_z(params, cfg, z[:, :cfg.chd_z_dim],
                                      z[:, cfg.chd_z_dim:]),
                 lambda: ptd.decode_grid(params["dec"], cfg, z),
                 lambda: Sampler(params, cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="K4 has no bf16 mode"):
            call()
    pr = torch.zeros(2, 32, 128)
    c = torch.zeros(2, 8, 36)
    d_chd, d_rhy = tdv.encode(params, cfg, pr, c)
    assert all(t.dtype == torch.float32 for t in (*d_chd, *d_rhy))
    f_chd, _ = tdv.encode(params, _port_cfg(True, "float32"), pr, c)
    assert not torch.equal(d_chd.mean, f_chd.mean)
