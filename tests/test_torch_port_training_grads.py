"""The port's whole-VAE parameter gradients against ``jax.grad`` of the JAX
package's XLA path at tiny width on the CPU, on the same weights, batch,
noise and teacher coins (the JAX key splits' draws)."""
import dataclasses

import jax
import numpy as np

from pctd_tpu.models import disentangle_vae as jdv
from tests.test_torch_port_training import B, BETA, TFR, _case, _named, \
    _port_loss
from tests.torch_port_helpers import JAX_TINY, jax_noise, jax_params, \
    port_params


def test_param_grads_match_jax():
    jp = jax_params(seed=1)
    x, c, pr_mat = _case()
    key = jax.random.PRNGKey(7)
    noise = jax_noise(key, JAX_TINY, B, *TFR)
    cfg = dataclasses.replace(JAX_TINY, train_frame_kernel=False)
    jgrads = jax.grad(lambda p: jdv.loss(p, cfg, key, x, c, pr_mat, None,
                                         *TFR, beta=BETA)[0])(jp)
    params = port_params(jp)
    leaves = _named(params)
    for v in leaves.values():
        v.requires_grad_(True)
    total, _ = _port_loss(params, x, c, pr_mat, noise)
    total.backward()
    want = _named(jgrads)
    assert sorted(want) == sorted(leaves)
    for name, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[name]),
                                   atol=2e-4, err_msg=name)
