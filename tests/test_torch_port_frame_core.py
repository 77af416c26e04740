"""The logits-out mode of the train-frame pair (the port's ``frame_core``)
against the JAX package's ``frame_core`` on the CPU: the plain forward
against the Pallas forward kernel in interpret mode, and autograd of it
(K2's plain version in this mode) against ``jax.grad`` through the JAX
hand-written VJP (``_bwd_call``), also in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.ops.pallas import train_frame as jtf
from pctd_tpu_torch.ops.kernels import train_frame as tf
from tests.test_torch_port_train_frame import USED, _inputs, _leaves
from tests.torch_port_helpers import JAX_TINY, TINY, eos_biased, \
    jax_params, port_params, t

SPEC = TINY.pianotree
K, W, P = SPEC.max_simu_note, SPEC.dur_width, SPEC.pitch_range


def _port_args(inp):
    return {k: torch.from_numpy(inp[k]) for k in ("frame_h", "x_emb",
                                                   "coins")}


def _port(jp, inp):
    cw = tf.core_weights(port_params(jp)["dec"], TINY)
    return tf.frame_core_plain(cw, SPEC, **_port_args(inp))


def _jax(dec, frame_h, x_emb, coins):
    return jtf.frame_core(JAX_TINY, True, jtf.core_weights(dec, JAX_TINY),
                          frame_h, x_emb, jnp.asarray(coins)[:, None])


def _weights(name, inp):
    jp = jax_params(seed=0)
    if name == "eos_biased":
        jp = eos_biased(jp, 0.8, lambda q: _port(q, inp).lengths.numpy())
    return jp


@pytest.mark.parametrize("weights", ["seed", "eos_biased"])
def test_frame_core_plain_matches_pallas_interpret(weights):
    inp = _inputs(6, seed=1)
    jp = _weights(weights, inp)
    out = _port(jp, inp)
    pitch, dur, summ, lengths = _jax(jp["dec"], inp["frame_h"],
                                     inp["x_emb"], inp["coins"])
    assert out.pitch_logits.shape == (6, K - 1, P)
    assert out.dur_logits.shape == (6, K - 1, W, 2)
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(lengths))
    np.testing.assert_allclose(out.pitch_logits.numpy(), np.asarray(pitch),
                               atol=1e-5)
    np.testing.assert_allclose(out.dur_logits.numpy(), np.asarray(dur),
                               atol=1e-5)
    np.testing.assert_allclose(out.summary.numpy(), np.asarray(summ),
                               atol=1e-5)


def test_frame_core_shares_the_loss_mode_forward():
    """Loss mode and logits out are one forward: frame_recon_plain's CE
    numerators are the masked CE of frame_core_plain's logits, and the two
    give the same summary and lengths bit for bit."""
    inp = _inputs(5, seed=3)
    cw = tf.core_weights(port_params(jax_params(seed=2))["dec"], TINY)
    core = tf.frame_core_plain(cw, SPEC, **_port_args(inp))
    recon = tf.frame_recon_plain(cw, SPEC, **{k: torch.from_numpy(v)
                                              for k, v in inp.items()})
    assert torch.equal(core.summary, recon.summary)
    assert torch.equal(core.lengths, recon.lengths)
    assert torch.equal(core.pitch_logits.argmax(-1).to(torch.int32),
                       recon.pitch)
    bits = (core.dur_logits[..., 1] > core.dur_logits[..., 0])
    assert torch.equal(bits.to(torch.int32), recon.bits)
    gt_p = torch.from_numpy(inp["gt_pitch"]).long()
    keep = gt_p != SPEC.pitch_pad
    nll = -torch.log_softmax(core.pitch_logits, -1).gather(
        -1, gt_p.clamp(max=P - 1)[..., None])[..., 0]
    torch.testing.assert_close(recon.nums[0], (nll * keep).sum(),
                               rtol=1e-5, atol=0)


def test_frame_core_takes_the_plain_version_on_the_cpu():
    inp = _inputs(4, seed=5)
    cw = tf.core_weights(port_params(jax_params(seed=2))["dec"], TINY)
    before = tf.frame_core_fwd.launches
    got = tf.frame_core(cw, SPEC, **_port_args(inp))
    want = tf.frame_core_plain(cw, SPEC, **_port_args(inp))
    assert tf.frame_core_fwd.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("weights", ["seed", "eos_biased"])
def test_frame_core_grads_match_jax_vjp(weights):
    inp = _inputs(6, seed=2)
    jp = _weights(weights, inp)
    rng = np.random.RandomState(4)
    g_pitch = rng.randn(6, K - 1, P).astype(np.float32)
    g_dur = rng.randn(6, K - 1, W, 2).astype(np.float32)
    g_summ = rng.randn(6, 2 * TINY.dec_emb_hidden).astype(np.float32)

    def contract(dec, frame_h, x_emb):
        pitch, dur, summ, _ = _jax(dec, frame_h, x_emb, inp["coins"])
        return ((pitch * g_pitch).sum() + (dur * g_dur).sum()
                + (summ * g_summ).sum())

    jdec = {k: jp["dec"][k] for k in USED}
    jgrads = jax.grad(contract, argnums=(0, 1, 2))(
        jdec, jnp.asarray(inp["frame_h"]), jnp.asarray(inp["x_emb"]))

    dec = port_params(jp)["dec"]
    leaves = _leaves({k: dec[k] for k in USED})
    for v in leaves.values():
        v.requires_grad_(True)
    fh = t(inp["frame_h"]).requires_grad_(True)
    xe = t(inp["x_emb"]).requires_grad_(True)
    out = tf.frame_core(tf.core_weights(dec, TINY), SPEC, fh, xe,
                        torch.from_numpy(inp["coins"]))
    ((out.pitch_logits * t(g_pitch)).sum()
     + (out.dur_logits * t(g_dur)).sum()
     + (out.summary * t(g_summ)).sum()).backward()

    want = _leaves(jgrads[0])
    assert sorted(want) == sorted(leaves)
    for name, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[name]),
                                   atol=2e-4, err_msg=name)
    np.testing.assert_allclose(fh.grad.numpy(), np.asarray(jgrads[1]),
                               atol=2e-4)
    np.testing.assert_allclose(xe.grad.numpy(), np.asarray(jgrads[2]),
                               atol=2e-4)
