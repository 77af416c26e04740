"""The bf16 mode of the train-frame path's plain PyTorch version (K1's plain
forward in both modes, and K2's plain version, autograd of it) against the
JAX package's bf16 Pallas kernels run in interpret mode on the CPU, and the
precision policy's parameter cast.

The teacher coins are all set, so the values do not hang on argmax flips.
Tolerances: XLA's CPU compiler keeps excess precision where a bf16 + bf16
sum feeds f32 math (the duration GRU's feedback rows ``w_dih[b] + b_dih``),
which the Pallas kernel (and the port) round to bf16; with
``--xla_allow_excess_precision=false`` the port's forward and its gradients
equal the interpret-mode kernels bit for bit (the loss mode) or within
2e-5 (logits out). Under the default flags the duration logits differ by
an ulp or two: values are held within 1e-2 x (1 + max|JAX|) (two bf16
ulps), the CE numerators within 1e-4 relative, and the decisions, lengths,
note hiddens and summaries exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.ops.pallas import train_frame as jtf
from pctd_tpu.utils.precision import cast_params as jcast
from pctd_tpu_torch.ops.kernels import train_frame as tf
from pctd_tpu_torch.utils import precision
from tests.test_torch_port_training import _named
from tests.torch_port_helpers import JAX_TINY, TINY, jax_params, \
    port_params, with_eos_bias

SPEC = TINY.pianotree
K, W, P = SPEC.max_simu_note, SPEC.dur_width, SPEC.pitch_range
B = 6
BF = torch.bfloat16
VALUE_TOL = 1e-2      # x (1 + max|JAX|): two bf16 ulps
NUMS_RTOL = 1e-4
GRAD_TOL = 1e-2       # x (1 + max|JAX|), each of the 26 gradients


def _bf(a):
    """numpy -> the nearest bf16 values, as float32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case():
    rng = np.random.RandomState(1)
    return dict(
        frame_h=_bf(rng.randn(B, TINY.dec_time_hidden) * 0.8),
        x_emb=_bf(rng.randn(B, K, TINY.note_emb_size) * 0.5),
        coins=np.ones(K - 1, np.int32),
        gt_pitch=rng.randint(0, P + 1, (B, K - 1)).astype(np.int32),
        gt_dur=rng.randint(0, 3, (B, K - 1, W)).astype(np.int32),
        g_nums=rng.rand(1 + W).astype(np.float32),
        g_summ=_bf(rng.randn(B, 2 * TINY.dec_emb_hidden)),
        g_pitch=_bf(rng.randn(B, K - 1, P)),
        g_dur=_bf(rng.randn(B, K - 1, W, 2)))


def _jax_frame(jp, c, mode):
    """The JAX bf16 frame through the interpret-mode kernels: its outputs,
    and the gradients (24 weights, frame_h, x_emb) of the outputs contracted
    with the case's cotangents."""
    w = jtf.core_weights(jcast(jp["dec"], jnp.bfloat16), JAX_TINY)
    coins = c["coins"][:, None]
    f32 = lambda a: a.astype(jnp.float32)

    def fwd(w, fh, xe):
        if mode == "loss":
            return jtf.frame_recon_partials(
                JAX_TINY, True, w, fh, xe, coins, c["gt_pitch"],
                c["gt_dur"].reshape(B, -1))
        return jtf.frame_core(JAX_TINY, True, w, fh, xe, coins)[:3]

    out, vjp = jax.vjp(fwd, w, jnp.asarray(c["frame_h"], jnp.bfloat16),
                       jnp.asarray(c["x_emb"], jnp.bfloat16))
    if mode == "loss":
        cts = (jnp.asarray(c["g_nums"]),
               jnp.asarray(c["g_summ"], jnp.bfloat16))
    else:
        cts = tuple(jnp.asarray(c[k], jnp.bfloat16)
                    for k in ("g_pitch", "g_dur", "g_summ"))
    gw, gfh, gxe = vjp(cts)
    grads = [np.asarray(f32(g)) for g in (*gw, gfh, gxe)]
    return [np.asarray(f32(o)) for o in out], grads


def _port_frame(jp, c, mode, grad):
    dec = precision.cast_params(port_params(jp)["dec"], BF)
    leaves = [t.detach().clone().requires_grad_(grad)
              for t in tf.core_weights(dec, TINY)]
    cw = tf.CoreWeights(*leaves)
    fh = torch.tensor(c["frame_h"]).to(BF).requires_grad_(grad)
    xe = torch.tensor(c["x_emb"]).to(BF).requires_grad_(grad)
    coins = torch.from_numpy(c["coins"])
    t = lambda k: torch.tensor(c[k])
    if mode == "loss":
        out = tf.frame_recon_plain(cw, SPEC, fh, xe, coins, t("gt_pitch"),
                                   t("gt_dur"))
        outs = (out.nums, out.summary)
        loss = ((out.nums * t("g_nums")).sum()
                + (out.summary.float() * t("g_summ")).sum())
    else:
        out = tf.frame_core_plain(cw, SPEC, fh, xe, coins)
        outs = out[:3]
        loss = sum((o.float() * t(k)).sum() for o, k in
                   zip(outs, ("g_pitch", "g_dur", "g_summ")))
    grads = None
    if grad:
        loss.backward()
        grads = [v.grad for v in (*leaves, fh, xe)]
    return out, outs, grads


@pytest.fixture(scope="module", params=["loss", "logits"])
def frame_case(request):
    """The JAX reference of one mode, computed once: forward and gradients
    with the seed weights, the forward with eos-biased weights."""
    c = _case()
    jp = jax_params(seed=0)
    biased = with_eos_bias(jp, 0.8)
    mode = request.param
    seed_ref = _jax_frame(jp, c, mode)
    w = jtf.core_weights(jcast(biased["dec"], jnp.bfloat16), JAX_TINY)
    fh = jnp.asarray(c["frame_h"], jnp.bfloat16)
    xe = jnp.asarray(c["x_emb"], jnp.bfloat16)
    coins = c["coins"][:, None]
    if mode == "loss":
        (nums, summ, lengths), hs = jtf._fwd_call(
            JAX_TINY.pianotree, JAX_TINY.dec_emb_hidden,
            JAX_TINY.dec_notes_hidden, w, fh, xe, coins, True, stash=True,
            gt=(c["gt_pitch"], c["gt_dur"].reshape(B, -1)))
        biased_ref = dict(nums=nums[0, :1 + W], summary=summ,
                          lengths=lengths, hs=hs)
    else:
        pitch, dur, summ, lengths = jtf.frame_core(JAX_TINY, True, w, fh, xe,
                                                   coins)
        biased_ref = dict(pitch=pitch, dur=dur, summary=summ,
                          lengths=lengths)
    biased_ref = {k: np.asarray(jnp.asarray(v).astype(
        jnp.int32 if k == "lengths" else jnp.float32))
        for k, v in biased_ref.items()}
    return mode, c, jp, biased, seed_ref, biased_ref


def _close(got, want, tol, name):
    got = np.asarray(got, np.float32)
    bound = tol * (1.0 + np.abs(want).max())
    assert np.abs(got - want).max() <= bound, name


def test_cast_params_keeps_heads_f32():
    """The copy of the precision policy casts every floating tensor but the
    Gaussian heads, as the JAX package's (``tests/test_precision.py``)."""
    params = port_params(jax_params())
    cast = precision.cast_params(params, BF)
    assert cast["chd_enc"]["mu"]["w"].dtype == torch.float32
    assert cast["chd_enc"]["std"]["w"].dtype == torch.float32
    assert cast["txt_enc"]["std"]["b"].dtype == torch.float32
    assert cast["chd_enc"]["gru_fwd"].w_ih.dtype == BF
    assert cast["dec"]["time_gru"].w_hh.dtype == BF
    assert cast["dec"]["dur_sos"].dtype == BF
    # the same leaves are cast as by the JAX package's policy
    jcasted = _named(jcast(jax_params(), jnp.bfloat16))
    got = _named(cast)
    assert sorted(got) == sorted(jcasted)
    for name, t in got.items():
        assert (t.dtype == BF) == (jcasted[name].dtype == jnp.bfloat16), name
    # the cast is differentiable: gradients reach the f32 master tensors
    w = params["dec"]["time2notes"]["w"].requires_grad_(True)
    precision.cast_params(params, BF)["dec"]["time2notes"]["w"].float() \
        .sum().backward()
    assert w.grad.dtype == torch.float32 and torch.all(w.grad == 1.0)


@pytest.mark.parametrize("weights", ["seed", "eos_biased"])
def test_bf16_frame_plain_matches_pallas_interpret(frame_case, weights):
    mode, c, jp, biased, seed_ref, biased_ref = frame_case
    out, _, _ = _port_frame(jp if weights == "seed" else biased, c, mode,
                            grad=False)
    if weights == "seed":
        outs = seed_ref[0]
        ref = (dict(nums=outs[0], summary=outs[1]) if mode == "loss" else
               dict(pitch=outs[0], dur=outs[1], summary=outs[2]))
    else:
        ref = biased_ref
        assert len(np.unique(ref["lengths"])) >= 3
        np.testing.assert_array_equal(out.lengths.numpy(), ref["lengths"])
    np.testing.assert_array_equal(out.summary.float().numpy(),
                                  ref["summary"])
    assert out.summary.dtype == BF
    if mode == "loss":
        np.testing.assert_allclose(out.nums.numpy(), ref["nums"],
                                   rtol=NUMS_RTOL)
        if "hs" in ref:
            np.testing.assert_array_equal(out.hs.float().numpy(), ref["hs"])
        return
    assert out.pitch_logits.dtype == out.dur_logits.dtype == BF
    pitch = out.pitch_logits.float().numpy()
    dur = out.dur_logits.float().numpy()
    np.testing.assert_array_equal(pitch.argmax(-1), ref["pitch"].argmax(-1))
    np.testing.assert_array_equal(dur[..., 1] > dur[..., 0],
                                  ref["dur"][..., 1] > ref["dur"][..., 0])
    _close(pitch, ref["pitch"], VALUE_TOL, "pitch logits")
    _close(dur, ref["dur"], VALUE_TOL, "dur logits")


def test_bf16_frame_grads_match_pallas_vjp(frame_case):
    """Autograd of the bf16 plain frame (f32 arithmetic, straight-through
    roundings, each weight gradient rounded once to bf16) against
    ``jax.vjp`` through the interpret-mode kernel pair."""
    mode, c, jp, _, seed_ref, _ = frame_case
    _, _, grads = _port_frame(jp, c, mode, grad=True)
    names = list(tf.CoreWeights._fields) + ["frame_h", "x_emb"]
    assert len(grads) == len(seed_ref[1]) == len(names)
    for name, g, want in zip(names, grads, seed_ref[1]):
        assert g.dtype == BF, name
        _close(g.float().numpy().reshape(want.shape), want, GRAD_TOL, name)
