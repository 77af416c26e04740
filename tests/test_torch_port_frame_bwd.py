"""K2a's plain version alone on the CPU: K1's stash in plain PyTorch
(``frame_stash_plain``) and the frame backward on it (``frame_bwd_plain``,
the JAX package's ``_frame_bwd_core`` in its phase order), with K2b's plain
version for the weight gradients.

(a) Against the JAX package's frame VJP through its Pallas kernels in
interpret mode, at tiny width, in both loss modes, in f32 (the bars of
``test_torch_port_train_frame.py``: 2e-4 absolute) and bf16 (the bars of
``test_torch_port_bf16_frame.py``: 1e-2 x (1 + max|JAX|)).
(b) Against autograd of the plain frame (``frame_recon_plain`` /
``frame_core_plain``) in f32 and f64, every weight gradient, d_frame_h,
d_x_emb and every per-sample cotangent against the gradient of the tensor
it belongs to, on weights whose frames end early (lengths below K-1).
(c) An emulation of the CUDA kernel's arithmetic (its row groups, phase
order and split TF32 products) against the f64 plain version at canonical
width: within 1e-5 x (1 + max|ref|), the f32 gate of chip_smoke.py, while
single-pass TF32 products miss it."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.ops.pallas import train_frame as jtf
from pctd_tpu.utils.precision import cast_params as jcast
from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.ops.kernels import train_frame as tf
from pctd_tpu_torch.ops.losses import masked_ce_parts
from pctd_tpu_torch.utils import precision
from tests.torch_port_helpers import JAX_TINY, TINY, jax_params, \
    port_params, with_eos_bias

SPEC = TINY.pianotree
K, W, P = SPEC.max_simu_note, SPEC.dur_width, SPEC.pitch_range
S = K - 1
B = 6
BF = torch.bfloat16
NAMES = list(tf.CoreWeights._fields) + ["frame_h", "x_emb"]
F64_GATE = 1e-5       # x (1 + max|ref|): chip_smoke.py's K2a f32 gate


def _case(B, seed, all_coins=False):
    """One frame's inputs and output cotangents as numpy (f32)."""
    rng = np.random.RandomState(seed)
    return dict(
        frame_h=rng.randn(B, TINY.dec_time_hidden).astype(np.float32) * 0.8,
        x_emb=rng.randn(B, K, TINY.note_emb_size).astype(np.float32) * 0.5,
        coins=(np.ones(S, np.int32) if all_coins else
               (rng.rand(S) < 0.5).astype(np.int32)),
        gt_pitch=rng.randint(0, P + 1, (B, S)).astype(np.int32),
        gt_dur=rng.randint(0, 3, (B, S, W)).astype(np.int32),
        g_nums=rng.rand(1 + W).astype(np.float32),
        g_summ=rng.randn(B, 2 * TINY.dec_emb_hidden).astype(np.float32),
        g_pitch=rng.randn(B, S, P).astype(np.float32),
        g_dur=rng.randn(B, S, W, 2).astype(np.float32))


def _plain_backward(cw, spec, c, mode, dtype):
    """K1's stash, K2a and K2b in plain PyTorch on ``c`` in ``dtype``: the
    26 gradients (24 weights, frame_h, x_emb), the cotangents and the
    lengths."""
    tt = lambda k: torch.from_numpy(c[k])
    fh, xe = tt("frame_h").to(dtype), tt("x_emb").to(dtype)
    coins, gp, gd = tt("coins"), tt("gt_pitch"), tt("gt_dur")
    lens = tf.frame_core_plain(cw, spec, fh, xe, coins).lengths
    st = tf.frame_stash_plain(cw, spec, fh, xe, coins)
    f = tf.compute_dtype(dtype)
    logit_cots = (() if mode == "loss" else
                  (tt("g_pitch").to(dtype), tt("g_dur").to(dtype)))
    d_fh, d_xe, ct = tf.frame_bwd_plain(
        cw, spec, fh, coins, gp, gd, lens, st, tt("g_nums").to(f),
        tt("g_summ").to(dtype), *logit_cots)
    grads = tf.CoreWeights(*(torch.empty_like(w) for w in cw))
    tf.wgrad_plain(tf.wgrad_tasks(tf.dims_of(cw, spec), fh.shape[0], fh, st,
                                  ct, grads))
    return [*grads, d_fh, d_xe], ct, lens


# --- (a) against the JAX package's frame VJP --------------------------------

def _jax_grads(jp, c, mode, dtype):
    """jax.vjp of the frame through the JAX package's kernel pair in
    interpret mode: the 26 gradients of its outputs contracted with the
    case's cotangents (in the outputs' dtype), as f32 numpy."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    dec = jp["dec"] if jdt == jnp.float32 else jcast(jp["dec"], jdt)
    w = jtf.core_weights(dec, JAX_TINY)
    coins = c["coins"][:, None]

    def fwd(w, fh, xe):
        if mode == "loss":
            return jtf.frame_recon_partials(
                JAX_TINY, True, w, fh, xe, coins, c["gt_pitch"],
                c["gt_dur"].reshape(B, -1))
        return jtf.frame_core(JAX_TINY, True, w, fh, xe, coins)[:3]

    _, vjp = jax.vjp(fwd, w, jnp.asarray(c["frame_h"], jdt),
                     jnp.asarray(c["x_emb"], jdt))
    if mode == "loss":
        cts = (jnp.asarray(c["g_nums"]), jnp.asarray(c["g_summ"], jdt))
    else:
        cts = tuple(jnp.asarray(c[k], jdt)
                    for k in ("g_pitch", "g_dur", "g_summ"))
    gw, gfh, gxe = vjp(cts)
    return [np.asarray(g.astype(jnp.float32)) for g in (*gw, gfh, gxe)]


@pytest.mark.parametrize("mode", ["loss", "logits"])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_plain_k2a_matches_the_jax_frame_vjp(dtype, mode):
    """In bf16 the teacher coins are all set, so the values do not hang on
    argmax flips of bf16 logits (as in test_torch_port_bf16_frame.py)."""
    bf16 = dtype == BF
    c = _case(B, seed=2, all_coins=bf16)
    if bf16:
        for k in ("frame_h", "x_emb", "g_summ", "g_pitch", "g_dur"):
            c[k] = torch.from_numpy(c[k]).to(BF).float().numpy()
    jp = jax_params(seed=3)
    want = _jax_grads(jp, c, mode, dtype)
    dec = port_params(jp)["dec"]
    if bf16:
        dec = precision.cast_params(dec, BF)
    cw = tf.CoreWeights(*(w.detach() for w in tf.core_weights(dec, TINY)))
    got = _plain_backward(cw, SPEC, c, mode, dtype)[0]
    for name, g, ref in zip(NAMES, got, want):
        assert g.dtype == dtype, name
        g = g.float().numpy().reshape(ref.shape)
        if bf16:
            bound = 1e-2 * (1.0 + np.abs(ref).max())
            assert np.abs(g - ref).max() <= bound, name
        else:
            np.testing.assert_allclose(g, ref, atol=2e-4, err_msg=name)


# --- (b) against autograd of the plain frame --------------------------------

def _autograd(cw, spec, c, mode, dtype):
    """Autograd of the plain frame in ``dtype``: the 26 gradients and, for
    each Cotangents field, the gradient of the tensor it belongs to
    (stacked as the field is laid out)."""
    leaves = [w.clone().requires_grad_(True) for w in cw]
    tt = lambda k: torch.from_numpy(c[k])
    fh = tt("frame_h").to(dtype).requires_grad_(True)
    xe = tt("x_emb").to(dtype).requires_grad_(True)
    rec = collections.defaultdict(list)
    est, dur, summary, lens = tf._frame_plain(
        tf.CoreWeights(*leaves), spec, fh, xe, tt("coins"), rec)[:4]
    probes = [rec["h0"], rec["gi_frame"], *rec["pred"][1:], *(
        t for name in ("gi", "gh", "est", "hd0", "gid", "ghd", "logit",
                       "sgi", "sgh") for t in rec[name])]
    for t in probes:
        t.retain_grad()
    f = tf.compute_dtype(dtype)
    if mode == "loss":
        nums = [masked_ce_parts(est, tt("gt_pitch"), spec.pitch_pad)[0]]
        nums += [masked_ce_parts(dur[:, :, w], tt("gt_dur")[..., w],
                                 spec.dur_pad)[0] for w in range(W)]
        loss = (torch.stack(nums).to(f) * tt("g_nums").to(f)).sum()
    else:
        loss = ((est * tt("g_pitch").to(f)).sum()
                + (dur * tt("g_dur").to(f)).sum())
    (loss + (summary * tt("g_summ").to(f)).sum()).backward()
    grads = [l.grad for l in leaves] + [fh.grad, xe.grad]
    g = lambda name: torch.stack([t.grad for t in rec[name]])
    by_slot = lambda name: g(name).reshape(S, W, *g(name).shape[1:]
                                           ).transpose(1, 2)
    sgh = g("sgh")
    ct = dict(
        d_gi=g("gi"), d_gh=g("gh"), d_est=g("est"), d_hd0=g("hd0"),
        d_gid=by_slot("gid"), d_ghd=by_slot("ghd"), d_log=by_slot("logit"),
        d_emb=torch.stack([t.grad for t in rec["pred"][1:]]),
        d_sgi=g("sgi").transpose(1, 2),
        d_sgh=sgh.reshape(2, K, *sgh.shape[1:]),
        dh0=rec["h0"].grad,
        d_gif=rec["gi_frame"].grad)
    # dur_sos enters each sample through its step-0 input gates
    ct["d_sos"] = ct["d_gid"][:, :, 0] @ cw.w_dih.t()
    return grads, ct, lens


@pytest.mark.parametrize("mode", ["loss", "logits"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_k2a_matches_autograd(dtype, mode):
    """Tolerances x (1 + max|ref|): f32 1e-5; f64 1e-12, except the loss
    mode's, where the plain CE numerators (losses._nll) compute in f32 and
    hold autograd to f32 accuracy (1e-6)."""
    c = _case(5, seed=4)
    jp = with_eos_bias(jax_params(seed=0), 0.8)
    cw = tf.CoreWeights(*(w.detach().to(dtype) for w in
                          tf.core_weights(port_params(jp)["dec"], TINY)))
    got, ct, lens = _plain_backward(cw, SPEC, c, mode, dtype)
    assert len(np.unique(lens.numpy())) >= 3 and lens.min().item() < S
    want, want_ct, want_lens = _autograd(cw, SPEC, c, mode, dtype)
    assert torch.equal(lens, want_lens)
    tol = (1e-5 if dtype == torch.float32 else
           1e-6 if mode == "loss" else 1e-12)
    close = lambda a, b, name: torch.testing.assert_close(
        a, b, rtol=0, atol=tol * (1.0 + b.abs().max().item()), msg=name)
    for name, a, b in zip(NAMES, got, want):
        close(a, b, name)
    for name in tf.Cotangents._fields:
        close(getattr(ct, name), want_ct[name].to(getattr(ct, name).dtype),
              name)


# --- (c) the CUDA kernel's arithmetic, emulated ------------------------------

KC = 32    # k of a block that sums in a fresh fragment (mma_rows)
ROWS = 16  # rows of a row group (BW_M)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32):
    half of the 13 dropped mantissa bits added, then masked off."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def kernel_mm(passes: int):
    """y @ w.T as the kernel's mma_rows computes it: the cotangent y and the
    weight w split hi + lo in TF32, each KC of k summed in a fresh f32
    partial (lo.hi + hi.lo + hi.hi with three passes, hi.hi alone with
    one) that then joins the running sum."""
    def mm(y, w):
        yh, wh = tf32(y), tf32(w)
        yl, wl = tf32(y - yh), tf32(w - wh)
        out = torch.zeros(*y.shape[:-1], w.shape[0])
        for k in range(0, y.shape[-1], KC):
            s = slice(k, k + KC)
            part = yh[..., s] @ wh[:, s].t()
            if passes == 3:
                part = (yl[..., s] @ wh[:, s].t() + yh[..., s] @ wl[:, s].t()
                        + part)
            out = out + part
        return out
    return mm


def _rows(st: tf.Stash, rows: slice) -> tf.Stash:
    """The stash of a row group: every field's batch axis sliced."""
    return tf.Stash(*(x[:, :, rows] if name in ("sh", "sg") else x[:, rows]
                      for name, x in zip(tf.Stash._fields, st)))


def _emulated_k2a(cw, spec, c, st, lens, mm):
    """K2a's arithmetic over its row groups of ROWS rows, in its phase order
    (2a, 2b, 2c, 2d, each row group's chains separate), in f32."""
    tt = lambda k: torch.from_numpy(c[k])
    outs = []
    for b0 in range(0, lens.shape[0], ROWS):
        r = slice(b0, b0 + ROWS)
        outs.append(tf._frame_bwd(
            cw, spec, tt("coins"), tt("gt_pitch")[r], tt("gt_dur")[r],
            lens[r], _rows(st, r), tt("g_nums"), tt("g_summ")[r], None,
            None, mm=mm))
    d_fh = torch.cat([o[0] for o in outs])
    d_xe = torch.cat([o[1] for o in outs])
    axis = {"d_sgi": 2, "d_sgh": 2, "dh0": 0, "d_gif": 0}
    ct = tf.Cotangents(*(torch.cat([o[2][i] for o in outs],
                                   axis.get(name, 1))
                         for i, name in enumerate(tf.Cotangents._fields)))
    return [d_fh, d_xe, *ct]


@pytest.fixture(scope="module")
def canonical_case():
    """A canonical-width frame at B=4 on eos-biased weights: the f32 weights
    and stash, the inputs, lengths, and the f64 plain reference."""
    cfg = ModelConfig()
    spec = cfg.pianotree
    p = dv.init_params(cfg, seed=0, device="cpu")
    cw = tf.CoreWeights(*(w.detach().clone() for w in
                          tf.core_weights(p["dec"], cfg)))
    cw.b_pitch[spec.pitch_eos] += 1.0
    rng = np.random.RandomState(5)
    n = 4
    c = dict(frame_h=rng.randn(n, cfg.dec_time_hidden).astype(np.float32)
             * 0.6,
             x_emb=rng.randn(n, K, cfg.note_emb_size).astype(np.float32)
             * 0.5,
             coins=(rng.rand(S) < 0.5).astype(np.int32),
             gt_pitch=rng.randint(0, P + 1, (n, S)).astype(np.int32),
             gt_dur=rng.randint(0, 3, (n, S, W)).astype(np.int32),
             g_nums=rng.rand(1 + W).astype(np.float32),
             g_summ=rng.randn(n, 2 * cfg.dec_emb_hidden).astype(np.float32))
    tt = lambda k: torch.from_numpy(c[k])
    with torch.no_grad():
        lens = tf.frame_core_plain(cw, spec, tt("frame_h"), tt("x_emb"),
                                   tt("coins")).lengths
        st = tf.frame_stash_plain(cw, spec, tt("frame_h"), tt("x_emb"),
                                  tt("coins"))
        f64 = lambda x: x.double()
        ref = tf.frame_bwd_plain(
            tf.CoreWeights(*map(f64, cw)), spec, None, tt("coins"),
            tt("gt_pitch"), tt("gt_dur"), lens, tf.Stash(*map(f64, st)),
            tt("g_nums").double(), tt("g_summ").double())
    return cw, spec, c, st, lens, [ref[0], ref[1], *ref[2]]


@pytest.mark.parametrize("passes", [3, 1])
def test_kernel_arithmetic_meets_the_f64_gate(canonical_case, passes):
    """Three TF32 passes (the kernel's) meet the gate on every output; one
    pass (plain TF32, the control) misses it."""
    cw, spec, c, st, lens, ref = canonical_case
    assert lens.min().item() < S
    with torch.no_grad():
        got = _emulated_k2a(cw, spec, c, st, lens, kernel_mm(passes))
    names = ["d_frame_h", "d_x_emb", *tf.Cotangents._fields]
    errs = {name: ((a.double() - b).abs().max()
                   / (1.0 + b.abs().max())).item()
            for name, a, b in zip(names, got, ref)}
    if passes == 3:
        assert max(errs.values()) <= F64_GATE, errs
    else:
        assert max(errs.values()) > F64_GATE, errs
