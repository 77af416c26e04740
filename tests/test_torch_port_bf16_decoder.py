"""The bf16 serving path of the port (the K3 route: folds, K3's plain
version, ``decode_grid(frame_decoder="frame")`` and the bf16 ``Sampler``)
against the JAX package's bf16 decode through its Pallas frame kernel in
interpret mode (``decode_grid(frame_decoder="pallas")``), on the same bf16
params and inputs (CPU, tiny dims).

The JAX params are handed over as ``jnp`` leaves: with numpy leaves the
JAX package's bf16 XLA decode raises (a scan carry enters in bf16 and
leaves in f32), and so does its K4 (``decode_grid_fused``) with either,
which is why the port serves bf16 through K3 alone.

Tolerances: the folds, the frame's decisions and lengths, and the summary
are bit-exact; a whole decode agrees on >= 0.999 of its grid entries, and
each row's first differing decision is a near-tie of the port's logits
(margin <= 1e-4 of 1 + |max logit|; read: 2.5e-6): the K3 products sum in
f32 in another order than XLA's, so a bf16 decode meets ties that an f32
one rarely does. The JAX package's own bf16 routes (XLA scan and Pallas)
agree on 0.99256 of grid entries.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models import pianotree_decoder as jptd
from pctd_tpu.ops.pallas import ar_decoder as jar
from pctd_tpu.utils.precision import cast_params as jcast
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import pianotree_decoder as tptd
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.gru import gru_gates_pre
from pctd_tpu_torch.ops.kernels import ar_decoder, build, full_decoder
from pctd_tpu_torch.utils.precision import cast_params
from tests.torch_port_helpers import (JAX_TINY, TINY, jax_params,
                                      port_params, requests, t,
                                      with_eos_bias)

BF = torch.bfloat16
JCFG = dataclasses.replace(JAX_TINY, compute_dtype="bfloat16")
CFG = dataclasses.replace(TINY, compute_dtype="bfloat16")
SPEC = CFG.pianotree
K, W, P = SPEC.max_simu_note, SPEC.dur_width, SPEC.pitch_range
AGREE = 0.999
NEAR_TIE = 1e-4       # first differing decision: margin / (1 + |max|)
EOS_BIAS = 0.8


@functools.lru_cache(maxsize=None)
def _weights(eos: bool):
    """(JAX bf16 params with jnp leaves, the port's bf16 params) of one
    seed, optionally eos-biased."""
    jp = jax_params(seed=0)
    if eos:
        jp = with_eos_bias(jp, EOS_BIAS)
    jbf = jcast(jax.tree_util.tree_map(jnp.asarray, jp), jnp.bfloat16)
    return jbf, cast_params(port_params(jp), BF)


def _port_fw(eos: bool):
    return ar_decoder.folded_frame_weights(_weights(eos)[1]["dec"], CFG)


def _bf16(a) -> torch.Tensor:
    """A bf16 JAX array as a bf16 tensor (exact)."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF)


def test_bf16_folds_match_jax():
    """The serving folds on bf16 params equal the JAX package's bit for bit
    (bf16), and the two f32 constants equal what its kernel computes."""
    jdec, tdec = _weights(False)[0]["dec"], _weights(False)[1]["dec"]
    with jax.default_matmul_precision("highest"):
        jf = jptd.fold_inference_heads(jdec, JAX_TINY)
        _, _, slot_args, _ = jar.folded_frame_weights(jdec, JAX_TINY)
    tf = tptd.fold_inference_heads(tdec, CFG)
    for name, want in jf.items():
        got = tf[name]
        want = np.asarray(want.astype(jnp.float32))
        if want.shape[-1] != got.shape[-1]:       # the JAX 128-lane pad
            want = np.concatenate([want[..., :2], want[..., 128:]], -1)
        assert got.dtype == BF, name
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.reshape(got.shape), err_msg=name)
    fw = ar_decoder.folded_frame_weights(tdec, CFG)
    for name, w in zip(fw._fields, fw):
        assert w.dtype == (torch.float32 if name in ar_decoder.F32_FIELDS
                           else BF), name
    np.testing.assert_array_equal(fw.gi_tok_sos.numpy(),
                                  np.asarray(slot_args[6])[0])
    dg = jdec["dur_gru"]
    gi_d = jnp.concatenate([
        jnp.dot(jdec["dur_sos"][None], dg.w_ih,
                preferred_element_type=jnp.float32) + dg.b_ih,
        (dg.w_ih[0:2] + dg.b_ih).astype(jnp.float32)])
    np.testing.assert_array_equal(fw.gi_d.numpy(), np.asarray(gi_d))


@functools.lru_cache(maxsize=None)
def _jax_frame(eos: bool, B: int = 8):
    """The JAX package's bf16 K3 (interpret mode) on bf16 inputs: (h_time,
    sos_emb, outputs)."""
    jdec = _weights(eos)[0]["dec"]
    rng = np.random.RandomState(1)
    h = jnp.asarray(rng.randn(B, TINY.dec_time_hidden) * 0.6, jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        sos = jptd.dense_apply(jdec["note_emb"], jptd.sos_token_raw(
            JAX_TINY.pianotree).astype(jnp.bfloat16))
        sos = jnp.broadcast_to(sos, (B, sos.shape[-1]))
        out = jar.frame_decode_pallas(jdec, JAX_TINY, h, sos,
                                      interpret=True)
    return h, sos, out


@pytest.mark.parametrize("eos", [False, True], ids=["seed", "eos_biased"])
def test_bf16_frame_decode_plain_matches_pallas_frame_kernel(eos):
    """K3's plain version in bf16 against the JAX bf16 frame kernel:
    decisions and lengths exact, the bf16 summary within one bf16 ulp."""
    h, sos, (k_pitch, k_bits, k_summary, k_len) = _jax_frame(eos)
    pitch, bits, summary, lengths = ar_decoder.frame_decode_plain(
        _port_fw(eos), SPEC, _bf16(h), _bf16(sos))
    if eos:
        assert len(np.unique(lengths.numpy())) >= 3
    np.testing.assert_array_equal(pitch.numpy(), np.asarray(k_pitch))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(k_bits))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(k_len))
    assert summary.dtype == BF and k_summary.dtype == jnp.bfloat16
    want = np.asarray(k_summary.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(summary.float().numpy() - want) <= ulp).all()


def _port_route(eos: bool, z: torch.Tensor):
    """The bf16 K3 route as ``decode_grid`` runs it, frame by frame:
    (grid (B, T, K-1, 6), the time hidden of each frame (T, B, TH))."""
    tdec = _weights(eos)[1]["dec"]
    fw = _port_fw(eos)
    h, gi_z, token, sos = tptd.decode_inputs(tdec, CFG, z)
    steps, hs = [], []
    for _ in range(SPEC.num_step):
        h = gru_gates_pre(gi_z + token @ fw.wt_tok, h @ fw.wt_hh + fw.bt_hh,
                          h)
        pitch, bits, token, _ = ar_decoder.frame_decode(fw, SPEC, h, sos)
        steps.append(torch.cat([pitch[..., None], bits], -1))
        hs.append(h)
    return torch.stack(steps, 1), torch.stack(hs)


def _first_difference_margins(eos, got, want, hs):
    """For each row whose decisions differ from the JAX grid, the port's
    margin at the first differing decision (frame-major, slot-major,
    [pitch | bits]): a pitch's max logit minus the logit of the JAX pitch,
    over 1 + |max|; a bit's |logit1 - logit0| over 1 + max|logit|; the
    logits from the port's plain K3 on that frame's time hidden."""
    fw = _port_fw(eos)
    B = got.shape[0]
    diff = (got != want).reshape(B, -1)
    margins = []
    for r in np.nonzero(diff.any(1))[0]:
        f, k, c = np.unravel_index(np.argmax(diff[r]), got.shape[1:])
        hid, gi = ar_decoder.frame_projection(fw, hs[f, r:r + 1])
        _, _, _, pl, dl = ar_decoder.slot_chain_plain(fw, SPEC, hid, gi,
                                                      logits=True)
        if c == 0:
            lg = pl[0, k].double()
            margins.append(((lg.max() - lg[int(want[r, f, k, 0])])
                            / (1 + lg.max().abs())).item())
        else:
            lg = dl[0, k, c - 1].double()
            margins.append(((lg[1] - lg[0]).abs()
                            / (1 + lg.abs().max())).item())
    return margins


def _latents(B: int, seed: int):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, TINY.chd_z_dim).astype(np.float32),
            rng.randn(B, TINY.txt_z_dim).astype(np.float32))


def _jax_grid(eos: bool, B: int, seed: int) -> np.ndarray:
    """The JAX bf16 decode of a case's latents through its frame kernel
    (``decode_grid(frame_decoder="pallas")``, interpret mode)."""
    z = jnp.concatenate(_latents(B, seed), -1).astype(jnp.bfloat16)
    return np.asarray(jptd.decode_grid(_weights(eos)[0]["dec"], JCFG, z,
                                       frame_decoder="pallas",
                                       interpret=True))


def _hold_to_jax(eos: bool, B: int, seed: int, want: np.ndarray):
    """The port's bf16 ``decode_z`` (K3 route) of a case against the JAX
    grid ``want``: >= 0.999 of entries agree and each differing row first
    differs at a near-tie. Returns (agreement, first-difference margins)."""
    zc, zr = _latents(B, seed)
    got = tdv.decode_z(_weights(eos)[1], CFG, t(zc), t(zr),
                       frame_decoder="frame")
    grid, hs = _port_route(eos, torch.cat([t(zc), t(zr)], -1).to(BF))
    assert torch.equal(grid, got)
    got = got.numpy()
    assert got.shape == want.shape == (B, 32, K - 1, 6)
    agree = (got == want).mean()
    margins = _first_difference_margins(eos, got, want, hs)
    print(f"bf16 decode, eos={eos} B={B} seed={seed}: agreement {agree}, "
          f"first-difference margins {margins}")
    assert agree >= AGREE
    assert all(m <= NEAR_TIE for m in margins), margins
    return agree, margins


@pytest.mark.parametrize("eos,B,seed", [(False, 5, 0), (False, 8, 1),
                                        (True, 8, 3)],
                         ids=["seed-B5", "seed-B8", "eos_biased-B8"])
def test_bf16_decode_grid_matches_jax_pallas_route(eos, B, seed):
    """``decode_z`` in bf16 through K3 against the JAX bf16 decode through
    its frame kernel (``decode_grid(frame_decoder="pallas")``, interpret
    mode) on the same latents: >= 0.999 of grid entries agree, and each
    differing row first differs at a near-tie."""
    _hold_to_jax(eos, B, seed, _jax_grid(eos, B, seed))


_EXACT_XLA = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, {root!r})
from tests.test_torch_port_bf16_decoder import _jax_grid
np.save({out!r}, _jax_grid(False, 8, 1))
"""


def test_bf16_decode_differences_are_sum_order_not_excess_precision(
        tmp_path):
    """The seed-B8 case (whose decode differs from the JAX grid at a
    near-tie) against the JAX route run with XLA's excess precision off
    (``--xla_allow_excess_precision=false``, read when XLA starts, so in
    a subprocess): the port is held as to the default run, and each row's
    first difference is still a near-tie. So the differences come from
    the order of the f32 sums in the products, not from bf16 values that
    XLA keeps in f32."""
    root = str(Path(__file__).resolve().parents[1])
    out = tmp_path / "grid.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c",
                    _EXACT_XLA.format(root=root, out=str(out))],
                   cwd=root, env=env, check=True, timeout=600)
    _hold_to_jax(False, 8, 1, np.load(out))


def test_bf16_sampler_swap_matches_jax():
    """A bf16 Sampler's swap (K3 route, fixed batch 4, CPU) against JAX
    encode -> posterior means -> the JAX bf16 K3 decode: the same means and
    the same grids."""
    jbf, _ = _weights(False)
    jp = jax_params(seed=0)
    pr1, c1 = requests(3, seed=11)
    pr2, c2 = requests(3, seed=12)
    s = Sampler(port_params(jp), CFG, frame_decoder="frame", fixed_batch=4,
                device="cpu")
    got = s.swap(pr1, pr2, c1, c2, fix_rhy=True, fix_chd=False)
    d_chd, d_rhy = jdv.encode(jax.tree_util.tree_map(jnp.asarray, jp), JCFG,
                              jnp.asarray(pr1), jnp.asarray(c2))
    t_chd, t_rhy = s.encode(pr1, c2)
    for a, b in ((t_chd.mean, d_chd.mean), (t_rhy.mean, d_rhy.mean)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    z = jnp.concatenate([d_chd.mean, d_rhy.mean], -1).astype(jnp.bfloat16)
    want = jptd.decode_grid(jbf["dec"], JCFG, z, frame_decoder="pallas",
                            interpret=True)
    assert got.dtype == np.int32 and got.shape == (3, 32, K - 1, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert s.fw.w_hh.dtype == BF and s.fw.gi_d.dtype == torch.float32


def test_jax_package_bf16_routes():
    """What the port's bf16 serving is held to, read from the JAX package:
    its K4 (``"pallas_full"``) raises on bf16 params, so the port's K4
    route refuses bf16; its XLA route raises on bf16 numpy leaves and runs
    on ``jnp`` leaves; and its own bf16 routes, XLA scan and Pallas K3, do
    not decode the same grids (read: 0.99436 of entries at B=16), which is
    why a whole bf16 decode is held to >= 0.999 with near-tie first
    differences and not to equality."""
    jbf, _ = _weights(False)
    z = jnp.asarray(np.random.RandomState(0).randn(16, TINY.z_dim),
                    jnp.bfloat16)
    with pytest.raises(TypeError, match="carry"):
        jptd.decode_grid(jbf["dec"], JCFG, z, frame_decoder="pallas_full",
                         interpret=True)
    with pytest.raises(TypeError, match="carry"):
        jptd.decode_grid(jcast(jax_params(seed=0), jnp.bfloat16)["dec"],
                         JCFG, z, frame_decoder="xla")
    xla = np.asarray(jptd.decode_grid(jbf["dec"], JCFG, z,
                                      frame_decoder="xla"))
    k3 = np.asarray(jptd.decode_grid(jbf["dec"], JCFG, z,
                                     frame_decoder="pallas", interpret=True))
    print(f"JAX bf16 routes, XLA scan vs Pallas K3: agreement "
          f"{(xla == k3).mean()}")
    assert (xla == k3).mean() >= 0.99


def test_full_route_and_kernel_checks_refuse_what_jax_lacks():
    """``frame_decoder="full"`` (K4) refuses bf16 before any launch, naming
    the JAX K4's missing bf16 mode; K3's input check takes one storage
    dtype (float32 or bfloat16) with f32 constants and nothing else, and
    K4's float32 alone."""
    tp = _weights(False)[1]
    z = torch.zeros(2, CFG.z_dim)
    for call in (lambda: tdv.decode_z(tp, CFG, z[:, :8], z[:, 8:]),
                 lambda: tptd.decode_grid(tp["dec"], CFG, z.to(BF)),
                 lambda: Sampler(tp, CFG, device="cpu")):
        with pytest.raises(NotImplementedError, match="K4 has no bf16 mode"):
            call()
    fw = _port_fw(False)
    dev = torch.device("cuda")
    h = torch.zeros(2, CFG.dec_time_hidden, dtype=BF)
    named = [("h_time", h, tuple(h.shape))]
    for dtype in (torch.float16, torch.float64):
        bad = fw._replace(w_slot=fw.w_slot.to(dtype))
        with pytest.raises(TypeError, match="w_slot"):
            build.check_inputs(bad, dev, named)
    with pytest.raises(TypeError, match="gi_d"):
        build.check_inputs(fw._replace(gi_d=fw.gi_d.to(BF)), dev, named)
    with pytest.raises(TypeError, match="h_time"):
        build.check_inputs(fw, dev, [("h_time", h.float(), tuple(h.shape))])
    with pytest.raises(TypeError, match="float32"):
        build.check_inputs(fw, dev, named, build.FULL_ENTRY)
    inputs = tptd.decode_inputs(tp["dec"], CFG, z.to(BF))
    with pytest.raises(TypeError, match="float32 only"):
        full_decoder.decode_grid_full(fw, SPEC, *inputs)
