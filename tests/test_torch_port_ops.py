"""pctd_tpu_torch ops, config, init, weight bridge and encoders against the
JAX package on the same numpy inputs (CPU, tiny dims)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu import config as jcfg
from pctd_tpu import ops as jops
from pctd_tpu.models import chord_encoder as jchd
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models import pianotree_decoder as jptd
from pctd_tpu.models import texture_encoder as jtxt
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch import ops as tops
from pctd_tpu_torch.models import chord_encoder as tchd
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import pianotree_decoder as tptd
from pctd_tpu_torch.models import texture_encoder as ttxt
from pctd_tpu_torch.utils.weights import export_params, params_from_jax

from tests.torch_port_helpers import (JAX_TINY, TINY, jax_params,
                                      port_params, requests, t)

ATOL = 1e-5


def _gru_pair(seed, in_dim, hidden):
    rng = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(hidden)
    arrs = [rng.uniform(-s, s, shp).astype(np.float32)
            for shp in ((in_dim, 3 * hidden), (hidden, 3 * hidden),
                        (3 * hidden,), (3 * hidden,))]
    return (jops.GRUParams(*map(jnp.asarray, arrs)),
            tops.GRUParams(*map(torch.from_numpy, arrs)))


@pytest.mark.parametrize("cfg_name", ["canonical", "tiny"])
def test_config_copy_matches_jax(cfg_name):
    j = jcfg.ModelConfig() if cfg_name == "canonical" else JAX_TINY
    p = tcfg.ModelConfig() if cfg_name == "canonical" else TINY
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert (p.z_dim, p.pianotree.pitch_range, p.pianotree.note_size) == \
        (j.z_dim, j.pianotree.pitch_range, j.pianotree.note_size)


@pytest.mark.parametrize("op", ["cell", "scan", "scan_masked_reverse",
                                "bigru_last", "bigru_last_masked"])
def test_gru_ops_match_jax(op):
    B, T, D, H = 3, 7, 5, 6
    rng = np.random.RandomState(1)
    xs = rng.randn(B, T, D).astype(np.float32)
    h0 = rng.randn(B, H).astype(np.float32)
    lengths = np.array([7, 1, 4], np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    jf, tf = _gru_pair(2, D, H)
    jb, tb = _gru_pair(3, D, H)
    if op == "cell":
        want = jops.gru_cell_pre(jf, jops.input_proj(jf, xs[:, 0]), h0)
        got = tops.gru_cell_pre(tf, tops.input_proj(tf, t(xs[:, 0])), t(h0))
    elif op == "scan":
        want = jnp.concatenate(jops.gru_scan(jf, xs, h0)[0], -1)
        got = torch.cat(tuple(tops.gru_scan(tf, t(xs), t(h0))[0]), -1)
    elif op == "scan_masked_reverse":
        ys, hT = jops.gru_scan(jf, xs, h0, mask=mask, reverse=True)
        want = jnp.concatenate([ys.reshape(B, -1), hT], -1)
        ys, hT = tops.gru_scan(tf, t(xs), t(h0),
                               mask=torch.from_numpy(mask), reverse=True)
        got = torch.cat([ys.reshape(B, -1), hT], -1)
    elif op == "bigru_last":
        want = jops.bigru_last(jf, jb, xs)
        got = tops.bigru_last(tf, tb, t(xs))
    else:
        want = jops.bigru_last_masked(jf, jb, xs, lengths)
        got = tops.bigru_last_masked(tf, tb, t(xs),
                                     torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_diag_normal_rsample_draws_from_generator():
    d = tops.DiagNormal(torch.arange(6.0).reshape(2, 3),
                        torch.full((2, 3), 0.5))
    a = d.rsample(torch.Generator().manual_seed(4))
    eps = torch.randn((2, 3), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, d.mean + d.std * eps, rtol=0, atol=0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        return _flat(tree._asdict(), prefix)
    return {prefix: np.asarray(tree)}


def test_init_matches_jax_shapes_and_ranges():
    """Same tree, shapes and uniform bounds as the JAX init, the
    training-only chord decoder included."""
    jp = _flat(jax_params())
    tp = _flat(export_params(tdv.init_params(TINY, seed=3, device="cpu")))
    assert sorted(tp) == sorted(jp)
    for name, arr in tp.items():
        assert arr.shape == jp[name].shape and arr.dtype == np.float32, name
        parent = name.rsplit("/", 1)[0]
        if name.endswith(("init_input", "dur_sos")):
            lo, hi = 0.0, 1.0
        elif parent + "/w_hh" in tp:                  # GRU: 1/sqrt(H)
            hi = 1.0 / np.sqrt(tp[parent + "/w_hh"].shape[0])
            lo = -hi
        else:                                         # dense / conv HWIO
            w = tp[parent + "/w"]
            hi = 1.0 / np.sqrt(np.prod(w.shape[:-1]))
            lo = -hi
        assert arr.min() >= lo and arr.max() <= hi, name
        if arr.size >= 256:                           # fills the range
            assert arr.max() - arr.min() > 0.9 * (hi - lo), name
    # a seed names one model
    again = _flat(export_params(tdv.init_params(TINY, seed=3, device="cpu")))
    assert all(np.array_equal(again[k], tp[k]) for k in tp)


def test_weight_bridge_round_trip_is_bit_exact():
    jp = jax_params(seed=5)
    back = _flat(export_params(params_from_jax(jp, "cpu")))
    want = _flat(jp)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype
        assert back[k].tobytes() == v.tobytes(), k


def test_weight_bridge_takes_gru_entries_as_keys_or_attributes():
    _, tg = _gru_pair(0, 3, 2)
    arrs = {f: getattr(tg, f).numpy() for f in tg._fields}
    from_keys = params_from_jax({"g": arrs}, "cpu")["g"]
    from_attrs = params_from_jax({"g": jops.GRUParams(**arrs)}, "cpu")["g"]
    assert isinstance(from_keys, tops.GRUParams)
    for a, b, c in zip(from_keys, from_attrs, tg):
        assert torch.equal(a, c) and torch.equal(b, c)
    with pytest.raises(TypeError):
        params_from_jax({"w": np.zeros(3, np.float64)}, "cpu")


@pytest.mark.parametrize("encoder", ["chord", "texture"])
def test_encoders_match_jax(encoder):
    jp = jax_params(seed=1)
    tp = port_params(jp)
    pr, c = requests(3, seed=2)
    if encoder == "chord":
        want = jchd.apply(jp["chd_enc"], jnp.asarray(c))
        got = tchd.apply(tp["chd_enc"], t(c))
    else:
        want = jtxt.apply_conv(jp["txt_enc"], jnp.asarray(pr))
        got = ttxt.apply_conv(tp["txt_enc"], t(pr))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               atol=ATOL)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std),
                               atol=ATOL)


def test_encode_and_encode_chord_match_jax():
    jp = jax_params(seed=2)
    tp = port_params(jp)
    pr, c = requests(4, seed=3)
    j_chd, j_rhy = jdv.encode(jp, JAX_TINY, jnp.asarray(pr), jnp.asarray(c))
    t_chd, t_rhy = tdv.encode(tp, TINY, t(pr), t(c))
    for got, want in ((t_chd, j_chd), (t_rhy, j_rhy),
                      (tdv.encode_chord(tp, TINY, t(c)), j_chd)):
        np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                                   atol=ATOL)
        np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std),
                                   atol=ATOL)


def test_fold_inference_heads_match_jax():
    """The serving folds equal the JAX package's (its 128-lane pad columns
    in the combined dur projection are zeros, dropped in the port)."""
    jp = jax_params(seed=4)
    want = jptd.fold_inference_heads(jp["dec"], JAX_TINY)
    got = tptd.fold_inference_heads(port_params(jp)["dec"], TINY)
    assert sorted(got) == sorted(want)
    pad = 128
    for k, v in want.items():
        v = np.asarray(v)
        if k in ("w_dcomb", "b_dcomb", "w_dx0", "b_dx0"):
            v = v.reshape(-1, v.shape[-1])
            assert not v[:, 2:pad].any()
            v = np.concatenate([v[:, :2], v[:, pad:]], axis=-1)
        np.testing.assert_allclose(got[k].numpy().reshape(v.shape), v,
                                   atol=1e-6, err_msg=k)
