"""The train-frame path's plain PyTorch version (K1's plain forward, and
K2's plain version, autograd of it) against the JAX package on the CPU:
the forward against the Pallas kernel pair run in interpret mode, the
gradients against ``jax.grad`` of the XLA per-frame decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.models import pianotree_decoder as jptd
from pctd_tpu.ops import bigru_last_masked as j_bigru
from pctd_tpu.ops import losses as jl
from pctd_tpu.ops.pallas import train_frame as jtf
from pctd_tpu_torch.ops.kernels import train_frame as tf
from tests.torch_port_helpers import JAX_TINY, TINY, eos_biased, \
    jax_params, port_params, t

SPEC = TINY.pianotree
K, W, P = SPEC.max_simu_note, SPEC.dur_width, SPEC.pitch_range


def _inputs(B, seed):
    rng = np.random.RandomState(seed)
    return dict(
        frame_h=rng.randn(B, TINY.dec_time_hidden).astype(np.float32) * 0.8,
        x_emb=rng.randn(B, K, TINY.note_emb_size).astype(np.float32) * 0.5,
        coins=(rng.rand(K - 1) < 0.5).astype(np.int32),
        gt_pitch=rng.randint(0, P + 1, (B, K - 1)).astype(np.int32),
        gt_dur=rng.randint(0, 3, (B, K - 1, W)).astype(np.int32))


def _port(jp, inp, grad=False):
    dec = port_params(jp)["dec"]
    cw = tf.core_weights(dec, TINY)
    args = {k: torch.from_numpy(v) for k, v in inp.items()}
    return tf.frame_recon_plain(cw, SPEC, **args)


def _pallas(jp, inp):
    weights = jtf.core_weights(jp["dec"], JAX_TINY)
    B = inp["frame_h"].shape[0]
    (nums, summ, lengths), hs = jtf._fwd_call(
        JAX_TINY.pianotree, JAX_TINY.dec_emb_hidden,
        JAX_TINY.dec_notes_hidden, weights, inp["frame_h"], inp["x_emb"],
        inp["coins"][:, None], True, stash=True,
        gt=(inp["gt_pitch"], inp["gt_dur"].reshape(B, -1)))
    return np.asarray(nums[0, :1 + W]), np.asarray(summ), \
        np.asarray(lengths), np.asarray(hs)


@pytest.mark.parametrize("weights", ["seed", "eos_biased"])
def test_frame_recon_plain_matches_pallas_interpret(weights):
    inp = _inputs(6, seed=1)
    jp = jax_params(seed=0)
    if weights == "eos_biased":
        jp = eos_biased(jp, 0.8, lambda q: _port(q, inp).lengths.numpy())
    out = _port(jp, inp)
    nums, summ, lengths, hs = _pallas(jp, inp)
    np.testing.assert_array_equal(out.lengths.numpy(), lengths)
    np.testing.assert_allclose(out.nums.numpy(), nums, rtol=1e-5)
    np.testing.assert_allclose(out.summary.numpy(), summ, atol=1e-5)
    np.testing.assert_allclose(out.hs.numpy(), hs, atol=1e-5)


def _xla_frame_loss(dec, frame_h, x_emb, inp, g_nums, g_summ):
    """The XLA per-frame decode + masked-CE numerators, contracted with the
    cotangents: sum(g_nums * nums) + sum(g_summ * summary)."""
    coins_b = jnp.concatenate([jnp.zeros((1,), bool),
                               jnp.asarray(inp["coins"]) != 0])
    sos = jnp.zeros((frame_h.shape[0], x_emb.shape[-1]))
    pitch, dur, pred, lens = jptd._decode_notes(dec, JAX_TINY.pianotree,
                                                frame_h, x_emb, coins_b, sos)
    summ = j_bigru(dec["emb_fwd"], dec["emb_bwd"], pred, lens)

    def num(logits, gt, pad):
        mask = gt != pad
        return (jl._nll(logits, jnp.where(mask, gt, 0)) * mask).sum()

    nums = [num(pitch, inp["gt_pitch"], SPEC.pitch_pad)]
    nums += [num(dur[:, :, w], inp["gt_dur"][..., w], SPEC.dur_pad)
             for w in range(W)]
    return (jnp.stack(nums) * g_nums).sum() + (summ * g_summ).sum()


USED = ("time2notes", "notes_gru", "pitch_out", "dur_hid", "dur_gru",
        "dur_out", "note_emb", "dur_sos", "emb_fwd", "emb_bwd")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in tree
                for n, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    if hasattr(tree, "_fields"):
        return _leaves(tree._asdict(), prefix)
    return {prefix: tree}


@pytest.mark.parametrize("weights", ["seed", "eos_biased"])
def test_frame_recon_grads_match_jax(weights):
    inp = _inputs(6, seed=2)
    jp = jax_params(seed=3)
    if weights == "eos_biased":
        jp = eos_biased(jp, 0.8, lambda q: _port(q, inp).lengths.numpy())
    rng = np.random.RandomState(4)
    g_nums = rng.rand(1 + W).astype(np.float32)
    g_summ = rng.randn(6, 2 * TINY.dec_emb_hidden).astype(np.float32)
    jdec = {k: jp["dec"][k] for k in USED}
    jgrads = jax.grad(_xla_frame_loss, argnums=(0, 1, 2))(
        jdec, jnp.asarray(inp["frame_h"]), jnp.asarray(inp["x_emb"]), inp,
        g_nums, g_summ)

    dec = port_params(jp)["dec"]
    leaves = _leaves({k: dec[k] for k in USED})
    for v in leaves.values():
        v.requires_grad_(True)
    fh = t(inp["frame_h"]).requires_grad_(True)
    xe = t(inp["x_emb"]).requires_grad_(True)
    args = {k: torch.from_numpy(v) for k, v in inp.items()
            if k not in ("frame_h", "x_emb")}
    nums, summ = tf.frame_recon(tf.core_weights(dec, TINY), SPEC, fh, xe,
                                **args)
    ((nums * t(g_nums)).sum() + (summ * t(g_summ)).sum()).backward()

    want = _leaves(jgrads[0])
    assert sorted(want) == sorted(leaves)
    for name, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[name]),
                                   atol=2e-4, err_msg=name)
    np.testing.assert_allclose(fh.grad.numpy(), np.asarray(jgrads[1]),
                               atol=2e-4)
    np.testing.assert_allclose(xe.grad.numpy(), np.asarray(jgrads[2]),
                               atol=2e-4)


def test_core_weights_are_views_of_the_params():
    dec = port_params(jax_params())["dec"]
    cw = tf.core_weights(dec, TINY)
    th = TINY.dec_time_hidden
    assert cw.w_ih_frame.data_ptr() == dec["notes_gru"].w_ih.data_ptr()
    assert torch.equal(cw.w_ih_tok, dec["notes_gru"].w_ih[th:])
    assert torch.equal(cw.we_hh[1], dec["emb_bwd"].w_hh)
    d = tf.dims_of(cw, SPEC)
    assert (d.TH, d.NH, d.E, d.P, d.W, d.K) == (th, TINY.dec_notes_hidden,
                                                TINY.note_emb_size, P, W, K)


def test_wgrad_tasks_pair_stash_rows_with_their_cotangents():
    """The K2b task table (shared by the CUDA kernel and its plain version)
    pairs every stash row with its cotangent row: each weight gradient equals
    its direct einsum over slots, rows and duration steps."""
    cw = tf.core_weights(port_params(jax_params())["dec"], TINY)
    d = tf.dims_of(cw, SPEC)
    B = 3
    gen = torch.Generator().manual_seed(0)
    rand = lambda like: torch.randn(like.shape, generator=gen)
    st = tf.Stash(*(rand(a) for a in tf.new_stash(d, B, "cpu")))
    ct = tf.Cotangents(*(rand(a) for a in tf.new_cotangents(d, B, "cpu")))
    fh = torch.randn(B, d.TH, generator=gen)
    g = tf.CoreWeights(*(torch.full_like(w, float("nan")) for w in cw))
    tf.wgrad_plain(tf.wgrad_tasks(d, B, fh, st, ct, g))
    ein = torch.einsum
    want = {
        "w_t2n": fh.t() @ ct.dh0, "b_t2n": ct.dh0.sum(0),
        "w_ih_frame": fh.t() @ ct.d_gif, "b_ih": ct.d_gif.sum(0),
        "w_ih_tok": ein("sbi,sbo->io", st.tok, ct.d_gi),
        "w_hh": ein("sbi,sbo->io", st.hs[:-1], ct.d_gh),
        "b_hh": ct.d_gh.sum((0, 1)),
        "w_pitch": ein("sbi,sbo->io", st.hs[1:], ct.d_est),
        "b_pitch": ct.d_est.sum((0, 1)),
        "w_dhid": ein("sbi,sbo->io", torch.cat([st.hs[1:], st.est], -1),
                      ct.d_hd0),
        "b_dhid": ct.d_hd0.sum((0, 1)),
        "w_dih": ein("sbwi,sbwo->io", st.dtok, ct.d_gid),
        "b_dih": ct.d_gid.sum((0, 1, 2)),
        "w_dhh": ein("sbwi,sbwo->io", st.hd[:, :, :-1], ct.d_ghd),
        "b_dhh": ct.d_ghd.sum((0, 1, 2)),
        "w_dout": ein("sbwi,sbwo->io", st.hd[:, :, 1:], ct.d_log),
        "b_dout": ct.d_log.sum((0, 1, 2)),
        "w_emb": ein("sbi,sbo->io", st.emb_in, ct.d_emb),
        "b_emb": ct.d_emb.sum((0, 1)), "dur_sos": ct.d_sos.sum((0, 1)),
        "we_ih": ein("kbi,dkbo->dio", st.pred, ct.d_sgi),
        "we_hh": ein("dkbi,dkbo->dio", st.sh, ct.d_sgh),
        "be_ih": ct.d_sgi.sum((1, 2)), "be_hh": ct.d_sgh.sum((1, 2)),
    }
    assert sorted(want) == sorted(tf.CoreWeights._fields)
    for name, w in want.items():
        torch.testing.assert_close(getattr(g, name), w, rtol=1e-5,
                                   atol=1e-4, msg=name)
