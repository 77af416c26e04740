"""The port's Sampler and latent-control workflows against the JAX package
on the same weights, inputs and noise (CPU, tiny dims)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import sampler as sampler_mod
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.kernels import full_decoder
from pctd_tpu_torch.parallel.mesh import Mesh

from tests.torch_port_helpers import (JAX_TINY, TINY, jax_params,
                                      port_params, requests, t)


@pytest.fixture(scope="module")
def weights():
    jp = jax_params(seed=7)
    return jp, port_params(jp)


def test_interp_path_matches_jax():
    rng = np.random.RandomState(0)
    for z1, z2 in ((rng.randn(16), rng.randn(16)),
                   (np.ones(4), np.ones(4) * 3.0)):     # parallel: lerp
        np.testing.assert_allclose(tdv.interp_path(z1, z2, 7),
                                   jdv.interp_path(z1, z2, 7), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 5, 9])
def test_fixed_batch_padding_and_chunking_match_unpadded(weights, n):
    _, tp = weights
    pr, c = requests(n, seed=n)
    fixed = Sampler(tp, TINY, fixed_batch=4, device="cpu")
    free = Sampler(tp, TINY, device="cpu")
    a_chd, a_rhy = fixed.encode(pr, c)
    b_chd, b_rhy = free.encode(pr, c)
    for a, b in zip(a_chd + a_rhy, b_chd + b_rhy):
        assert a.shape == b.shape == (n, a.shape[-1])
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    got = fixed.swap(pr, pr, c, c, fix_rhy=True, fix_chd=True)
    assert got.shape == (n, 32, 15, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, free.reconstruct(pr, c))


def _noise(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_decode(jp, zc, zr):
    return np.asarray(jdv.decode_z(jp, JAX_TINY, jnp.asarray(zc),
                                   jnp.asarray(zr)))


@pytest.mark.parametrize("workflow", ["swap_fix_rhy", "swap_fix_chd",
                                      "posterior_sample", "prior_sample",
                                      "interp"])
def test_workflow_matches_jax(weights, workflow):
    """Each workflow gives the JAX package's grid when both get the same z:
    deterministic workflows directly, sampling ones through the same
    numpy noise (the port draws from a torch.Generator, whose draws the
    Sampler's own call is checked against)."""
    jp, tp = weights
    pr1, c1 = requests(3, seed=11)
    pr2, c2 = requests(3, seed=12)
    s = Sampler(tp, TINY, fixed_batch=2, device="cpu")
    if workflow.startswith("swap"):
        fix_rhy = workflow == "swap_fix_rhy"
        got = s.swap(pr1, pr2, c1, c2, fix_rhy=fix_rhy, fix_chd=not fix_rhy)
        want = np.asarray(jdv.swap(jp, JAX_TINY, jnp.asarray(pr1),
                                   jnp.asarray(pr2), jnp.asarray(c1),
                                   jnp.asarray(c2), fix_rhy, not fix_rhy))
        np.testing.assert_array_equal(got, want)
        return
    if workflow == "interp":
        got = s.interp(pr1, c1, pr2, c2, interp_chd=True, int_count=3)
        want = jdv.interp(jp, JAX_TINY, jnp.asarray(pr1), jnp.asarray(c1),
                          jnp.asarray(pr2), jnp.asarray(c2),
                          interp_chd=True, int_count=3)
        assert got.shape == (3, 3, 32, 15, 6)
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    # the same noise on both sides: eps_chd, eps_rhy
    e_chd = _noise((3, TINY.chd_z_dim), 1)
    e_rhy = _noise((3, TINY.txt_z_dim), 2)
    j_chd, j_rhy = jdv.encode(jp, JAX_TINY, jnp.asarray(pr1),
                              jnp.asarray(c1))
    t_chd, t_rhy = s.encode(pr1, c1)
    if workflow == "posterior_sample":
        scale = 0.5
        zc = lambda d, e: d.mean + d.std * scale * e
        zr = zc
        call = lambda g: s.posterior_sample(g, pr1, c1, scale=scale)
    else:
        zc = lambda d, e: d.mean + d.std * e
        zr = lambda d, e: e * 1.0
        call = lambda g: s.prior_sample(g, pr1, c1, sample_rhy=True)
    want = _jax_decode(jp, zc(j_chd, e_chd), zr(j_rhy, e_rhy))
    got = s.decode(zc(t_chd, t(e_chd)), zr(t_rhy, t(e_rhy)))
    np.testing.assert_array_equal(got, want)
    # the Sampler's own call draws eps_chd then eps_rhy from its generator
    g = torch.Generator().manual_seed(3)
    eps = torch.Generator().manual_seed(3)
    draws = (torch.randn(t_chd.mean.shape, generator=eps),
             torch.randn(t_rhy.mean.shape, generator=eps))
    np.testing.assert_array_equal(
        call(g), s.decode(zc(t_chd, draws[0]), zr(t_rhy, draws[1])))


def test_functional_api_matches_sampler(weights):
    """The pure-function workflows compute what the Sampler serves."""
    _, tp = weights
    pr1, c1 = requests(2, seed=21)
    pr2, c2 = requests(2, seed=22)
    s = Sampler(tp, TINY, device="cpu")
    np.testing.assert_array_equal(
        tdv.swap(tp, TINY, t(pr1), t(pr2), t(c1), t(c2), False, True)
        .numpy(),
        s.swap(pr1, pr2, c1, c2, fix_rhy=False, fix_chd=True))
    np.testing.assert_array_equal(
        tdv.interp(tp, TINY, t(pr1), t(c1), t(pr2), t(c2), interp_rhy=True,
                   int_count=2),
        s.interp(pr1, c1, pr2, c2, interp_rhy=True, int_count=2))
    for name in ("posterior_sample", "prior_sample"):
        a = getattr(tdv, name)(tp, TINY, torch.Generator().manual_seed(5),
                               t(pr1), t(c1))
        b = getattr(s, name)(torch.Generator().manual_seed(5), pr1, c1)
        np.testing.assert_array_equal(a.numpy(), b)


def _latents(n, seed):
    return (_noise((n, TINY.chd_z_dim), seed),
            _noise((n, TINY.txt_z_dim), seed + 1))


@pytest.mark.parametrize("cap", [None, 7])
@pytest.mark.parametrize("n,chunks", [(5, 1), (16, 1), (40, 3), (130, 9)])
def test_k4_route_counts_the_chunks_a_launch_decodes(weights, monkeypatch,
                                                     n, chunks, cap):
    """A fixed-batch decode on the K4 route: its 16-row chunks share
    launches, as many a launch as ``cap`` 16-row groups hold (None, the
    CPU's: all in one; 7 stands for the card's occupancy), and the grid is
    the unchunked decode's."""
    _, tp = weights
    monkeypatch.setattr(full_decoder, "groups_at_once", lambda *a: cap)
    s = Sampler(tp, TINY, fixed_batch=16, device="cpu")
    zc, zr = _latents(n, n)
    got = s.decode(zc, zr)
    launches = 1 if cap is None else -(-chunks // cap)
    assert (s.decoded_chunks, s.decode_launches) == (chunks, launches)
    np.testing.assert_array_equal(
        got, Sampler(tp, TINY, device="cpu").decode(zc, zr))


def test_unchunked_and_k3_route_count_a_launch_a_chunk(weights):
    _, tp = weights
    zc, zr = _latents(40, 3)
    free = Sampler(tp, TINY, device="cpu")
    frame = Sampler(tp, TINY, frame_decoder="frame", fixed_batch=16,
                    device="cpu")
    for s, counts in ((free, (1, 1)), (frame, (3, 3))):
        s.decode(zc, zr)
        s.decode(zc[:5], zr[:5])
        assert (s.decoded_chunks, s.decode_launches) == tuple(
            c + 1 for c in counts)


@pytest.mark.parametrize("fb,n,rows", [(4, 9, [32, 16]), (24, 30, [32, 32]),
                                       (24, 20, [24]), (None, 30, [30])])
def test_shared_launches_pad_each_chunk_to_whole_groups(weights,
                                                        monkeypatch, fb, n,
                                                        rows):
    """With a card's cap (here 2 groups, by hand), a chunk of a size that is
    not a multiple of 16 takes whole 16-row groups of its own in a shared
    launch: 9 rows at fixed batch 4 launch 32 and 16 rows, 30 at 24 (two
    chunks of two groups each, over the cap together) launch twice. A
    decode of one chunk launches on the chunk's own rows, unpadded: 20
    rows at 24 launch 24, an unchunked 30 launch 30."""
    _, tp = weights
    monkeypatch.setattr(full_decoder, "groups_at_once", lambda *a: 2)
    launched = []
    launch = full_decoder.decode_grid_full

    def counted(fw, spec, h0, *inputs):
        launched.append(h0.shape[0])
        return launch(fw, spec, h0, *inputs)

    monkeypatch.setattr(full_decoder, "decode_grid_full", counted)
    zc, zr = _latents(n, 7)
    s = Sampler(tp, TINY, fixed_batch=fb, device="cpu")
    got = s.decode(zc, zr)
    assert launched == rows and s.decode_launches == len(rows)
    np.testing.assert_array_equal(
        got, Sampler(tp, TINY, device="cpu").decode(zc, zr))


def test_sampler_rejects_bad_arguments(weights):
    _, tp = weights
    with pytest.raises(ValueError):
        Sampler(tp, TINY, frame_decoder="xla", device="cpu")
    with pytest.raises(ValueError):
        Sampler(tp, TINY, fixed_batch=0, device="cpu")
    with pytest.raises(ValueError):
        Sampler(tp, TINY, device="cpu").decode(np.zeros((0, 8)),
                                               np.zeros((0, 8)))


# --- the encode: op by op on the CPU, graph replays on the card -------------

def _posteriors(out):
    """The (chord, texture) posteriors' mean and std tensors, in order."""
    return [x for d in out for x in d]


def _op_by_op(s, pr, c):
    """What ``encode`` computes: ``disentangle_vae.encode`` of each
    zero-padded fixed-batch chunk, its real rows kept."""
    share, chunks = s._plan(len(pr))
    outs = [_posteriors(tdv.encode(s.params, TINY, *(
        sampler_mod._padded(a[part], share) for a in (t(pr), t(c)))))
        for _, (part,) in chunks]
    return [torch.cat([o[:take] for o, (take, _) in zip(col, chunks)])
            for col in zip(*outs)]


@pytest.mark.parametrize("fb,n", [(4, 3), (4, 9), (None, 9)])
def test_cpu_encode_runs_op_by_op_and_never_replays(weights, fb, n):
    _, tp = weights
    pr, c = requests(n, seed=30 + n)
    s = Sampler(tp, TINY, fixed_batch=fb, device="cpu")
    got = _posteriors(s.encode(pr, c))
    want = (_op_by_op(s, pr, c) if fb is not None
            else _posteriors(tdv.encode(tp, TINY, t(pr), t(c))))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert s.encode_replays == 0 and s._graphs == {}


@pytest.mark.parametrize("fb,n,chunks", [(4, 3, 1), (4, 8, 2), (4, 13, 4),
                                         (None, 13, 1)])
def test_encoded_chunks_count_as_decoded_chunks(weights, fb, n, chunks):
    _, tp = weights
    pr, c = requests(n, seed=n)
    s = Sampler(tp, TINY, fixed_batch=fb, device="cpu")
    d_chd, d_rhy = s.encode(pr, c)
    s.decode(d_chd.mean, d_rhy.mean)
    assert s.encoded_chunks == s.decoded_chunks == chunks
    assert s.encode_replays == 0


@pytest.mark.parametrize("take", [1, 3, 4])
def test_fill_rows_pads_as_chunks_does(weights, take):
    """A graph's static inputs, whatever they held, filled with a chunk's
    real rows equal the zero-padded chunk that ``_padded`` builds."""
    _, tp = weights
    g = torch.Generator().manual_seed(take)
    arrays = [torch.rand((4 + take,) + shape, generator=g)
              for shape in ((32, 128), (8, 36), (32, 16, 39))]
    s = Sampler(tp, TINY, fixed_batch=4, device="cpu")
    share, ((_, (first,)), (got_take, (last,))) = s._plan(4 + take)
    assert (share, got_take) == (4, take)
    for a in arrays:
        for rows in (last, first):
            chunk = sampler_mod._padded(a[rows], share)
            assert chunk.shape == (4,) + a.shape[1:]
            static = torch.full_like(chunk, float("nan"))
            sampler_mod.fill_rows(static, a[rows])
            assert torch.equal(static, chunk)


class _OpByOpGraph:
    """``EncodeGraph`` as the CPU can run it: static inputs and outputs,
    ``replay()`` overwriting the outputs with the encode of what the inputs
    hold, op by op. The inputs start as NaN, so a row left unfilled shows."""

    def __init__(self, encode, shapes, device, pool=None):
        self.encode, self.pool = encode, pool
        self.inputs = [torch.full(s, float("nan"), device=device)
                       for s in shapes]
        self.outputs = encode(*self.inputs)

    def replay(self):
        for static, new in zip(_posteriors(self.outputs),
                               _posteriors(self.encode(*self.inputs))):
            static.copy_(new)


def _replaying(monkeypatch):
    monkeypatch.setattr(sampler_mod, "_replays", lambda device: True)
    monkeypatch.setattr(sampler_mod, "EncodeGraph", _OpByOpGraph)


@pytest.mark.parametrize("devices", [1, 2])
@pytest.mark.parametrize("fb,n", [(4, 9), (4, 8), (8, 3)])
def test_replayed_encode_gives_each_device_its_share(weights, monkeypatch,
                                                     devices, fb, n):
    """The replay path's bookkeeping (``_replays`` and the graph swapped
    for a CPU stand-in): each device's graph takes its share of each
    zero-padded chunk and the real rows come back in order, bit-equal to
    the op-by-op encode over the same devices; one graph a device, one
    replay a device and chunk; a result outlives the next replay."""
    _, tp = weights
    mesh = Mesh((torch.device("cpu"),) * devices)
    pr, c = requests(n, seed=40 + n)
    pr2, c2 = requests(n, seed=50 + n)
    plain = Sampler(tp, TINY, fixed_batch=fb, mesh=mesh)
    want, want2 = (_posteriors(plain.encode(*r)) for r in ((pr, c),
                                                           (pr2, c2)))
    _replaying(monkeypatch)
    s = Sampler(tp, TINY, fixed_batch=fb, mesh=mesh)
    got = _posteriors(s.encode(pr, c))
    got2 = _posteriors(s.encode(pr2, c2))
    for a, b in zip(got + got2, want + want2):
        assert torch.equal(a, b)
    chunks = -(-n // fb)
    assert s.encoded_chunks == s.encode_replays == 2 * chunks * devices
    assert sorted(k[0] for k in s._graphs) == list(range(devices))


def test_load_params_empties_the_graph_cache(weights, monkeypatch):
    """New weights drop the graphs; the next encode captures again and
    reads the new weights, as a fresh Sampler on them does."""
    _, tp = weights
    new = port_params(jax_params(seed=8))
    pr, c = requests(6, seed=9)
    want = _posteriors(Sampler(new, TINY, fixed_batch=4,
                               device="cpu").encode(pr, c))
    _replaying(monkeypatch)
    s = Sampler(tp, TINY, fixed_batch=4, device="cpu")
    old = _posteriors(s.encode(pr, c))
    assert len(s._graphs) == 1
    s.load_params(new)
    assert s._graphs == {}
    got = _posteriors(s.encode(pr, c))
    assert len(s._graphs) == 1
    for a, b, o in zip(got, want, old):
        assert torch.equal(a, b) and not torch.equal(a, o)
