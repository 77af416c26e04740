"""The CUDA kernels against their plain PyTorch versions on a CUDA card: the
decode kernels K3/K4, and the train-frame pair K1 (forward) and K2
(backward, against autograd of the plain forward) in loss mode and in
logits-out mode.

Skipped without a card. The card's machine has no JAX, so this file imports
only torch and pctd_tpu_torch, and runs there without the JAX test conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import copy

import numpy as np
import pytest
import torch

from pctd_tpu_torch.config import ModelConfig, tiny_model_config
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models import pianotree_decoder as ptd
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.kernels import ar_decoder, full_decoder, train_frame

pytestmark = pytest.mark.gpu

AGREE = 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(cfg, device, eos_bias=None):
    params = dv.init_params(cfg, seed=1, device=device)
    if eos_bias is not None:
        params = copy.deepcopy(params)
        params["dec"]["pitch_out"]["w"][:, cfg.pianotree.pitch_eos] *= 3.0
        params["dec"]["pitch_out"]["b"][cfg.pianotree.pitch_eos] += eos_bias
    return params, ar_decoder.folded_frame_weights(params["dec"], cfg)


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("B", [37, 128])
def test_frame_kernel_matches_plain(cuda, width, B):
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    params, fw = _model(cfg, cuda, eos_bias=0.0)
    g = torch.Generator(device=cuda).manual_seed(B)
    h = torch.randn(B, cfg.dec_time_hidden, device=cuda, generator=g) * 0.6
    sos = ptd.decode_inputs(params["dec"], cfg,
                            torch.zeros(B, cfg.z_dim, device=cuda)).sos_emb
    before = ar_decoder.frame_decode.launches
    got = ar_decoder.frame_decode(fw, cfg.pianotree, h, sos)
    want = ar_decoder.frame_decode_plain(fw, cfg.pianotree, h, sos)
    assert ar_decoder.frame_decode.launches == before + 1
    for i in (0, 1, 3):
        assert got[i].dtype == torch.int32
        assert (got[i] == want[i]).float().mean().item() >= AGREE
    rows = ((got[0] == want[0]).all(1) & (got[1] == want[1]).flatten(1)
            .all(1) & (got[3] == want[3]))
    assert rows.any()
    assert (got[2] - want[2]).abs()[rows].max().item() <= 1e-4


@pytest.mark.parametrize("width,B", [("tiny", 5), ("canonical", 128)])
def test_full_kernel_matches_plain(cuda, width, B):
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    params, fw = _model(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    z = torch.randn(B, cfg.z_dim, device=cuda, generator=g)
    inputs = ptd.decode_inputs(params["dec"], cfg, z)
    got = full_decoder.decode_grid_full(fw, cfg.pianotree, *inputs)
    want = full_decoder.decode_grid_full_plain(fw, cfg.pianotree, *inputs)
    assert got.shape == want.shape == (B, 32, 15, 6)
    assert (got == want).float().mean().item() >= AGREE


def test_sampler_serves_through_the_kernels(cuda):
    cfg = tiny_model_config()
    params, _ = _model(cfg, cuda)
    rng = np.random.RandomState(0)
    pr = (rng.rand(9, 32, 128) < 0.02).astype(np.float32) * 2
    c = rng.rand(9, 8, 36).astype(np.float32)
    k4 = full_decoder.decode_grid_full.launches
    full = Sampler(params, cfg, fixed_batch=4).swap(pr, pr, c, c, True, True)
    assert full_decoder.decode_grid_full.launches == k4 + 3
    k3 = ar_decoder.frame_decode.launches
    frame = Sampler(params, cfg, frame_decoder="frame",
                    fixed_batch=4).swap(pr, pr, c, c, True, True)
    assert ar_decoder.frame_decode.launches == k3 + 3 * 32
    assert full.shape == (9, 32, 15, 6)
    assert (full == frame).mean() >= AGREE


def test_kernel_refuses_weights_on_another_device(cuda):
    cfg = tiny_model_config()
    params, fw = _model(cfg, "cpu")
    h = torch.zeros(2, cfg.dec_time_hidden, device=cuda)
    sos = torch.zeros(2, cfg.note_emb_size, device=cuda)
    with pytest.raises(ValueError):
        ar_decoder.frame_decode(fw, cfg.pianotree, h, sos)


# --- training slice: K1 (forward + fused CE) and K2 (backward) -------------

def _frame_case(cfg, device, B, seed, eos_bias=None):
    """Decoder weights (grad-enabled) and one frame's inputs on ``device``."""
    params, _ = _model(cfg, device, eos_bias)
    dec = params["dec"]
    spec = cfg.pianotree
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(s, device=device, generator=g)
    ri = lambda hi, *s: torch.randint(0, hi, s, device=device, generator=g,
                                      dtype=torch.int32)
    inputs = dict(frame_h=rn(B, cfg.dec_time_hidden) * 0.6,
                  x_emb=rn(B, K, cfg.note_emb_size) * 0.5,
                  coins=ri(2, K - 1), gt_pitch=ri(P + 1, B, K - 1),
                  gt_dur=ri(3, B, K - 1, W))
    return dec, inputs


def _agreeing_rows(cw, spec, inp):
    """Rows whose pitch, dur bits and lengths agree between K1 and the plain
    version, and the forward outputs of both."""
    got = train_frame.frame_fwd(cw, spec, **inp, stash=True)
    want = train_frame.frame_recon_plain(cw, spec, **inp)
    dec = torch.cat([want.pitch[..., None], want.bits], -1)
    rows = (got[3] == dec).flatten(1).all(1) & (got[2] == want.lengths)
    return rows, got, want


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("B", [37, 128])
@pytest.mark.parametrize("eos_bias", [None, 0.1])
def test_train_fwd_kernel_matches_plain(cuda, width, B, eos_bias):
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    dec, inp = _frame_case(cfg, cuda, B, seed=B, eos_bias=eos_bias)
    cw = train_frame.core_weights(dec, cfg)
    before = train_frame.frame_fwd.launches
    with torch.no_grad():
        rows, got, want = _agreeing_rows(cw, cfg.pianotree, inp)
    assert train_frame.frame_fwd.launches == before + 1
    assert rows.float().mean().item() >= AGREE
    st = got[4]
    assert (got[1] - want.summary).abs()[rows].max().item() <= 1e-4
    assert (st.hs - want.hs).abs()[:, rows].max().item() <= 1e-4
    # nums sum over rows: compare them on the rows whose decisions agree
    sub = {k: (v if k == "coins" else v[rows]) for k, v in inp.items()}
    with torch.no_grad():
        nums = train_frame.frame_fwd(cw, cfg.pianotree, **sub, stash=False)[0]
        want_nums = train_frame.frame_recon_plain(cw, cfg.pianotree,
                                                  **sub).nums
    rel = (nums - want_nums).abs() / want_nums.abs().clamp(min=1e-30)
    assert rel.max().item() <= 1e-5


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("B", [5, 128])
def test_train_bwd_kernel_matches_autograd(cuda, width, B):
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    spec = cfg.pianotree
    dec, inp = _frame_case(cfg, cuda, B, seed=7 + B, eos_bias=0.1)
    with torch.no_grad():
        rows, _, _ = _agreeing_rows(train_frame.core_weights(dec, cfg), spec,
                                    inp)
    assert rows.any()
    inp = {k: (v[rows] if k not in ("coins",) else v) for k, v in inp.items()}
    g = torch.Generator(device=cuda).manual_seed(3)
    g_nums = torch.rand(1 + spec.dur_width, device=cuda, generator=g)
    g_summ = torch.randn(int(rows.sum()), 2 * cfg.dec_emb_hidden,
                         device=cuda, generator=g)

    def grads(plain):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in train_frame.core_weights(dec, cfg)]
        cw = train_frame.CoreWeights(*leaves)
        fh = inp["frame_h"].clone().requires_grad_(True)
        xe = inp["x_emb"].clone().requires_grad_(True)
        args = (cw, spec, fh, xe, inp["coins"], inp["gt_pitch"],
                inp["gt_dur"])
        if plain:
            out = train_frame.frame_recon_plain(*args)
            nums, summ = out.nums, out.summary
        else:
            nums, summ = train_frame.frame_recon(*args)
        ((nums * g_nums).sum() + (summ * g_summ).sum()).backward()
        return [t.grad for t in leaves] + [fh.grad, xe.grad]

    k2a, k2b = train_frame.frame_bwd.launches, \
        train_frame.weight_grads.launches
    got = grads(plain=False)
    assert train_frame.frame_bwd.launches == k2a + 1
    assert train_frame.weight_grads.launches == k2b + 1
    want = grads(plain=True)
    names = list(train_frame.CoreWeights._fields) + ["frame_h", "x_emb"]
    for name, a, b in zip(names, got, want):
        tol = 1e-4 * (1.0 + b.abs().max().item())
        assert (a - b).abs().max().item() <= tol, name


# --- logits-out mode: K1 (logits out) and K2 (given logit cotangents) ------

def _core_inputs(inp):
    return {k: inp[k] for k in ("frame_h", "x_emb", "coins")}


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("B", [37, 128])
@pytest.mark.parametrize("eos_bias", [None, 0.1])
def test_train_fwd_kernel_logits_out_matches_plain(cuda, width, B, eos_bias):
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    spec = cfg.pianotree
    dec, inp = _frame_case(cfg, cuda, B, seed=B + 1, eos_bias=eos_bias)
    cw = train_frame.core_weights(dec, cfg)
    before = train_frame.frame_core_fwd.launches
    with torch.no_grad():
        pitch, dur, summ, lens, decisions, st = train_frame.frame_core_fwd(
            cw, spec, **_core_inputs(inp), stash=False)
        want = train_frame.frame_core_plain(cw, spec, **_core_inputs(inp))
    assert train_frame.frame_core_fwd.launches == before + 1
    assert st is None
    plain_dec = torch.cat([
        want.pitch_logits.argmax(-1, keepdim=True).to(torch.int32),
        (want.dur_logits[..., 1] > want.dur_logits[..., 0]).to(torch.int32)],
        -1)
    assert torch.equal(decisions, plain_dec)
    assert torch.equal(lens, want.lengths)
    assert torch.equal(pitch.argmax(-1).to(torch.int32), decisions[..., 0])
    assert torch.equal((dur[..., 1] > dur[..., 0]).to(torch.int32),
                       decisions[..., 1:])
    for a, b in ((pitch, want.pitch_logits), (dur, want.dur_logits),
                 (summ, want.summary)):
        assert (a - b).abs().max().item() <= 1e-4 * (
            1.0 + b.abs().max().item())


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("B", [5, 128])
def test_train_bwd_kernel_logits_out_matches_autograd(cuda, width, B):
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    spec = cfg.pianotree
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    dec, inp = _frame_case(cfg, cuda, B, seed=11 + B, eos_bias=0.1)
    with torch.no_grad():
        rows, _, _ = _agreeing_rows(train_frame.core_weights(dec, cfg), spec,
                                    inp)
    assert rows.any()
    inp = {k: (v[rows] if k != "coins" else v) for k, v in inp.items()}
    B = int(rows.sum())
    g = torch.Generator(device=cuda).manual_seed(5)
    g_pitch = torch.randn(B, K - 1, P, device=cuda, generator=g)
    g_dur = torch.randn(B, K - 1, W, 2, device=cuda, generator=g)
    g_summ = torch.randn(B, 2 * cfg.dec_emb_hidden, device=cuda, generator=g)

    def grads(plain):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in train_frame.core_weights(dec, cfg)]
        cw = train_frame.CoreWeights(*leaves)
        fh = inp["frame_h"].clone().requires_grad_(True)
        xe = inp["x_emb"].clone().requires_grad_(True)
        fn = (train_frame.frame_core_plain if plain
              else train_frame.frame_core)
        out = fn(cw, spec, fh, xe, inp["coins"])
        ((out.pitch_logits * g_pitch).sum() + (out.dur_logits * g_dur).sum()
         + (out.summary * g_summ).sum()).backward()
        return [t.grad for t in leaves] + [fh.grad, xe.grad]

    k2a, k2b = train_frame.frame_core_bwd.launches, \
        train_frame.weight_grads.launches
    got = grads(plain=False)
    assert train_frame.frame_core_bwd.launches == k2a + 1
    assert train_frame.weight_grads.launches == k2b + 1
    want = grads(plain=True)
    names = list(train_frame.CoreWeights._fields) + ["frame_h", "x_emb"]
    for name, a, b in zip(names, got, want):
        tol = 1e-4 * (1.0 + b.abs().max().item())
        assert (a - b).abs().max().item() <= tol, name


def test_frame_core_backward_needs_its_stash(cuda):
    cfg = tiny_model_config()
    dec, inp = _frame_case(cfg, cuda, 4, seed=1)
    leaves = [w.detach().clone().requires_grad_(True)
              for w in train_frame.core_weights(dec, cfg)]
    out = train_frame.FrameCore.apply(cfg.pianotree, False, inp["frame_h"],
                                      inp["x_emb"], inp["coins"], *leaves)
    with pytest.raises(RuntimeError, match="stash"):
        out[2].sum().backward()
