"""The CUDA kernels against their plain PyTorch versions on a CUDA card: the
decode kernels K3 (float32 and bf16) and K4, and the train-frame pair K1
(forward) and K2 (backward, against autograd of the plain forward) in loss
mode and in logits-out mode, float32 and bf16; the pianotree texture
encoder's detrend on the card and its train step against the plain path;
the serving daemon's front end and Sampler on the card against the CPU
plain path, and its decode launches by fixed batch; a multi-chunk decode's
shared K4 launches against its chunks decoded alone, bit for bit; the
32-bar stretch (num_step=128): K4 and the K3 route against K4's plain
version, one train step through K1/K2a/K2b against the plain path in both
loss modes; and the
pianotree Sampler's encode with the detrended grid on the card; the
Sampler's fixed-batch encode as CUDA graph replays against the op-by-op
encode, bit for bit, and on the profiler's device timeline; the
Trainer's train step as a CUDA-graph replay against the eager step it
captures, bit for bit, and a run resumed from a checkpoint taken after
replays against the uninterrupted run; and the
program's spans (``utils/trace.py``), which get no mirror on the device
timeline and launch nothing.

Skipped without a card. The card's machine has no JAX, so this file imports
only torch and pctd_tpu_torch, and runs there without the JAX test conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""
import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from pctd_tpu_torch.config import ModelConfig, tiny_model_config
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models import pianotree_decoder as ptd
from pctd_tpu_torch.models import sampler as sampler_mod
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.kernels import ar_decoder, full_decoder, train_frame
from pctd_tpu_torch.train import schedules

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
    s = Sampler(params, cfg, fixed_batch=4)
    full = s.swap(pr, pr, c, c, True, True)
    # 3 chunks of 4 rows, a 16-row group each, share launches up to the cap
    cap = full_decoder.groups_at_once(s.fw, cfg.pianotree, cuda)
    assert full_decoder.decode_grid_full.launches == k4 + len(
        full_decoder.launch_runs(3, 4, cap))
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


# --- bf16 mode: K1, K2a and K2b with bf16 weights, inputs and stash --------

def _bf16_case(cfg, device, B, seed, eos_bias=None):
    """A :func:`_frame_case` with the decoder weights, frame_h and x_emb in
    bf16 (the weights through the precision policy's cast)."""
    from pctd_tpu_torch.utils.precision import cast_params

    dec, inp = _frame_case(cfg, device, B, seed, eos_bias)
    dec = cast_params(dec, torch.bfloat16)
    inp = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
           for k, v in inp.items()}
    return dec, inp


def _first_difference_margins(got_dec, want_dec, want):
    """For each row whose decisions differ, the plain version's margin at
    the first differing decision (pitch: max logit minus the kernel's pitch
    logit; bit: |logit1 - logit0|), over 1 + the largest |logit|."""
    B, S, C = got_dec.shape
    diff = (got_dec != want_dec).reshape(B, S * C)
    rows = diff.any(1).nonzero()[:, 0]
    first = diff[rows].int().argmax(1)
    k, c = first // C, first % C
    pl = want.pitch_logits.float()[rows, k]
    mx = pl.max(-1).values
    pick = pl.gather(-1, got_dec[rows, k, 0].long()[:, None])[:, 0]
    dl = want.dur_logits.float()[rows, k, (c - 1).clamp(min=0)]
    return torch.where(c == 0, (mx - pick) / (1 + mx.abs()),
                       (dl[:, 1] - dl[:, 0]).abs()
                       / (1 + dl.abs().amax(-1)))


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("B", [64, 128])
@pytest.mark.parametrize("logits", [False, True])
def test_train_fwd_kernel_bf16_matches_plain(cuda, width, B, logits):
    """K1 in bf16 against its plain version. The two sum in another f32
    order, so a few bf16 roundings and near-tie argmaxes differ (0.16% of
    the slots at B=512 on an H100): each row's first differing decision must
    be a near-tie of the plain logits (margin <= 1e-2), the decided slots
    agree on >= 0.99 (a case of B=64 has 960) and the lengths on >= 0.999;
    on the agreeing rows the values agree within 1e-2 x (1 + max|plain|)."""
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    spec = cfg.pianotree
    dec, inp = _bf16_case(cfg, cuda, B, seed=B + 2, eos_bias=0.1)
    cw = train_frame.core_weights(dec, cfg)
    assert train_frame.storage_dtype(cw) == torch.bfloat16
    with torch.no_grad():
        want = train_frame.frame_core_plain(cw, spec, **_core_inputs(inp))
        want_dec = torch.cat([
            want.pitch_logits.argmax(-1, keepdim=True).to(torch.int32),
            (want.dur_logits[..., 1] > want.dur_logits[..., 0]).to(
                torch.int32)], -1)
        if logits:
            pitch, dur, summ, lens, got_dec, _ = train_frame.frame_core_fwd(
                cw, spec, **_core_inputs(inp), stash=False)
            pairs = ((pitch, want.pitch_logits), (dur, want.dur_logits),
                     (summ, want.summary))
        else:
            nums, summ, lens, got_dec, st = train_frame.frame_fwd(
                cw, spec, **inp, stash=True)
            plain = train_frame.frame_recon_plain(cw, spec, **inp)
            assert torch.equal(plain.lengths, want.lengths)
            pairs = ((summ, plain.summary), (st.hs, plain.hs))
    slots = (got_dec == want_dec).all(-1)
    assert slots.float().mean().item() >= 0.99
    assert (lens == want.lengths).float().mean().item() >= 0.999
    margins = _first_difference_margins(got_dec, want_dec, want)
    assert len(margins) == 0 or margins.max().item() <= 1e-2
    rows = slots.all(1) & (lens == want.lengths)
    for a, b in pairs:
        assert a.dtype == b.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        if a.shape[0] != rows.shape[0]:      # hs: (K, B, NH)
            a, b = a[:, rows], b[:, rows]
        else:
            a, b = a[rows], b[rows]
        assert (a - b).abs().max().item() <= 1e-2 * (
            1.0 + b.abs().max().item())


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("logits", [False, True])
def test_train_bwd_kernel_bf16_matches_autograd(cuda, width, logits):
    """K2a + K2b in bf16 against autograd of the plain version: all 26
    gradients (bf16) within 1e-2 x (1 + max|plain|)."""
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    spec = cfg.pianotree
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    dec, inp = _bf16_case(cfg, cuda, 64, seed=13, eos_bias=0.1)
    with torch.no_grad():
        rows, _, _ = _agreeing_rows(train_frame.core_weights(dec, cfg), spec,
                                    inp)
    assert rows.any()
    inp = {k: (v[rows] if k != "coins" else v) for k, v in inp.items()}
    B = int(rows.sum())
    g = torch.Generator(device=cuda).manual_seed(9)
    bf = lambda *s: torch.randn(s, device=cuda, generator=g).to(
        torch.bfloat16)
    g_nums = torch.rand(1 + W, device=cuda, generator=g)
    g_pitch, g_dur, g_summ = bf(B, K - 1, P), bf(B, K - 1, W, 2), \
        bf(B, 2 * cfg.dec_emb_hidden)

    def grads(plain):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in train_frame.core_weights(dec, cfg)]
        cw = train_frame.CoreWeights(*leaves)
        fh = inp["frame_h"].clone().requires_grad_(True)
        xe = inp["x_emb"].clone().requires_grad_(True)
        if logits:
            fn = (train_frame.frame_core_plain if plain
                  else train_frame.frame_core)
            out = fn(cw, spec, fh, xe, inp["coins"])
            loss = ((out.pitch_logits * g_pitch).sum()
                    + (out.dur_logits * g_dur).sum()
                    + (out.summary * g_summ).sum())
        else:
            args = (cw, spec, fh, xe, inp["coins"], inp["gt_pitch"],
                    inp["gt_dur"])
            if plain:
                out = train_frame.frame_recon_plain(*args)
                nums, summ = out.nums, out.summary
            else:
                nums, summ = train_frame.frame_recon(*args)
            loss = (nums * g_nums).sum() + (summ * g_summ).sum()
        loss.float().backward()
        return [t.grad for t in leaves] + [fh.grad, xe.grad]

    k2b = train_frame.weight_grads.launches
    got = grads(plain=False)
    assert train_frame.weight_grads.launches == k2b + 1
    want = grads(plain=True)
    names = list(train_frame.CoreWeights._fields) + ["frame_h", "x_emb"]
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype == torch.bfloat16, name
        a, b = a.float(), b.float()
        tol = 1e-2 * (1.0 + b.abs().max().item())
        assert (a - b).abs().max().item() <= tol, name


def test_bf16_train_step_runs_the_bf16_kernels(cuda):
    """A bf16 train step at tiny width on the card goes through K1, K2a and
    K2b (32 launches each, bf16 weights at each), keeps the master params
    and Adam moments f32, and pins cuBLAS to f32 partial sums."""
    import dataclasses

    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.data.loaders import SegmentCorpus, make_loaders
    from pctd_tpu_torch.ops.kernels import build
    from pctd_tpu_torch.train import trainer as tr

    cfg = dataclasses.replace(tiny_model_config(), compute_dtype="bfloat16")
    rng = np.random.RandomState(0)
    pr = (rng.rand(8, 32, 128) < 0.03).astype(np.uint8) * 2
    chord = np.zeros((8, 8, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (8, 8))
    train_b, _ = make_loaders(SegmentCorpus(pr, chord),
                              SegmentCorpus(pr[:2], chord[:2]), 4, seed=0)
    run = tr.Trainer(cfg, TrainConfig(batch_size=4), train_b, device=cuda)
    dtypes = []
    launch = build.launch_train_fwd

    def record(cw, *a, **kw):
        dtypes.append(cw.w_hh.dtype)
        return launch(cw, *a, **kw)

    counts = [f.launches for f in (train_frame.frame_fwd,
                                   train_frame.frame_bwd,
                                   train_frame.weight_grads)]
    build.launch_train_fwd = record
    try:
        m = run.train_steps(1)[0]
    finally:
        build.launch_train_fwd = launch
    after = [f.launches for f in (train_frame.frame_fwd,
                                  train_frame.frame_bwd,
                                  train_frame.weight_grads)]
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert [b - a for a, b in zip(counts, after)] == [32, 32, 32]
    assert dtypes == [torch.bfloat16] * 32
    assert all(np.isfinite(v) for v in m.values())
    assert all(t.dtype == torch.float32 for t in run.leaves)
    assert all(t.dtype == torch.float32 for t in run.opt.mu + run.opt.nu)


# --- bf16 serving: K3 in bf16 ----------------------------------------------

def _bf16_frame_case(cfg, device, B, eos_bias):
    """bf16 decoder params (the precision policy's cast), their folds, and
    one frame's bf16 time hidden and sos embedding."""
    import dataclasses

    from pctd_tpu_torch.utils.precision import cast_params

    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params, _ = _model(cfg, device, eos_bias=eos_bias)
    dec = cast_params(params["dec"], torch.bfloat16)
    fw = ar_decoder.folded_frame_weights(dec, cfg)
    g = torch.Generator(device=device).manual_seed(B + 7)
    h = (torch.randn(B, cfg.dec_time_hidden, device=device, generator=g)
         * 0.6).to(torch.bfloat16)
    sos = ptd.decode_inputs(dec, cfg, torch.zeros(
        B, cfg.z_dim, device=device, dtype=torch.bfloat16)).sos_emb
    return cfg, fw, h, sos


@pytest.mark.parametrize("width", ["tiny", "canonical"])
@pytest.mark.parametrize("B", [37, 128])
def test_frame_kernel_bf16_matches_plain(cuda, width, B):
    """K3 in bf16 against its plain version: the arithmetic is f32 in both,
    so decisions and lengths agree on >= 0.999 (each row's first differing
    decision a near-tie of the plain logits, margin <= 1e-2), and the bf16
    summary within 1e-2 x (1 + max|plain|) on the agreeing rows."""
    cfg, fw, h, sos = _bf16_frame_case(
        tiny_model_config() if width == "tiny" else ModelConfig(), cuda, B,
        eos_bias=0.0)
    spec = cfg.pianotree
    assert fw.w_hh.dtype == torch.bfloat16 and fw.gi_d.dtype == torch.float32
    before = ar_decoder.frame_decode.launches
    got = ar_decoder.frame_decode(fw, spec, h, sos)
    want = ar_decoder.frame_decode_plain(fw, spec, h, sos)
    assert ar_decoder.frame_decode.launches == before + 1
    assert got[2].dtype == want[2].dtype == torch.bfloat16
    for i in (0, 1, 3):
        assert (got[i] == want[i]).float().mean().item() >= AGREE
    hid, gi = ar_decoder.frame_projection(fw, h)
    *_, pl, dl = ar_decoder.slot_chain_plain(fw, spec, hid, gi, logits=True)
    dec = lambda o: torch.cat([o[0][..., None], o[1]], -1)
    rows = (dec(got) == dec(want)).flatten(1).all(1) & (got[3] == want[3])
    if not rows.all():
        margins = _first_difference_margins(
            dec(got), dec(want),
            types.SimpleNamespace(pitch_logits=pl, dur_logits=dl))
        assert margins.max().item() <= 1e-2
    a, b = got[2][rows].float(), want[2][rows].float()
    assert (a - b).abs().max().item() <= 1e-2 * (1.0 + b.abs().max().item())


def test_sampler_serves_bf16_through_k3(cuda):
    """A bf16 Sampler serves through K3 alone (32 launches a chunk, bf16
    weights), its grids agree with the bf16 CPU plain path on >= 0.999,
    and the K4 route refuses bf16 when the Sampler is built."""
    import dataclasses

    cfg = dataclasses.replace(tiny_model_config(), compute_dtype="bfloat16")
    params, _ = _model(cfg, cuda)
    rng = np.random.RandomState(0)
    pr = (rng.rand(9, 32, 128) < 0.02).astype(np.float32) * 2
    c = rng.rand(9, 8, 36).astype(np.float32)
    with pytest.raises(NotImplementedError, match="K4 has no bf16 mode"):
        Sampler(params, cfg, fixed_batch=4)
    k3, k4 = (ar_decoder.frame_decode.launches,
              full_decoder.decode_grid_full.launches)
    s = Sampler(params, cfg, frame_decoder="frame", fixed_batch=4)
    assert s.fw.w_hh.dtype == torch.bfloat16
    got = s.swap(pr, pr, c, c, True, True)
    assert ar_decoder.frame_decode.launches == k3 + 3 * 32
    assert full_decoder.decode_grid_full.launches == k4
    cpu = Sampler(params, cfg, frame_decoder="frame", fixed_batch=4,
                  device="cpu").swap(pr, pr, c, c, True, True)
    assert got.shape == (9, 32, 15, 6) and got.dtype == np.int32
    assert (got == cpu).mean() >= AGREE


# --- K2b: the weight-gradient reduction ------------------------------------

def _wgrad_dims(cfg):
    spec = cfg.pianotree
    return train_frame.Dims(
        TH=cfg.dec_time_hidden, NH=cfg.dec_notes_hidden,
        DH=cfg.dec_dur_hidden, E=cfg.note_emb_size, EH=cfg.dec_emb_hidden,
        P=spec.pitch_range, W=spec.dur_width, K=spec.max_simu_note,
        eos=spec.pitch_eos, pitch_pad=spec.pitch_pad, dur_pad=spec.dur_pad)


def _wgrad_case(cfg, device, B, dtype, seed):
    """Decoder weights in ``dtype`` and one frame's random stash (in
    ``dtype``, its gates f32), cotangents and frame_h on ``device``, as
    weight_grads takes them."""
    params, _ = _model(cfg, device)
    cw = train_frame.CoreWeights(*(
        w.detach().to(dtype).contiguous()
        for w in train_frame.core_weights(params["dec"], cfg)))
    d = train_frame.dims_of(cw, cfg.pianotree)
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda t: torch.randn(t.shape, device=device, generator=g).to(
        t.dtype)
    st = train_frame.Stash(*(rn(t) for t in
                             train_frame.new_stash(d, B, device, dtype)))
    ct = train_frame.Cotangents(*(rn(t) for t in
                                  train_frame.new_cotangents(d, B, device)))
    fh = torch.randn(B, d.TH, device=device, generator=g).to(dtype)
    return cw, d, fh, st, ct


def _wgrad_f64(tasks):
    """Each task's (gW, gb) in f64 from the same rows."""
    out = []
    for tk in tasks:
        x, dy = train_frame.task_rows(tk)
        dy = dy.double()
        out.append((None if x is None else x.double().t() @ dy,
                    dy.sum(0) if tk.gb.numel() else None))
    return out


def _check_wgrad(tasks, plain_tasks):
    """K2b's outputs against wgrad_plain's and an f64 reference: f32 within
    1e-5 x (1 + max|f64|) of it and 1e-4 x (1 + max|plain|) of wgrad_plain;
    bf16 within 1e-2 x (1 + max|plain|), each element within one bf16 ulp
    of wgrad_plain's or, where a sum cancels below its f32 rounding error,
    within the f32 gate of the f64 reference."""
    for tk, tp, ref in zip(tasks, plain_tasks, _wgrad_f64(tasks)):
        outs = [(tk.gW, tp.gW, ref[0]), (tk.gb, tp.gb, ref[1])]
        for a, b, r in outs:
            if r is None:
                continue
            a, b = a.reshape(r.shape), b.reshape(r.shape)
            f32_tol = 1e-5 * (1.0 + r.abs().max().item())
            if a.dtype == torch.float32:
                assert (a.double() - r).abs().max().item() <= f32_tol
                assert (a - b).abs().max().item() <= 1e-4 * (
                    1.0 + b.abs().max().item())
            else:
                a32, b32 = a.float(), b.float()
                assert (a32 - b32).abs().max().item() <= 1e-2 * (
                    1.0 + b32.abs().max().item())
                _, e = torch.frexp(b32)
                ulp = torch.where(b32 == 0, torch.full_like(b32, 2.0 ** -133),
                                  torch.ldexp(torch.ones_like(b32),
                                              (e - 8).clamp(min=-133)))
                over = (a32 - b32).abs() > ulp
                assert ((a32.double() - r).abs()[over] <= f32_tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("width", ["tiny", "canonical"])
def test_wgrad_kernel_matches_plain(cuda, width, B, dtype):
    """K2b (one weight_grads call: the planned items, then the slice sums)
    against wgrad_plain and an f64 reference, f32 and bf16."""
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    cw, d, fh, st, ct = _wgrad_case(cfg, cuda, B, dtype, seed=B)
    before = train_frame.weight_grads.launches
    got = train_frame.weight_grads(cw, cfg.pianotree, fh, st, ct)
    assert train_frame.weight_grads.launches == before + 1
    assert all(g.dtype == dtype for g in got)
    want = train_frame.CoreWeights(*(torch.empty_like(w) for w in cw))
    tasks = train_frame.wgrad_tasks(d, B, fh, st, ct, got)
    plain = train_frame.wgrad_tasks(d, B, fh, st, ct, want)
    train_frame.wgrad_plain(plain)
    _check_wgrad(tasks, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_kernel_is_bit_identical_across_launches(cuda, dtype):
    """Two K2b launches on the same operands write the same bits (no
    atomics; the slices summed in slice order)."""
    cfg = ModelConfig()
    cw, _, fh, st, ct = _wgrad_case(cfg, cuda, 128, dtype, seed=5)
    a = train_frame.weight_grads(cw, cfg.pianotree, fh, st, ct)
    b = train_frame.weight_grads(cw, cfg.pianotree, fh, st, ct)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _ragged_tasks(device, dtype, g):
    """Reductions over every ragged width K2b meets (I in {0, 5, 64, 128,
    130, 135, 512, 1024}, O in {2, 5, 64, 128, 130, 192, 384, 512, 1536}),
    with and without a bias row, contiguous and strided sample rows
    (n_in > 1), and bf16 rows at odd element offsets."""
    def task(N, I, O, bias, n_in=1, pad=0):
        width = I + pad
        X = torch.randn(N * width + 1, device=device, generator=g).to(
            dtype)[1:] if I else torch.empty(0, device=device, dtype=dtype)
        DY = torch.randn(N * O, device=device, generator=g)
        gW = torch.empty(I, O, device=device, dtype=dtype)
        gb = torch.empty(O if bias else 0, device=device, dtype=dtype)
        return train_frame.WgradTask(
            X, DY, gW, gb, N, I, O, n_in, n_in * width if n_in > 1 else width,
            width if n_in > 1 else 0, n_in * O if n_in > 1 else O,
            O if n_in > 1 else 0)
    return [task(75, 0, 5, True), task(300, 5, 192, True),
            task(1000, 64, 2, True, n_in=5, pad=3),
            task(37, 128, 1536, False), task(300, 130, 64, False),
            task(600, 135, 128, True), task(37, 512, 130, True),
            task(1, 1024, 512, True), task(600, 5, 384, True, n_in=5),
            task(300, 1024, 5, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_kernel_takes_every_ragged_width(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(11)
    tasks = _ragged_tasks(cuda, dtype, g)
    plain = [tk._replace(gW=torch.empty_like(tk.gW),
                         gb=torch.empty_like(tk.gb)) for tk in tasks]
    train_frame.wgrad(tasks)
    train_frame.wgrad_plain(plain)
    _check_wgrad(tasks, plain)


def test_wgrad_refuses_what_the_kernel_cannot_take(cuda):
    """The K2b wrapper raises on an operand off the card, a cotangent of
    another dtype than f32, and a non-contiguous cotangent."""
    g = torch.Generator(device=cuda).manual_seed(0)
    tasks = _ragged_tasks(cuda, torch.float32, g)
    k = 3
    bad = [tasks[:k] + [tasks[k]._replace(X=tasks[k].X.cpu())],
           tasks[:k] + [tasks[k]._replace(DY=tasks[k].DY.to(torch.bfloat16))],
           tasks[:k] + [tasks[k]._replace(
               DY=tasks[k].DY.view(tasks[k].N, -1).t())]]
    for ts, err in zip(bad, (ValueError, TypeError, ValueError)):
        with pytest.raises(err):
            train_frame.wgrad(ts)


# --- K2a alone against its plain version on the same K1 stash --------------

def _k2a_case(cfg, device, B, dtype, logits, seed):
    """K1's stash of one frame in ``dtype`` (loss mode, or with ``logits``
    out), and random cotangents of the frame's outputs."""
    dec, inp = _frame_case(cfg, device, B, seed, eos_bias=0.1)
    spec = cfg.pianotree
    cw = train_frame.CoreWeights(*(t.detach().to(dtype) for t in
                                   train_frame.core_weights(dec, cfg)))
    inp = {k: (v.to(dtype) if v.is_floating_point() else v)
           for k, v in inp.items()}
    with torch.no_grad():
        if logits:
            lens, _, st = train_frame.frame_core_fwd(
                cw, spec, inp["frame_h"], inp["x_emb"], inp["coins"],
                stash=True)[3:]
        else:
            lens, st = train_frame.frame_fwd(cw, spec, **inp,
                                             stash=True)[2::2]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    rn = lambda *s: torch.randn(s, device=device, generator=g)
    S, W = spec.max_simu_note - 1, spec.dur_width
    cots = dict(d_nums=torch.rand(1 + W, device=device, generator=g),
                d_summ=rn(B, 2 * cfg.dec_emb_hidden).to(dtype))
    if logits:
        cots.update(d_pitch=rn(B, S, spec.pitch_range).to(dtype),
                    d_dur=rn(B, S, W, 2).to(dtype))
    return cw, inp, lens, st, cots


def _k2a(cw, spec, inp, lens, st, cots, plain=None):
    """K2a on a :func:`_k2a_case`; with ``plain`` ("f64" or "same"),
    frame_bwd_plain instead, on the weights, stash and cotangents cast to
    float64 or as they are."""
    logits = "d_pitch" in cots
    if plain is None:
        if logits:
            return train_frame.frame_core_bwd(
                cw, spec, inp["frame_h"], inp["coins"], lens, st,
                cots["d_pitch"], cots["d_dur"], cots["d_summ"])
        return train_frame.frame_bwd(
            cw, spec, inp["frame_h"], inp["coins"], inp["gt_pitch"],
            inp["gt_dur"], lens, st, cots["d_nums"], cots["d_summ"])
    cast = (lambda x: x.double()) if plain == "f64" else (lambda x: x)
    return train_frame.frame_bwd_plain(
        train_frame.CoreWeights(*map(cast, cw)), spec, cast(inp["frame_h"]),
        inp["coins"], inp["gt_pitch"], inp["gt_dur"], lens,
        train_frame.Stash(*map(cast, st)), cast(cots["d_nums"]),
        cast(cots["d_summ"]),
        *((cast(cots["d_pitch"]), cast(cots["d_dur"])) if logits else ()))


def _k2a_outputs(out):
    d_frame_h, d_x_emb, ct = out
    return [("d_frame_h", d_frame_h), ("d_x_emb", d_x_emb)] + list(
        zip(train_frame.Cotangents._fields, ct))


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 37, 128])
@pytest.mark.parametrize("width", ["tiny", "canonical"])
def test_k2a_matches_frame_bwd_plain(cuda, width, B, dtype, logits):
    """K2a against its plain version on the same K1 stash, every output and
    every cotangent: f32 within 1e-5 x (1 + max|ref|) of the f64 plain
    version (its products are f32-accurate); bf16 within 1e-2 x (1 +
    max|plain|) of the plain version in bf16 (f32 arithmetic, d_frame_h
    and d_x_emb rounded to bf16 once)."""
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    spec = cfg.pianotree
    case = _k2a_case(cfg, cuda, B, dtype, logits, seed=11 + B)
    counter = (train_frame.frame_core_bwd if logits
               else train_frame.frame_bwd)
    before = counter.launches
    got = _k2a(case[0], spec, *case[1:])
    assert counter.launches == before + 1
    f32 = dtype == torch.float32
    want = _k2a(case[0], spec, *case[1:], plain="f64" if f32 else "same")
    for (name, a), (_, b) in zip(_k2a_outputs(got), _k2a_outputs(want)):
        assert a.shape == b.shape, name
        assert a.dtype == (dtype if name in ("d_frame_h", "d_x_emb")
                           else torch.float32), name
        tol = (1e-5 if f32 else 1e-2) * (1.0 + b.abs().max().item())
        assert (a.double() - b.double()).abs().max().item() <= tol, name


@pytest.mark.parametrize("B", [37, 600])
def test_k2a_by_phase_and_cluster_size(cuda, B):
    """The launch options K2a is timed with: its phases launched one at a
    time, in order, give the bits of one launch; the note chain in clusters
    of 8 or 16 blocks meets the f64 gate either way (B=600: more clusters
    than the card holds at once, the last row group ragged)."""
    from pctd_tpu_torch.ops.kernels import build

    cfg = ModelConfig()
    spec = cfg.pianotree
    cw, inp, lens, st, cots = _k2a_case(cfg, cuda, B, torch.float32, False,
                                        seed=7)
    d = train_frame.dims_of(cw, spec)

    def launch(order=(15,), cluster=0):
        ct, d_frame_h, d_x_emb, dh_inj = train_frame.bwd_buffers(
            d, B, cuda, torch.float32)
        tensors = [inp["coins"], inp["gt_pitch"], inp["gt_dur"], lens,
                   cots["d_nums"], cots["d_summ"], d_frame_h, d_x_emb,
                   dh_inj]
        for phases in order:
            build.launch_train_bwd(cw, d, B, tensors, st, ct, phases=phases,
                                   cluster=cluster)
        return _k2a_outputs((d_frame_h, d_x_emb, ct))

    ph = build.K2A_PHASES
    apart = launch((ph["slots"], ph["summary"], ph["note"], ph["proj"]))
    for (name, a), (_, b) in zip(launch(), apart):
        assert torch.equal(a, b), name
    want = _k2a_outputs(_k2a(cw, spec, inp, lens, st, cots, plain="f64"))
    for C in (8, 16):
        for (name, a), (_, b) in zip(launch(cluster=C), want):
            tol = 1e-5 * (1.0 + b.abs().max().item())
            assert (a.double() - b).abs().max().item() <= tol, (C, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2a_is_bit_identical_across_launches(cuda, dtype):
    cfg = ModelConfig()
    case = _k2a_case(cfg, cuda, 128, dtype, False, seed=5)
    a = _k2a(case[0], cfg.pianotree, *case[1:])
    b = _k2a(case[0], cfg.pianotree, *case[1:])
    for (name, x), (_, y) in zip(_k2a_outputs(a), _k2a_outputs(b)):
        assert torch.equal(x, y), name


def test_k2a_refuses_what_the_kernel_cannot_take(cuda):
    """The K2a wrapper raises on tensors off the card, on weights of a dtype
    the kernels do not take, and on a cotangent of another dtype than the
    weights'."""
    cfg = tiny_model_config()
    spec = cfg.pianotree
    cw, inp, lens, st, cots = _k2a_case(cfg, cuda, 3, torch.float32, False,
                                        seed=2)
    cpu = lambda x: x.cpu()
    with pytest.raises(ValueError):
        _k2a(train_frame.CoreWeights(*map(cpu, cw)), spec,
             {k: cpu(v) for k, v in inp.items()}, cpu(lens),
             train_frame.Stash(*map(cpu, st)),
             {k: cpu(v) for k, v in cots.items()})
    f64 = lambda x: x.double()
    with pytest.raises(TypeError):
        _k2a(train_frame.CoreWeights(*map(f64, cw)), spec, inp, lens, st,
             cots)
    with pytest.raises(TypeError):
        _k2a(cw, spec, inp, lens, st,
             dict(cots, d_summ=cots["d_summ"].to(torch.bfloat16)))


# --- row-group K3/K4: ragged batches, both cluster sizes, bits, refusals ----

def _group_case(width, B, dtype, seed):
    """Weights (folded in ``dtype``) and one frame's time hidden and sos
    embedding, and the K4 inputs of random z, at ``width``."""
    import dataclasses

    from pctd_tpu_torch.utils.precision import cast_params

    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    cuda = torch.device("cuda")
    params, fw = _model(cfg, cuda, eos_bias=0.0)
    dec = params["dec"]
    if dtype == torch.bfloat16:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
        dec = cast_params(dec, dtype)
        fw = ar_decoder.folded_frame_weights(dec, cfg)
    g = torch.Generator(device=cuda).manual_seed(seed)
    h = (torch.randn(B, cfg.dec_time_hidden, device=cuda, generator=g)
         * 0.6).to(dtype)
    sos = ptd.decode_inputs(dec, cfg, torch.zeros(
        B, cfg.z_dim, device=cuda, dtype=dtype)).sos_emb
    z = torch.randn(B, cfg.z_dim, device=cuda, generator=g)
    return cfg, fw, h, sos, ptd.decode_inputs(params["dec"], cfg, z)


def _check_frame(cfg, fw, h, sos, got):
    """K3's outputs against its plain version: decisions and lengths agree
    on >= 0.999 and the summary within 1e-4 on agreeing rows (bf16: every
    row's first differing decision a near-tie, <= 1e-2 of the plain logits,
    and the summary within 1e-2 x (1 + max|plain|))."""
    spec = cfg.pianotree
    want = ar_decoder.frame_decode_plain(fw, spec, h, sos)
    for i in (0, 1, 3):
        assert got[i].dtype == torch.int32
        assert (got[i] == want[i]).float().mean().item() >= AGREE
    dec = lambda o: torch.cat([o[0][..., None], o[1]], -1)
    rows = (dec(got) == dec(want)).flatten(1).all(1) & (got[3] == want[3])
    a, b = got[2][rows].float(), want[2][rows].float()
    if fw.w_hh.dtype == torch.float32:
        assert (a - b).abs().max().item() <= 1e-4
        return
    if not rows.all():
        hid, gi = ar_decoder.frame_projection(fw, h)
        *_, pl, dl = ar_decoder.slot_chain_plain(fw, spec, hid, gi,
                                                 logits=True)
        margins = _first_difference_margins(
            dec(got), dec(want),
            types.SimpleNamespace(pitch_logits=pl, dur_logits=dl))
        assert margins.max().item() <= 1e-2
    assert (a - b).abs().max().item() <= 1e-2 * (1.0 + b.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("B", [1, 37, 300])
@pytest.mark.parametrize("width", ["tiny", "canonical"])
def test_group_frame_kernel_matches_plain(cuda, width, B, cluster, dtype):
    """The row-group K3 against its plain version at ragged batches (the
    last group padded: 1, 37 and 300 rows) in clusters of 8 and of 16."""
    cfg, fw, h, sos, _ = _group_case(width, B, dtype, seed=B)
    got = ar_decoder.frame_decode(fw, cfg.pianotree, h, sos, cluster=cluster)
    assert got[2].dtype == dtype
    _check_frame(cfg, fw, h, sos, got)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("width,B", [("tiny", 1), ("tiny", 37),
                                     ("tiny", 300), ("canonical", 1),
                                     ("canonical", 37)])
def test_group_full_kernel_matches_plain(cuda, width, B, cluster):
    """The row-group K4 against its plain version at ragged batches, in
    clusters of 8 and of 16."""
    cfg, fw, _, _, inputs = _group_case(width, B, torch.float32, seed=B)
    got = full_decoder.decode_grid_full(fw, cfg.pianotree, *inputs,
                                        cluster=cluster)
    want = full_decoder.decode_grid_full_plain(fw, cfg.pianotree, *inputs)
    assert got.shape == want.shape == (B, 32, 15, 6)
    assert (got == want).float().mean().item() >= AGREE


@pytest.mark.parametrize("kernel", ["K3", "K3 bf16", "K4"])
@pytest.mark.parametrize("B", [128, 512])
def test_group_kernels_are_bit_identical_across_launches(cuda, kernel, B):
    """The same inputs give the same bits: every sum runs in a fixed order
    (no atomics), in the plan's cluster size."""
    dtype = torch.bfloat16 if kernel == "K3 bf16" else torch.float32
    cfg, fw, h, sos, inputs = _group_case("canonical", B, dtype, seed=9)
    spec = cfg.pianotree
    for _ in range(2 if kernel == "K4" else 5):
        if kernel == "K4":
            a = [full_decoder.decode_grid_full(fw, spec, *inputs)]
            b = [full_decoder.decode_grid_full(fw, spec, *inputs)]
        else:
            a = ar_decoder.frame_decode(fw, spec, h, sos)
            b = ar_decoder.frame_decode(fw, spec, h, sos)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_group_phases_alone_and_together(cuda):
    """Each timing phase launches alone; the summary phase alone is the
    summary of that launch's own (zero) decisions and lengths, at both
    cluster sizes; the phases of a decode, launched together, give the bits
    of the wrapper's launch."""
    from pctd_tpu_torch.ops.kernels import build

    cfg, fw, h, sos, inputs = _group_case("canonical", 37, torch.float32, 3)
    spec = cfg.pianotree
    dims = build.decoder_dims(fw, spec)
    B, S, W = 37, spec.max_simu_note - 1, spec.dur_width
    out = lambda: [torch.empty((B, S), dtype=torch.int32, device=cuda),
                   torch.empty((B, S, W), dtype=torch.int32, device=cuda),
                   torch.empty((B, 2 * dims.EH), device=cuda),
                   torch.empty((B,), dtype=torch.int32, device=cuda)]
    for name, bit in build.DECODE_PHASES.items():
        if name != "time":
            build.launch(build.FRAME_ENTRY[torch.float32], fw, dims, B,
                         [h, sos, *out()], phases=bit)
        grid = torch.empty((B, spec.num_step, S, 1 + W), dtype=torch.int32,
                           device=cuda)
        build.launch(build.FULL_ENTRY[torch.float32], fw, dims, B,
                     [*inputs, grid], phases=bit)
    torch.cuda.synchronize()
    for cluster in (8, 16):
        alone = out()
        build.launch(build.FRAME_ENTRY[torch.float32], fw, dims, B,
                     [h, sos, *alone], phases=build.DECODE_PHASES["summary"],
                     cluster=cluster)
        pitch, bits, summ, lengths = alone
        assert not pitch.any() and not bits.any()
        assert (lengths == S).all()
        want = ar_decoder.summary_plain(fw, spec, pitch, bits, sos, lengths)
        assert (summ - want).abs().max().item() <= 1e-4
    together = out()
    build.launch(build.FRAME_ENTRY[torch.float32], fw, dims, B,
                 [h, sos, *together], phases=build.PHASES_ALL)
    for a, b in zip(together, ar_decoder.frame_decode(fw, spec, h, sos)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["K3", "K3 bf16", "K4"])
@pytest.mark.parametrize("cluster", [8, 16])
def test_group_kernels_give_the_same_bits_twice(cuda, kernel, cluster):
    """Two launches of K3 (f32, bf16) and K4 over 300 rows (two waves of
    clusters of 8, three of 16; the last group padded) give the same bits:
    every sum runs in a fixed order."""
    dtype = torch.bfloat16 if kernel == "K3 bf16" else torch.float32
    cfg, fw, h, sos, inputs = _group_case("canonical", 300, dtype, 11)
    if kernel == "K4":
        run = lambda: [full_decoder.decode_grid_full(
            fw, cfg.pianotree, *inputs, cluster=cluster)]
    else:
        run = lambda: ar_decoder.frame_decode(fw, cfg.pianotree, h, sos,
                                              cluster=cluster)
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_group_kernels_refuse_what_they_cannot_take(cuda):
    """A cluster size the kernels do not take (only 8 and 16), or widths
    whose blocks' shared memory would not fit (a 4096-wide time hidden:
    16 rows of it alone are 256 KiB), refuse the launch; so do bf16
    weights for K4, widths not a multiple of 4, weights that do not start
    16 bytes aligned, and tensors of another dtype than the weights'."""
    import dataclasses

    cfg, fw, h, sos, inputs = _group_case("canonical", 5, torch.float32, 1)
    spec = cfg.pianotree
    for cluster in (3, 32, 2, 4):
        with pytest.raises(RuntimeError, match="launch failed"):
            ar_decoder.frame_decode(fw, spec, h, sos, cluster=cluster)
    for cluster in (2, 4):
        with pytest.raises(RuntimeError, match="launch failed"):
            full_decoder.decode_grid_full(fw, spec, *inputs, cluster=cluster)
    wide = dataclasses.replace(tiny_model_config(), dec_time_hidden=4096)
    _, fww = _model(wide, cuda)
    hw = torch.zeros(2, 4096, device=cuda)
    sw = torch.zeros(2, wide.note_emb_size, device=cuda)
    for cluster in (8, 16):
        with pytest.raises(RuntimeError, match="launch failed"):
            ar_decoder.frame_decode(fww, wide.pianotree, hw, sw,
                                    cluster=cluster)
    with pytest.raises(RuntimeError, match="no cluster size"):
        ar_decoder.frame_decode(fww, wide.pianotree, hw, sw)
    shifted = torch.empty(fw.w_hh.numel() + 1, device=cuda)[1:]
    shifted.copy_(fw.w_hh.flatten())
    with pytest.raises(ValueError, match="aligned"):
        ar_decoder.frame_decode(fw._replace(w_hh=shifted.view_as(fw.w_hh)),
                                spec, h, sos)
    _, fwb, hb, sosb, _ = _group_case("canonical", 5, torch.bfloat16, 1)
    with pytest.raises(TypeError):
        full_decoder.decode_grid_full(fwb, spec, *inputs)
    with pytest.raises(TypeError):
        ar_decoder.frame_decode(fwb, spec, h, sos)
    odd = dataclasses.replace(tiny_model_config(), dec_time_hidden=18)
    params, fwo = _model(odd, cuda)
    with pytest.raises(ValueError, match="% 4"):
        ar_decoder.frame_decode(
            fwo, odd.pianotree, torch.zeros(2, 18, device=cuda),
            torch.zeros(2, odd.note_emb_size, device=cuda))


# --- K1's row groups: ragged groups, both cluster sizes, coins, bits --------

def _k1_case(B, seed, eos_bias, coins, dtype=torch.float32,
             width="canonical"):
    """Canonical-width K1 weights (no grad) and one frame's inputs, the
    coins all 0 (training's steady state), all 1 or mixed."""
    from pctd_tpu_torch.utils.precision import cast_params

    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    cuda = torch.device("cuda")
    dec, inp = _frame_case(cfg, cuda, B, seed, eos_bias)
    if coins != "mixed":
        inp["coins"] = torch.full_like(inp["coins"], int(coins == "one"))
    if dtype == torch.bfloat16:
        dec = cast_params(dec, dtype)
        inp = {k: (v.to(dtype) if v.is_floating_point() else v)
               for k, v in inp.items()}
    cw = train_frame.CoreWeights(
        *(w.detach().contiguous() for w in train_frame.core_weights(dec, cfg)))
    return cfg, cw, inp


def _k1_both_modes(cw, spec, inp, cluster):
    """K1 with its stash in loss mode and in logits-out mode, flat."""
    loss = train_frame.frame_fwd(cw, spec, **inp, stash=True,
                                 cluster=cluster)
    core = train_frame.frame_core_fwd(cw, spec, **_core_inputs(inp),
                                      stash=True, cluster=cluster)
    return [*loss[:4], *loss[4], *core[:5], *core[5]]


@pytest.mark.parametrize("coins,eos_bias", [("zero", 0.1), ("mixed", None),
                                            ("mixed", 0.1), ("one", 0.1)])
@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("B", [1, 17, 37, 128, 300])
def test_k1_group_kernel_matches_plain(cuda, B, cluster, coins, eos_bias):
    """The row-group K1 against its plain version in both modes at ragged
    and full groups (B = 1, 17, 37: one to three groups, the last part
    empty; 300: more groups than the card holds at once): decisions on
    >= 0.999 of rows (or, where a small batch falls short, each differing
    row's first difference a near-tie), lengths, the summary, hs and the
    logits within 1e-4 (x (1 + max|plain|) for logits), the CE numerators
    within 1e-5 on the agreeing rows; two launches give the same bits,
    stash included."""
    cfg, cw, inp = _k1_case(B, seed=B + cluster, eos_bias=eos_bias,
                            coins=coins)
    spec = cfg.pianotree
    with torch.no_grad():
        got = _k1_both_modes(cw, spec, inp, cluster)
        again = _k1_both_modes(cw, spec, inp, cluster)
        want = train_frame.frame_recon_plain(cw, spec, **inp)
        want_l = train_frame.frame_core_plain(cw, spec, **_core_inputs(inp))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    n_st = len(train_frame.Stash._fields)
    nums, summ, lens, dec = got[:4]
    st = train_frame.Stash(*got[4:4 + n_st])
    pitch, dur, summ_l, lens_l, dec_l = got[4 + n_st:9 + n_st]
    want_dec = torch.cat([want.pitch[..., None], want.bits], -1)
    rows = (dec == want_dec).flatten(1).all(1) & (lens == want.lengths)
    # f32 sums in another order than the plain version's flip only
    # near-ties: in a batch too small for the 0.999 bar, every differing
    # row's first difference must be within 1e-5 of a tie of the plain
    # logits
    margins = _first_difference_margins(dec, want_dec, want_l)
    assert rows.float().mean().item() >= AGREE or (
        margins.max().item() <= 1e-5), margins
    assert torch.equal(dec, dec_l) and torch.equal(lens, lens_l)
    assert torch.equal(pitch.argmax(-1).to(torch.int32), dec[..., 0])
    if not rows.any():
        return
    assert (summ - want.summary).abs()[rows].max().item() <= 1e-4
    assert (st.hs - want.hs).abs()[:, rows].max().item() <= 1e-4
    for a, b in ((pitch, want_l.pitch_logits), (dur, want_l.dur_logits),
                 (summ_l, want_l.summary)):
        assert (a - b)[rows].abs().max().item() <= 1e-4 * (
            1.0 + b.abs().max().item())
    sub = {k: (v if k == "coins" else v[rows]) for k, v in inp.items()}
    with torch.no_grad():
        nums = train_frame.frame_fwd(cw, spec, **sub, stash=False,
                                     cluster=cluster)[0]
        want_nums = train_frame.frame_recon_plain(cw, spec, **sub).nums
    rel = (nums - want_nums).abs() / want_nums.abs().clamp(min=1e-30)
    assert rel.max().item() <= 1e-5


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("B", [1, 37, 300])
def test_k1_group_kernel_bf16_matches_plain(cuda, B, cluster):
    """bf16: each row's first differing decision a near-tie of the plain
    logits, decided slots >= 0.99, lengths >= 0.99; two launches give the
    same bits."""
    cfg, cw, inp = _k1_case(B, seed=3 * B + cluster, eos_bias=0.1,
                            coins="zero", dtype=torch.bfloat16)
    spec = cfg.pianotree
    with torch.no_grad():
        got = _k1_both_modes(cw, spec, inp, cluster)
        again = _k1_both_modes(cw, spec, inp, cluster)
        want = train_frame.frame_core_plain(cw, spec, **_core_inputs(inp))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    dec, lens = got[3], got[2]
    want_dec = torch.cat([
        want.pitch_logits.argmax(-1, keepdim=True).to(torch.int32),
        (want.dur_logits[..., 1] > want.dur_logits[..., 0]).to(torch.int32)],
        -1)
    slots = (dec == want_dec).all(-1)
    assert slots.float().mean().item() >= 0.99
    assert (lens == want.lengths).float().mean().item() >= 0.99
    margins = _first_difference_margins(dec, want_dec, want)
    assert len(margins) == 0 or margins.max().item() <= 1e-2


def test_k1_phases_alone_and_together(cuda):
    """Each timing phase of K1 launches alone at both cluster sizes; the
    phases launched together give the bits of the wrapper's launch."""
    from pctd_tpu_torch.ops.kernels import build

    cfg, cw, inp = _k1_case(37, seed=5, eos_bias=0.1, coins="zero")
    spec = cfg.pianotree
    d = train_frame.dims_of(cw, spec)
    B, S, W = 37, spec.max_simu_note - 1, spec.dur_width
    i32 = dict(dtype=torch.int32, device=cuda)

    def outs():
        return [torch.empty(B, 1 + W, device=cuda),
                torch.empty(B, 2 * d.EH, device=cuda),
                torch.empty(B, **i32), torch.empty(B, S, 1 + W, **i32)]
    ins = [inp[k] for k in ("coins", "frame_h", "x_emb", "gt_pitch",
                            "gt_dur")]
    for cluster in (8, 16):
        for bit in build.K1_PHASES.values():
            build.launch_train_fwd(cw, d, B, [*ins, *outs()], None,
                                   phases=bit, cluster=cluster)
    torch.cuda.synchronize()
    together = outs()
    build.launch_train_fwd(cw, d, B, [*ins, *together], None)
    with torch.no_grad():
        want = train_frame.frame_fwd(cw, spec, **inp, stash=False)
    assert torch.equal(together[0].sum(0), want[0])
    for a, b in zip(together[1:], want[1:4]):
        assert torch.equal(a, b)


def test_k1_refuses_what_it_cannot_take(cuda):
    """A cluster size K1 does not take, widths whose blocks' shared memory
    would not fit (a 4096-wide notes GRU), and weights that do not start
    16 bytes aligned refuse the launch."""
    import dataclasses

    cfg, cw, inp = _k1_case(5, seed=1, eos_bias=None, coins="zero")
    spec = cfg.pianotree
    for cluster in (2, 4, 32):
        with pytest.raises(ValueError, match="clusters"):
            train_frame.frame_fwd(cw, spec, **inp, stash=False,
                                  cluster=cluster)
    wide = dataclasses.replace(tiny_model_config(), dec_notes_hidden=4096)
    dec, inw = _frame_case(wide, cuda, 2, 1)
    cww = train_frame.CoreWeights(*(w.detach().contiguous()
                                    for w in train_frame.core_weights(dec,
                                                                      wide)))
    for cluster in (8, 16):
        with pytest.raises(RuntimeError, match="launch failed"):
            train_frame.frame_fwd(cww, wide.pianotree, **inw, stash=False,
                                  cluster=cluster)
    shifted = torch.empty(cw.w_t2n.numel() + 1, device=cuda)[1:]
    shifted.copy_(cw.w_t2n.flatten())
    with pytest.raises(ValueError, match="aligned"):
        train_frame.frame_fwd(cw._replace(w_t2n=shifted.view_as(cw.w_t2n)),
                              spec, **inp, stash=False)


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("B", [37, 300])
def test_k1_per_row_kernel_matches_plain(cuda, B, rows):
    """K1's per-row kernel (the plan's pick where the row groups would run
    in waves) against the plain version in both modes: decisions on >=
    0.999 of rows (or each differing row's first difference a near-tie),
    the summary within 1e-4 on the agreeing rows; two launches give the
    same bits."""
    cfg, cw, inp = _k1_case(B, seed=7 * B + rows, eos_bias=0.1,
                            coins="mixed")
    spec = cfg.pianotree
    run = lambda: [*train_frame.frame_fwd(cw, spec, **inp, stash=True,
                                          rows=rows)[:4],
                   *train_frame.frame_core_fwd(cw, spec, **_core_inputs(inp),
                                               stash=False, rows=rows)[:5]]
    with torch.no_grad():
        got, again = run(), run()
        want = train_frame.frame_recon_plain(cw, spec, **inp)
        want_l = train_frame.frame_core_plain(cw, spec, **_core_inputs(inp))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    dec = torch.cat([want.pitch[..., None], want.bits], -1)
    rows_ok = (got[3] == dec).flatten(1).all(1) & (got[2] == want.lengths)
    margins = _first_difference_margins(got[3], dec, want_l)
    assert rows_ok.float().mean().item() >= AGREE or (
        margins.max().item() <= 1e-5), margins
    assert torch.equal(got[3], got[8]) and torch.equal(got[2], got[7])
    assert (got[1] - want.summary).abs()[rows_ok].max().item() <= 1e-4


def _pianotree_batch(B, seed):
    """Raw segments in the loader's format over all 12 shifts."""
    rng = np.random.RandomState(seed)
    pr = np.zeros((B, 32, 128), np.uint8)
    pr[rng.rand(B, 32, 128) < 0.03] = 2
    chord = np.zeros((B, 8, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (B, 8))
    chord[..., 1:13] = rng.randint(0, 2, (B, 8, 12))
    chord[..., 13] = rng.randint(0, 12, (B, 8))
    return pr, chord, (np.arange(B) % 12 - 6).astype(np.int32)


def test_device_detrend_matches_numpy(cuda):
    """The pianotree encoder's detrend on the card equals its numpy copy
    exactly, over every shift and with an all-zero root row."""
    from pctd_tpu_torch.data.detrend import (detrend_pianotree,
                                             detrend_pianotree_batch)
    from pctd_tpu_torch.train import trainer as tr

    cfg = tiny_model_config(txt_encoder="pianotree")
    pr, chord, shift = _pianotree_batch(48, seed=3)
    x, c, _, dt_x = tr.batch_features(
        *(torch.as_tensor(a, device=cuda) for a in (pr, chord, shift)), cfg)
    c[0, 2, :12] = 0.0
    dt_x = detrend_pianotree(x, c)
    want = detrend_pianotree_batch(x.cpu().numpy(), c.cpu().numpy())
    assert dt_x.dtype == torch.float32 and dt_x.shape == (48, 32, 16, 39)
    np.testing.assert_array_equal(dt_x.cpu().numpy(), want)


def test_pianotree_train_step_matches_plain_path(cuda, monkeypatch):
    """One pianotree-variant loss and gradient on the card through K1, K2a
    and K2b (32 launches each) against the same step with the plain frame
    versions in their place: metrics within 1e-5 relative, each gradient
    within 1e-4 x (1 + max|plain|)."""
    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.train import trainer as tr

    cfg = tiny_model_config(txt_encoder="pianotree")
    tcfg = TrainConfig(batch_size=16, accum_steps=1)
    params = dv.init_params(cfg, seed=2, device=cuda)
    leaves = tr.param_list(params)
    for t in leaves:
        t.requires_grad_(True)
    pr, chord, shift = _pianotree_batch(16, seed=4)
    feats = tr.batch_features(
        *(torch.as_tensor(a, device=cuda) for a in (pr, chord, shift)), cfg)
    step = lambda: tr.loss_and_grads(
        params, cfg, tcfg, schedules.train_params_at(0, tcfg),
        torch.Generator(device=cuda).manual_seed(5), *feats[:3], 1, feats[3])
    kernels = (train_frame.frame_fwd, train_frame.frame_bwd,
               train_frame.weight_grads)
    before = [f.launches for f in kernels]
    got_m, got_g = step()
    assert [f.launches - b for f, b in zip(kernels, before)] == [32] * 3

    def plain(*args):
        out = train_frame.frame_recon_plain(*args)
        return out.nums, out.summary

    monkeypatch.setattr(ptd.train_frame, "frame_recon", plain)
    want_m, want_g = step()
    assert [f.launches - b for f, b in zip(kernels, before)] == [32] * 3
    for k in dv.METRIC_NAMES:
        assert abs(got_m[k].item() - want_m[k].item()) <= 1e-5 * abs(
            want_m[k].item()), k
    for a, b in zip(got_g, want_g):
        tol = 1e-4 * (1.0 + b.abs().max().item())
        assert (a - b).abs().max().item() <= tol


def _daemon_songs(tmp_path):
    """Synthetic songs written as MIDI: "a" of 8 two-bar windows, "b" of
    20."""
    from pctd_tpu_torch.data.synthetic import synthetic_song

    files = {}
    for name, seed, bars in (("a", 0, 16), ("b", 1, 40)):
        files[name] = str(tmp_path / f"{name}.mid")
        synthetic_song(np.random.RandomState(seed),
                       n_bars=bars).write_midi(files[name])
    return files


def _daemon(params, cfg, device, fixed_batch=16, route="full"):
    from pctd_tpu_torch.cli import serve

    return serve.Server(Sampler(params, cfg, frame_decoder=route,
                                fixed_batch=fixed_batch, device=device),
                        cfg.pianotree, 64, cfg=cfg)


@pytest.mark.parametrize("width", ["tiny", "canonical"])
def test_daemon_on_the_card_matches_the_cpu_plain_path(cuda, tmp_path,
                                                       width):
    """The daemon's front end and Sampler on the card against the same on
    the CPU (the plain versions): a chord-fixed style transfer of 8
    windows."""
    cfg = tiny_model_config() if width == "tiny" else ModelConfig()
    params = dv.init_params(cfg, seed=1, device="cpu")
    files = _daemon_songs(tmp_path)
    grids = []
    for device in (cuda, torch.device("cpu")):
        server = _daemon(params, cfg, device)
        pm1, c1, _ = server._load(files["a"])
        pm2, c2, _ = server._load(files["b"])
        assert pm1.device.type == device.type
        grids.append(server.s.swap(pm1, pm2[:8], c1, c2[:8], fix_rhy=False,
                                   fix_chd=True))
    assert grids[0].shape == (8, 32, 15, 6)
    assert (grids[0] == grids[1]).mean() >= AGREE


@pytest.mark.parametrize("route", ["full", "frame"])
@pytest.mark.parametrize("fixed_batch", [16, 128])
def test_daemon_launches_by_fixed_batch(cuda, tmp_path, fixed_batch, route):
    """K4 once a run of as many fixed-batch chunks of decoded rows as the
    card decodes at once in 16-block clusters (K3 32 times a chunk on the
    frame route), and the other decode kernel never."""
    cfg = tiny_model_config()
    server = _daemon(dv.init_params(cfg, seed=1, device="cpu"), cfg, cuda,
                     fixed_batch, route)
    files = _daemon_songs(tmp_path)
    out = str(tmp_path / "out_%d.mid")
    for req, rows in (
            ({"op": "style_transfer", "content": files["a"],
              "style": files["b"]}, 8),
            ({"op": "variation", "input": files["b"], "seed": 1}, 20),
            ({"op": "interp", "a": files["a"], "b": files["b"],
              "count": 5}, 40)):
        full_decoder.decode_grid_full.launches = 0
        ar_decoder.frame_decode.launches = 0
        assert server.handle(dict(req, out=out))["ok"]
        chunks = -(-rows // fixed_batch)
        cap = full_decoder.groups_at_once(server.s.fw, cfg.pianotree, cuda)
        want = ((len(full_decoder.launch_runs(chunks, fixed_batch, cap)), 0)
                if route == "full"
                else (0, cfg.pianotree.num_step * chunks))
        assert (full_decoder.decode_grid_full.launches,
                ar_decoder.frame_decode.launches) == want


@pytest.mark.parametrize("rows", [40, 64, "past the cap"])
@pytest.mark.parametrize("fixed_batch", [16, 8, 24])
def test_shared_k4_launches_decode_the_bits_of_chunks_alone(cuda,
                                                            fixed_batch,
                                                            rows):
    """A multi-chunk decode through ``Sampler(fixed_batch=fb)`` at the
    canonical widths (its chunks in shared K4 launches) gives the grid of
    the same latents decoded one chunk a call (each a launch of its own, the
    one-chunk path), bit for bit; in as many launches as the card's cap of
    16-row groups at once asks for. 16 x cap + 5 rows take two launches or
    more."""
    cfg = ModelConfig()
    params, _ = _model(cfg, cuda)
    s = Sampler(params, cfg, fixed_batch=fixed_batch)
    cap = full_decoder.groups_at_once(s.fw, cfg.pianotree, cuda)
    assert cap >= 1
    n = 16 * cap + 5 if rows == "past the cap" else rows
    g = torch.Generator().manual_seed(n + fixed_batch)
    zc = torch.randn(n, cfg.chd_z_dim, generator=g)
    zr = torch.randn(n, cfg.txt_z_dim, generator=g)
    chunks = -(-n // fixed_batch)
    runs = full_decoder.launch_runs(chunks, fixed_batch, cap)
    k4 = full_decoder.decode_grid_full.launches
    got = s.decode(zc, zr)
    assert full_decoder.decode_grid_full.launches - k4 == len(runs)
    assert (s.decoded_chunks, s.decode_launches) == (chunks, len(runs))
    assert len(runs) < chunks and (rows != "past the cap" or len(runs) > 1)
    k4 = full_decoder.decode_grid_full.launches
    alone = np.concatenate([s.decode(zc[lo:lo + fixed_batch],
                                     zr[lo:lo + fixed_batch])
                            for lo in range(0, n, fixed_batch)])
    assert full_decoder.decode_grid_full.launches - k4 == chunks
    assert got.shape == (n, 32, 15, 6)
    np.testing.assert_array_equal(got, alone)


# --- the 32-bar stretch (num_step=128) and pianotree serving ----------------

def _stretch(cfg):
    from pctd_tpu_torch.config import ChordSpec, PianoTreeSpec

    return dataclasses.replace(cfg, pianotree=PianoTreeSpec(num_step=128),
                               chord=ChordSpec(num_step=32))


@pytest.mark.parametrize("width,B", [("tiny", 37), ("canonical", 16)])
def test_decode_kernels_at_the_stretch_match_plain(cuda, width, B):
    """K4 over 128 frames (one launch) and the K3 route (128 launches)
    against K4's plain version on the card."""
    cfg = _stretch(tiny_model_config() if width == "tiny" else ModelConfig())
    params, fw = _model(cfg, cuda, eos_bias=0.0)
    g = torch.Generator(device=cuda).manual_seed(7)
    z = torch.randn(B, cfg.z_dim, device=cuda, generator=g)
    inputs = ptd.decode_inputs(params["dec"], cfg, z)
    want = full_decoder.decode_grid_full_plain(fw, cfg.pianotree, *inputs)
    k4, k3 = (full_decoder.decode_grid_full.launches,
              ar_decoder.frame_decode.launches)
    got_k4 = full_decoder.decode_grid_full(fw, cfg.pianotree, *inputs)
    got_k3 = ptd.decode_grid(params["dec"], cfg, z, frame_decoder="frame",
                             fw=fw)
    assert (full_decoder.decode_grid_full.launches - k4,
            ar_decoder.frame_decode.launches - k3) == (1, 128)
    assert got_k4.shape == got_k3.shape == want.shape == (B, 128, 15, 6)
    for got in (got_k4, got_k3):
        assert (got == want).float().mean().item() >= AGREE


@pytest.mark.parametrize("fused_loss", [True, False])
def test_stretch_train_step_matches_plain_path(cuda, monkeypatch,
                                               fused_loss):
    """One stretch loss and gradient on the card through K1, K2a and K2b
    (128 launches each) against the same step with the plain frame
    versions in their place."""
    from pctd_tpu_torch.config import DataConfig, TrainConfig
    from pctd_tpu_torch.data.synthetic import synthetic_corpora
    from pctd_tpu_torch.train import trainer as tr

    cfg = _stretch(tiny_model_config(fused_loss=fused_loss))
    tcfg = TrainConfig(batch_size=16, accum_steps=1)
    params = dv.init_params(cfg, seed=2, device=cuda)
    for t in tr.param_list(params):
        t.requires_grad_(True)
    corpus, _ = synthetic_corpora(
        n_songs=4, seed=1, n_bars=16,
        cfg=dataclasses.replace(DataConfig(), num_bar=8, portion=3))
    idx = np.arange(16) % len(corpus)
    feats = tr.batch_features(
        torch.as_tensor(corpus.pr[idx], device=cuda),
        torch.as_tensor(corpus.chord[idx], device=cuda),
        torch.zeros(16, dtype=torch.int32, device=cuda), cfg)
    step = lambda: tr.loss_and_grads(
        params, cfg, tcfg, schedules.train_params_at(0, tcfg),
        torch.Generator(device=cuda).manual_seed(5), *feats[:3])
    kernels = ((train_frame.frame_fwd, train_frame.frame_bwd) if fused_loss
               else (train_frame.frame_core_fwd, train_frame.frame_core_bwd)
               ) + (train_frame.weight_grads,)
    before = [f.launches for f in kernels]
    got_m, got_g = step()
    assert [f.launches - b for f, b in zip(kernels, before)] == [128] * 3

    def plain(*args):
        out = train_frame.frame_recon_plain(*args)
        return out.nums, out.summary

    monkeypatch.setattr(ptd.train_frame, "frame_recon", plain)
    monkeypatch.setattr(ptd.train_frame, "frame_core",
                        train_frame.frame_core_plain)
    want_m, want_g = step()
    assert [f.launches - b for f, b in zip(kernels, before)] == [128] * 3
    for k in dv.METRIC_NAMES:
        assert abs(got_m[k].item() - want_m[k].item()) <= 1e-5 * abs(
            want_m[k].item()), k
    for a, b in zip(got_g, want_g):
        tol = 1e-4 * (1.0 + b.abs().max().item())
        assert (a - b).abs().max().item() <= tol


def test_pianotree_sampler_encode_on_the_card(cuda):
    """A pianotree Sampler's encode with the detrended grid on the card
    (chunked, the last chunk partial) against the CPU plain path, and its
    decode through K4."""
    from pctd_tpu_torch.train import trainer as tr

    cfg = tiny_model_config(txt_encoder="pianotree")
    params = dv.init_params(cfg, seed=3, device="cpu")
    pr, chord, shift = _pianotree_batch(21, seed=6)
    out = []
    for device in (cuda, torch.device("cpu")):
        _, c, pr_mat, dt_x = tr.batch_features(
            *(torch.as_tensor(a, device=device) for a in (pr, chord, shift)),
            cfg)
        s = Sampler(params, cfg, fixed_batch=8, device=device)
        d_chd, d_rhy = s.encode(pr_mat, c, dt_x)
        k4 = full_decoder.decode_grid_full.launches
        grid = s.decode(d_chd.mean, d_rhy.mean)
        out.append((d_chd.mean.cpu(), d_rhy.mean.cpu(), grid,
                    full_decoder.decode_grid_full.launches - k4))
    (a_chd, a_rhy, a_grid, a_k4), (b_chd, b_rhy, b_grid, b_k4) = out
    # 3 chunks of 8 rows, a 16-row group each, share launches up to the cap
    cap = full_decoder.groups_at_once(s.fw, cfg.pianotree, cuda)
    assert (a_k4, b_k4) == (len(full_decoder.launch_runs(3, 8, cap)), 0)
    torch.testing.assert_close(a_chd, b_chd, rtol=0, atol=1e-5)
    torch.testing.assert_close(a_rhy, b_rhy, rtol=0, atol=1e-5)
    assert (a_grid == b_grid).mean() >= AGREE


# --- the fixed-batch encode as CUDA graph replays ----------------------------

def _encode_case(kind, device, n, seed):
    """(config, params, decode route, encode inputs of n rows) at the
    canonical widths: the conv encoder in f32 (K4) or bf16 (K3), or the
    pianotree encoder with its detrended grid made on the card."""
    from pctd_tpu_torch.train import trainer as tr

    cfg = ModelConfig(txt_encoder="conv" if kind != "pianotree"
                      else "pianotree",
                      compute_dtype="bfloat16" if kind == "bf16"
                      else "float32")
    params = dv.init_params(cfg, seed=1, device=device)
    route = "frame" if kind == "bf16" else "full"
    if kind == "pianotree":
        pr, chord, shift = _pianotree_batch(n, seed)
        _, c, pr_mat, dt_x = tr.batch_features(*(
            torch.as_tensor(a, device=device) for a in (pr, chord, shift)),
            cfg)
        return cfg, params, route, (pr_mat, c, dt_x)
    rng = np.random.RandomState(seed)
    pr = (rng.rand(n, 32, 128) < 0.02).astype(np.float32) * 2
    c = rng.rand(n, 8, 36).astype(np.float32)
    return cfg, params, route, (pr, c)


def _posteriors(out):
    return [x for d in out for x in d]


@pytest.mark.parametrize("rows", [40, 64, 117])
@pytest.mark.parametrize("fixed_batch", [16, 8, 24])
@pytest.mark.parametrize("kind", ["conv", "bf16", "pianotree"])
def test_encode_replays_give_the_bits_of_the_op_by_op_encode(
        cuda, kind, fixed_batch, rows):
    """A fixed-batch encode on the card (a graph replay a chunk) gives
    ``disentangle_vae.encode`` of the same zero-padded chunks bit for bit,
    in one graph and one replay a chunk; a second encode, of other rows,
    replays the same graph and leaves the first one's posteriors as they
    were."""
    cfg, params, route, inputs = _encode_case(kind, cuda, rows,
                                              rows + fixed_batch)
    s = Sampler(params, cfg, frame_decoder=route, fixed_batch=fixed_batch)
    arrays = [s._tensor(a) for a in inputs]
    others = [a.flip(0) for a in arrays]
    got = _posteriors(s.encode(*inputs))
    got2 = _posteriors(s.encode(*others))
    for ins, out in ((arrays, got), (others, got2)):
        share, chunks = s._plan(len(ins[0]))
        want = [_posteriors(dv.encode(s.params, cfg, *(
            sampler_mod._padded(a[part], share) for a in ins)))
            for _, (part,) in chunks]
        for i, col in enumerate(zip(*want)):
            assert torch.equal(out[i], torch.cat(
                [w[:take] for w, (take, _) in zip(col, chunks)])), i
    n = -(-rows // fixed_batch)
    assert (s.encoded_chunks, s.encode_replays) == (2 * n, 2 * n)
    assert len(s._graphs) == 1
    assert got[0].shape == (rows, cfg.chd_z_dim)
    assert got[2].shape == (rows, cfg.txt_z_dim)


@pytest.mark.parametrize("kind", ["conv", "bf16"])
def test_swap_through_encode_replays_gives_the_op_by_op_grids(cuda,
                                                              monkeypatch,
                                                              kind):
    """A swap of 40 rows at fixed batch 16 decodes the grids of the same
    Sampler encoding op by op (``_replays`` made false), bit for bit."""
    cfg, params, route, (pr, c) = _encode_case(kind, cuda, 40, 5)
    swap = lambda s: s.swap(pr, pr[::-1].copy(), c, c[::-1].copy(),
                            fix_rhy=True, fix_chd=False)
    replayed = Sampler(params, cfg, frame_decoder=route, fixed_batch=16)
    got = swap(replayed)
    monkeypatch.setattr(sampler_mod, "_replays", lambda device: False)
    op_by_op = Sampler(params, cfg, frame_decoder=route, fixed_batch=16)
    want = swap(op_by_op)
    assert (replayed.encode_replays, op_by_op.encode_replays) == (3, 0)
    assert replayed.encoded_chunks == op_by_op.encoded_chunks == 3
    assert got.shape == (40, 32, 15, 6)
    np.testing.assert_array_equal(got, want)


def test_encode_graphs_after_load_params_read_the_new_weights(cuda):
    """``load_params`` drops the graphs; the next encode captures again and
    gives a fresh Sampler's posteriors on the new weights, bit for bit."""
    cfg, old_params, _, (pr, c) = _encode_case("conv", cuda, 20, 6)
    new = dv.init_params(cfg, seed=2, device=cuda)
    s = Sampler(old_params, cfg, fixed_batch=16)
    old = _posteriors(s.encode(pr, c))
    s.load_params(new)
    assert s._graphs == {}
    got = _posteriors(s.encode(pr, c))
    want = _posteriors(Sampler(new, cfg, fixed_batch=16).encode(pr, c))
    assert len(s._graphs) == 1 and s.encode_replays == 4
    for a, b, o in zip(got, want, old):
        assert torch.equal(a, b) and not torch.equal(a, o)


def test_encode_replay_kernels_show_on_the_device_timeline(cuda,
                                                           monkeypatch):
    """Under ``torch.profiler`` a replayed encode's kernels appear on the
    device timeline as the op-by-op encode's do, name for name (copies,
    fills and concatenations aside: the two paths pad and gather rows
    differently, and a graph runs a device-to-device copy as a
    ``memcpy32_post`` kernel), so the benchmark's busy time and span
    readers see them."""
    import collections
    import re

    from torch.autograd import DeviceType

    cfg, params, _, (pr, c) = _encode_case("conv", cuda, 40, 7)

    def kernels(s):
        s.encode(pr, c)            # the capture, outside the profile
        return collections.Counter(
            e.name for e in _profiled(cuda, lambda: s.encode(pr, c))
            if e.device_type == DeviceType.CUDA
            and not re.search(r"[Mm]emcpy|Memset|[Cc]opy|Fill|[Cc]at",
                              e.name))

    replayed = kernels(Sampler(params, cfg, fixed_batch=16))
    monkeypatch.setattr(sampler_mod, "_replays", lambda device: False)
    op_by_op = kernels(Sampler(params, cfg, fixed_batch=16))
    assert sum(op_by_op.values()) > 300
    assert replayed == op_by_op


# --- the train step as a CUDA graph -------------------------------------------

#: (model config, batch, accumulation steps) of the step-graph tests: both
#: texture encoders at canonical width and the benchmark's batch (f32, the
#: CE fused in); at tiny width bf16, logits out, two microbatches and the
#: stretch (num_step=128)
GRAPH_CASES = {
    "conv": (ModelConfig(), 512, 1),
    "pianotree": (ModelConfig(txt_encoder="pianotree"), 512, 1),
    "tiny_bf16": (tiny_model_config(compute_dtype="bfloat16"), 16, 1),
    "tiny_logits_out": (tiny_model_config(fused_loss=False), 16, 1),
    "tiny_accum_2": (tiny_model_config(), 16, 2),
    "tiny_stretch": (_stretch(tiny_model_config()), 16, 1),
}


def _raw_batch(cfg, B, seed):
    """A host batch of B raw segments at ``cfg``'s steps, over all 12
    shifts."""
    rng = np.random.RandomState(seed)
    T, S = cfg.pianotree.num_step, cfg.chord.num_step
    pr = np.zeros((B, T, 128), np.uint8)
    pr[rng.rand(B, T, 128) < 0.03] = 2
    chord = np.zeros((B, S, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (B, S))
    chord[..., 1:13] = rng.randint(0, 2, (B, S, 12))
    chord[..., 13] = rng.randint(0, 12, (B, S))
    return dict(pr=pr, chord=chord,
                shift=(np.arange(B) % 12 - 6).astype(np.int32))


def _graph_case(cuda, cfg, B, accum, n, seed=3):
    """A Trainer factory (every Trainer on the same weights and train seed)
    and n host batches of B raw segments."""
    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.train import trainer as tr

    tcfg = TrainConfig(batch_size=B, accum_steps=accum)
    make = lambda wseed=seed: tr.Trainer(
        cfg, tcfg, None, device=cuda,
        params=dv.init_params(cfg, seed=wseed, device=cuda))
    return make, [_raw_batch(cfg, B, 20 + i) for i in range(n)]


def _eager_step(run, batch):
    """One step of ``run`` through the function its step graph captures,
    run eagerly on the current stream (Adam writes its scalars and counts
    its update)."""
    out = run._run(*run._to_device(batch), run._scalars().to(run.device))
    run.step_count += 1
    return out


def _state(run):
    return run.leaves + run.opt.mu + run.opt.nu


#: the frame kernels' wrappers, which count their launches
FRAME_WRAPPERS = (train_frame.frame_fwd, train_frame.frame_core_fwd,
                  train_frame.frame_bwd, train_frame.frame_core_bwd,
                  train_frame.weight_grads)


def _frame_kernels(cuda, fn):
    """The K1, K2a and K2b kernels on the device timeline of ``fn``, by
    name."""
    import collections
    import re

    from torch.autograd import DeviceType

    return collections.Counter(
        e.name for e in _profiled(cuda, fn)
        if e.device_type == DeviceType.CUDA
        and re.search(r"train_fwd|train_bwd_|wgrad_", e.name))


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_step_is_the_eager_step(cuda, case):
    """Four steps through the step graph (the first eager, the second
    captured and replayed, two more replays) against four eager steps
    through the function the graph captures: each step's 11 metrics and
    gradient norm, the params, Adam's mu and nu and the generator's state
    after them, bit for bit; one capture and three replays. The wrappers
    count the launches of the two steps whose Python ran (the eager one and
    the capture), half of four eager steps'; a fifth step's K1, K2a and K2b
    kernels on the profiler's device timeline are the same in a replay as
    in an eager step."""
    cfg, B, accum = GRAPH_CASES[case]
    make, batches = _graph_case(cuda, cfg, B, accum, 4)
    graph, eager = make(), make()
    assert graph.accum == accum
    counts = lambda: [f.launches for f in FRAME_WRAPPERS]
    before = counts()
    got = [graph._step(b) for b in batches]
    mid = counts()
    want = [_eager_step(eager, b) for b in batches]
    after = counts()
    by_graph = [b - a for a, b in zip(before, mid)]
    by_eager = [b - a for a, b in zip(mid, after)]
    assert [2 * n for n in by_graph] == by_eager and sum(by_eager) > 0
    assert (graph.step_captures, graph.step_replays) == (1, 3)
    assert (eager.step_captures, eager.step_replays) == (0, 0)
    for (m, norm), (m_e, norm_e) in zip(got, want):
        assert torch.equal(m, m_e) and torch.equal(norm, norm_e)
    assert all(torch.equal(a, b) for a, b in zip(_state(graph),
                                                 _state(eager)))
    assert torch.equal(graph.gen.get_state(), eager.gen.get_state())
    assert graph.opt.count == graph.step_count == 4
    replayed = _frame_kernels(cuda, lambda: graph._step(batches[0]))
    assert graph.step_replays == 4
    assert replayed == _frame_kernels(cuda,
                                      lambda: _eager_step(eager, batches[0]))
    assert len(replayed) >= 3


def test_resume_after_graph_steps_is_the_uninterrupted_run(cuda, tmp_path):
    """Six graph steps in one Trainer against three, a checkpoint, and
    three more in a fresh Trainer restored from it (other weights before
    the restore), and in the first Trainer, its graph captured, restored
    from it after one more step: metrics, params, Adam's state, counts and
    the registered generator's state bit for bit."""
    from pctd_tpu_torch.train import checkpoint

    cfg = tiny_model_config()
    make, batches = _graph_case(cuda, cfg, 16, 1, 6)
    whole = make()
    want = [whole._step(b)[0] for b in batches]
    part = make()
    head = [part._step(b)[0] for b in batches[:3]]
    path = str(tmp_path / "after_replays")
    checkpoint.save_state(path, part.params, part.opt, part.step_count,
                          part.gen, cfg)
    fresh = make(wseed=4)
    fresh.restore_checkpoint(path)
    runs = {"fresh": (fresh, head + [fresh._step(b)[0]
                                     for b in batches[3:]])}
    part._step(batches[3])
    part.restore_checkpoint(path)
    runs["restored in place"] = (part, head + [part._step(b)[0]
                                               for b in batches[3:]])
    for name, (run, ms) in runs.items():
        assert all(torch.equal(a, b) for a, b in zip(ms, want)), name
        assert all(torch.equal(a, b) for a, b in zip(_state(run),
                                                     _state(whole))), name
        assert torch.equal(run.gen.get_state(), whole.gen.get_state()), name
        assert (run.step_count, run.opt.count) == (6, 6), name
    assert (fresh.step_captures, fresh.step_replays) == (1, 2)
    assert (part.step_captures, part.step_replays) == (1, 6)


# --- data parallel -----------------------------------------------------------

def _dp_case(cfg, device, B, seed=2):
    """(params, the trainable leaves, a host batch of B raw segments, zero
    latent noise with every coin on)."""
    from pctd_tpu_torch.train.trainer import param_list

    params = dv.init_params(cfg, seed=seed, device=device)
    for t in param_list(params):
        t.requires_grad_(True)
    rng = np.random.RandomState(seed)
    pr = (rng.rand(B, 32, 128) < 0.03).astype(np.uint8) * 2
    chord = np.zeros((B, 8, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (B, 8))
    chord[..., 1:13] = rng.randint(0, 2, (B, 8, 12))
    chord[..., 13] = chord[..., 0]
    batch = (pr, chord, np.zeros(B, np.int32))
    return params, param_list(params), batch, dv.fixed_noise(
        cfg, B, device, coins=True)


def test_world_of_one_over_nccl_is_the_single_device_step(cuda):
    """A process group of one rank over NCCL: the data-parallel step (K1/
    K2a/K2b, CE fused in) gives the single-device step's metrics,
    gradients and updated params bit for bit, with 32 launches a step of
    each."""
    import torch.distributed as dist

    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.parallel import distributed as pdist
    from pctd_tpu_torch.parallel import mesh as pm
    from pctd_tpu_torch.train import trainer as tr
    from pctd_tpu_torch.train.optim import Adam

    cfg, B = ModelConfig(), 32
    tcfg = TrainConfig(batch_size=B, accum_steps=1)
    ref_p, ref_leaves, batch, noise = _dp_case(cfg, cuda, B)
    x, c, pr_mat, _ = tr.batch_features(
        *(torch.as_tensor(a, device=cuda) for a in batch), cfg)
    ref_m, ref_g = tr.loss_and_grads(ref_p, cfg, tcfg,
                                     schedules.train_params_at(0, tcfg),
                                     None, x, c, pr_mat, noise=noise)
    ref_g = [g.clone() for g in ref_g]
    Adam(ref_leaves, tcfg).step(ref_g)
    par_p, par_leaves, _, _ = _dp_case(cfg, cuda, B)
    seen = []

    class Recording(Adam):
        def step(self, grads):
            seen.extend(g.clone() for g in grads)
            return super().step(grads)

    pdist.initialize_local("nccl")
    try:
        mesh = pm.make_mesh()
        step = pm.make_parallel_train_step(cfg, tcfg,
                                           Recording(par_leaves, tcfg), mesh)
        for f in (train_frame.frame_fwd, train_frame.frame_bwd,
                  train_frame.weight_grads):
            f.launches = 0
        m, _ = step(par_p, 0, None, *pm.shard_batch(mesh, *batch),
                    noise=noise)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert torch.equal(m, tr.stacked(ref_m))
    assert all(torch.equal(a, b) for a, b in zip(seen, ref_g))
    assert all(torch.equal(a, b) for a, b in zip(par_leaves, ref_leaves))
    assert (train_frame.frame_fwd.launches, train_frame.frame_bwd.launches,
            train_frame.weight_grads.launches) == (32, 32, 32)


def _gloo_rank(rank, world, port, path):
    """A rank of test_two_gloo_ranks_on_the_card_are_one_process: the exact
    data-parallel step on its rows, results written to ``path``."""
    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.parallel import distributed as pdist
    from pctd_tpu_torch.parallel import mesh as pm

    pdist.initialize(f"localhost:{port}", world, rank, "gloo")
    try:
        mesh = pm.make_mesh()
        cfg, B = tiny_model_config(), 16
        params, leaves, batch, _ = _dp_case(cfg, mesh.device, B)
        rows = pm.shard_batch(mesh, *batch)
        noise = dv.fixed_noise(cfg, rows[0].shape[0], mesh.device,
                               coins=True)
        got = {}

        class Keep:
            def step(self, grads):
                got["grads"] = [g.cpu() for g in grads]
                return torch.zeros(())

        step = pm.make_parallel_train_step(
            cfg, TrainConfig(batch_size=B, accum_steps=1), Keep(), mesh)
        train_frame.frame_fwd.launches = 0
        m, _ = step(params, 0, None, *rows, noise=noise)
        got.update(metrics=m.cpu(), k1=train_frame.frame_fwd.launches)
        torch.save(got, f"{path}.{rank}")
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_on_the_card_are_one_process(cuda, tmp_path):
    """Two ranks on this card over gloo (CUDA tensors), 8 rows each of 16:
    the exact loss and the averaged gradients are those of one process on
    all 16 rows, each rank through K1."""
    import multiprocessing

    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.parallel.distributed import free_port
    from pctd_tpu_torch.train import trainer as tr

    ctx = multiprocessing.get_context("spawn")
    path, port = str(tmp_path / "rank"), free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, port, path))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(f"{path}.{r}") for r in range(2)]
    cfg, B = tiny_model_config(), 16
    params, _, batch, noise = _dp_case(cfg, cuda, B)
    x, c, pr_mat, _ = tr.batch_features(
        *(torch.as_tensor(a, device=cuda) for a in batch), cfg)
    tcfg = TrainConfig(batch_size=B)
    ref_m, ref_g = tr.loss_and_grads(params, cfg, tcfg,
                                     schedules.train_params_at(0, tcfg),
                                     None, x, c, pr_mat, noise=noise)
    assert torch.equal(ranks[0]["metrics"], ranks[1]["metrics"])
    assert ranks[0]["k1"] == ranks[1]["k1"] == cfg.pianotree.num_step
    torch.testing.assert_close(ranks[0]["metrics"],
                               tr.stacked(ref_m).cpu(), rtol=1e-5, atol=0)
    for g, want in zip(ranks[0]["grads"], ref_g):
        assert (g - want.cpu()).abs().max() <= 1e-4 * (
            1 + want.abs().max().item())


def test_serve_data_parallel_on_the_card_answers_as_without(cuda,
                                                           tmp_path):
    """``cli.serve --data-parallel`` over the visible cards: its replies and
    files equal the daemon's without the flag, and its ready line counts
    the cards."""
    import io
    import json

    from pctd_tpu_torch.cli import serve

    files = _daemon_songs(tmp_path)
    runs = []
    for flag in ([], ["--data-parallel"]):
        reqs = [{"op": "style_transfer", "content": files["a"],
                 "style": files["b"], "out": str(tmp_path / f"st{flag}.mid")},
                {"op": "interp", "a": files["a"], "b": files["b"],
                 "count": 2, "out": str(tmp_path / f"i{flag}_%d.mid")},
                {"op": "quit"}]
        buf = io.StringIO()
        serve.main(["--tiny", *flag], stdin=io.StringIO(
            "\n".join(json.dumps(r) for r in reqs) + "\n"), stdout=buf)
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        ready = [ln for ln in lines if ln.get("ready")][0]
        outs = [p for ln in lines if "out" in ln for p in (
            ln["out"] if isinstance(ln["out"], list) else [ln["out"]])]
        blobs = [open(p, "rb").read() for p in outs]
        runs.append((ready["devices"], blobs))
    assert runs[0][0] == 1
    assert runs[1][0] == torch.cuda.device_count()
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) == 3


def test_demo_tree_through_k3_is_the_k4_tree(cuda, tmp_path):
    """``cli.make_demos --frame-decoder pallas`` launches K3 32 times a
    16-row chunk and K4 never, and writes the default (K4) route's files;
    every file is byte-equal to K4's."""
    import os

    from pctd_tpu_torch.cli import make_demos

    K3, K4 = ar_decoder.frame_decode, full_decoder.decode_grid_full
    trees = {}
    for flag in ("auto", "pallas"):
        out = str(tmp_path / flag)
        K3.launches = K4.launches = 0
        make_demos.main(["--tiny", "--k", "2", "--out", out,
                         "--frame-decoder", flag])
        trees[flag] = (K3.launches, K4.launches, sorted(
            os.path.relpath(os.path.join(d, f), out)
            for d, _, fs in os.walk(out) for f in fs))
    k3_chunks = trees["auto"][1]
    assert trees["auto"][0] == 0 and k3_chunks > 0
    assert trees["pallas"][:2] == (32 * k3_chunks, 0)
    assert trees["pallas"][2] == trees["auto"][2]
    for f in trees["auto"][2]:
        assert (open(tmp_path / "auto" / f, "rb").read()
                == open(tmp_path / "pallas" / f, "rb").read()), f


def _span_run(cuda):
    """A tiny-width f32 Sampler and Trainer on the card, the Trainer warmed
    by one step: (a swap of 20 rows through K4, one train step at B=16
    through K1/K2a/K2b: the next is the step graph's capture and first
    replay, every later one a replay)."""
    from pctd_tpu_torch.config import TrainConfig
    from pctd_tpu_torch.data.corpus import SegmentCorpus
    from pctd_tpu_torch.data.loaders import SegmentBatches
    from pctd_tpu_torch.train.trainer import Trainer

    cfg = tiny_model_config()
    params = dv.init_params(cfg, seed=8, device=cuda)
    sampler = Sampler(params, cfg, device=cuda)
    rng = np.random.RandomState(9)
    pr = np.zeros((20, 32, 128), np.float32)
    on = rng.rand(20, 32, 128) < 0.02
    pr[on] = rng.randint(1, 9, on.sum())
    c = np.zeros((20, 8, 36), np.float32)
    c[:, :, 0] = c[:, :, 24] = 1.0
    raw = np.zeros((16, 32, 128), np.uint8)
    raw[rng.rand(16, 32, 128) < 0.03] = 2
    chord = np.zeros((16, 8, 14), np.float32)
    chord[..., 1:13] = rng.randint(0, 2, (16, 8, 12))
    run = Trainer(cfg, TrainConfig(batch_size=16, accum_steps=1),
                  SegmentBatches(SegmentCorpus(raw, chord), 16, 0, 0),
                  device=cuda, params=dv.init_params(cfg, seed=10,
                                                     device=cuda))
    run.train_epoch()
    swap = lambda: sampler.swap(pr, pr[::-1], c, c, fix_rhy=True,
                                fix_chd=False)
    return swap, run.train_epoch


def _profiled(cuda, fn):
    """The events of ``fn`` under a CPU + CUDA profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(cuda)
    return prof.events()


def test_spans_have_no_device_mirror(cuda):
    """Under a CUDA profiler a traced swap and a traced train step record
    their ``pctd.`` spans on the host, and no CUDA-type event named
    ``pctd.``; a ``record_function`` range around the same call (a user
    annotation) is mirrored on the device timeline, so the look would see
    a mirror."""
    from torch.autograd import DeviceType

    swap, step = _span_run(cuda)
    for fn, want in ((swap, {"pctd.sampler.swap", "pctd.sampler.encode",
                             "pctd.sampler.decode"}),
                     (step, {"pctd.train.data", "pctd.train.forward",
                             "pctd.train.backward", "pctd.train.optim",
                             "pctd.train.step"})):
        def annotated():
            with torch.profiler.record_function("annotated.call"):
                fn()

        events = _profiled(cuda, annotated)
        host = {e.name for e in events if e.device_type == DeviceType.CPU}
        device = {e.name for e in events
                  if e.device_type == DeviceType.CUDA}
        assert want <= host
        assert not [n for n in device if n.startswith("pctd.")]
        assert "annotated.call" in device


def test_spans_launch_nothing(cuda, monkeypatch):
    """A traced train step launches as many kernels with its spans as with
    ``trace.span`` made null: a replay of the step graph (its spans
    ``pctd.train.data`` and ``.step``), and an eager step through the
    function the graph captures (``.forward``, ``.backward``, ``.optim``)."""
    import contextlib
    import re

    from torch.autograd import DeviceType
    from pctd_tpu_torch.utils import trace

    _, step = _span_run(cuda)
    step()                      # the capture: every later step replays
    run = step.__self__
    batch = next(iter(run.train_batches.epoch()))
    eager = lambda: run._run(*run._to_device(batch),
                             run._scalars().to(cuda))

    def kernels():
        return [sum(1 for e in _profiled(cuda, fn)
                    if e.device_type == DeviceType.CUDA
                    and not re.match(r"(Memcpy|Memset)", e.name))
                for fn in (step, eager)]

    with_spans = kernels()
    monkeypatch.setattr(trace, "span", lambda name: contextlib.nullcontext())
    assert kernels() == with_spans and min(with_spans) > 100
