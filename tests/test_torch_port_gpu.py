"""The decode kernels against their plain PyTorch versions on a CUDA card.

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
from pctd_tpu_torch.ops.kernels import ar_decoder, full_decoder

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
