"""Texture encoder, conv variant (``pctd_tpu/models/texture_encoder.py``):
Conv(4x12 / stride 4x1) + ReLU + MaxPool(1x4) + 2 x FC + bi-GRU over the
(B, 32, 128) duration matrix -> 256-d Gaussian latent.

The conv runs as unfold + matmul: a float32 matmul on the card is full f32
by default, whereas cuDNN's conv would run it in TF32. Kept quirk: the
reference flattens the (B, C, 8, 29) feature map with ``.view(B, 8, -1)``,
which interleaves channel and time (the channel-major ravel); the JAX
package reproduces it and so does this port. The pianotree variant comes
with a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.ops import DiagNormal, bigru_last, gru_init
from pctd_tpu_torch.utils.init import conv2d_params, dense_apply, dense_params


def _conv_dims(cfg: ModelConfig):
    """Conv output (H, W) and fc1 input size: the raveled conv map is
    regrouped into 8 GRU steps of ch*H*W/8 features."""
    H = (cfg.pianotree.num_step - 4) // 4 + 1
    W = (128 - 12 + 1) // 4
    return H, W, cfg.txt_conv_channels * H * W // 8


def init_conv(gen: torch.Generator, cfg: ModelConfig) -> dict:
    ch, emb, h = cfg.txt_conv_channels, cfg.txt_emb_size, cfg.txt_enc_hidden
    _, _, fc1_in = _conv_dims(cfg)
    return {
        "conv": conv2d_params(gen, 1, ch, (4, 12)),
        "fc1": dense_params(gen, fc1_in, 1000),
        "fc2": dense_params(gen, 1000, emb),
        "gru_fwd": gru_init(gen, emb, h),
        "gru_bwd": gru_init(gen, emb, h),
        "mu": dense_params(gen, 2 * h, cfg.txt_z_dim),
        "std": dense_params(gen, 2 * h, cfg.txt_z_dim),
    }


def apply_conv(p: dict, pr_mat: torch.Tensor) -> DiagNormal:
    """pr_mat: (B, 32, 128) duration matrix -> DiagNormal over (B, z_txt)."""
    B, T, _ = pr_mat.shape
    kh, kw, _, C = p["conv"]["w"].shape
    # (B, kh*kw, L) patches; the HWIO weight reshaped to (kh*kw, C) indexes
    # its rows in the same (h, w) order
    cols = F.unfold(pr_mat[:, None], (kh, kw), stride=(kh, 1))
    Ho, Wo = (T - kh) // kh + 1, 128 - kw + 1
    x = cols.transpose(1, 2) @ p["conv"]["w"].reshape(kh * kw, C)
    x = torch.relu(x + p["conv"]["b"]).reshape(B, Ho, Wo, C)
    Wp = Wo // 4
    x = x[:, :, :Wp * 4].reshape(B, Ho, Wp, 4, C).amax(dim=3)  # (B,H,29,C)
    x = x.permute(0, 3, 1, 2).reshape(B, 8, -1)  # channel-major ravel
    x = dense_apply(p["fc2"], dense_apply(p["fc1"], x))
    h = bigru_last(p["gru_fwd"], p["gru_bwd"], x)
    return DiagNormal(dense_apply(p["mu"], h),
                      torch.exp(dense_apply(p["std"], h)))
