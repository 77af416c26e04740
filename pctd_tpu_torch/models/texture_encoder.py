"""Texture encoders (``pctd_tpu/models/texture_encoder.py``) -> 256-d
Gaussian latent, in two variants:

- ``conv``: Conv(4x12 / stride 4x1) + ReLU + MaxPool(1x4) + 2 x FC + bi-GRU
  over the (B, 32, 128) duration matrix;
- ``pianotree``: note embedding + note-level masked bi-GRU + time bi-GRU
  over the detrended PianoTree feature (:mod:`pctd_tpu_torch.data.detrend`).
  The JAX package runs it in XLA scans, not in a Pallas kernel, so here it
  is torch ops (cuBLAS products) on the port's GRUs.

The conv runs as unfold + matmul: a float32 matmul on the card is full f32
by default, whereas cuDNN's conv would run it in TF32. Kept quirk: the
reference flattens the (B, C, 8, 29) feature map with ``.view(B, 8, -1)``,
which interleaves channel and time (the channel-major ravel); the JAX
package reproduces it and so does this port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.ops import DiagNormal, bigru_last, bigru_last_masked, \
    gru_init
from pctd_tpu_torch.utils.init import conv2d_params, dense_apply, dense_params
from pctd_tpu_torch.utils.precision import head_input


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
    # max pool; the gradient goes to the first maximum of a window, as the
    # JAX reduce_window's does (ties are common in bf16)
    x = x[:, :, :Wp * 4].reshape(B, Ho, Wp, 4, C).max(dim=3).values
    x = x.permute(0, 3, 1, 2).reshape(B, 8, -1)  # channel-major ravel
    x = dense_apply(p["fc2"], dense_apply(p["fc1"], x))
    h = bigru_last(p["gru_fwd"], p["gru_bwd"], x)
    # the Gaussian heads run in f32 (bf16 h promotes in JAX; cast here)
    return DiagNormal(dense_apply(p["mu"], head_input(p["mu"], h)),
                      torch.exp(dense_apply(p["std"],
                                            head_input(p["std"], h))))


def init_pianotree(gen: torch.Generator, cfg: ModelConfig) -> dict:
    ne, nh = cfg.ptenc_note_emb, cfg.ptenc_notes_hidden
    th = cfg.ptenc_time_hidden
    return {
        "note_emb": dense_params(gen, cfg.ptenc_note_size, ne),
        "notes_fwd": gru_init(gen, ne, nh),
        "notes_bwd": gru_init(gen, ne, nh),
        "time_fwd": gru_init(gen, 2 * nh, th),
        "time_bwd": gru_init(gen, 2 * nh, th),
        "mu": dense_params(gen, 2 * th, cfg.txt_z_dim),
        "std": dense_params(gen, 2 * th, cfg.txt_z_dim),
    }


def apply_pianotree(p: dict, notes: torch.Tensor, lengths: torch.Tensor
                    ) -> DiagNormal:
    """notes (B, T, K, note_size) multi-hot note features (the 39-d
    detrended feature), lengths (B, T) valid notes a step -> DiagNormal over
    (B, z_txt). The note-level bi-GRUs run over all B*T frames at once."""
    B, T, K, _ = notes.shape
    emb = dense_apply(p["note_emb"], notes)                 # (B, T, K, ne)
    note_h = bigru_last_masked(p["notes_fwd"], p["notes_bwd"],
                               emb.reshape(B * T, K, emb.shape[-1]),
                               lengths.reshape(B * T))
    h = bigru_last(p["time_fwd"], p["time_bwd"], note_h.reshape(B, T, -1))
    return DiagNormal(dense_apply(p["mu"], head_input(p["mu"], h)),
                      torch.exp(dense_apply(p["std"],
                                            head_input(p["std"], h))))


def lengths_from_detrended(dt_x: torch.Tensor) -> torch.Tensor:
    """Valid notes a time step of the 39-d detrended feature: K minus the
    pad notes (is_note index 3)."""
    return (dt_x.shape[2] - dt_x[..., 3].sum(-1)).to(torch.int32)
