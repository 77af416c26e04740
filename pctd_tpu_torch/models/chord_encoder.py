"""Chord encoder (``pctd_tpu/models/chord_encoder.py``): bi-GRU over the
8-beat expanded chord sequence -> 256-d Gaussian latent."""
from __future__ import annotations

import torch

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.ops import DiagNormal, bigru_last, gru_init
from pctd_tpu_torch.utils.init import dense_apply, dense_params
from pctd_tpu_torch.utils.precision import head_input


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    h = cfg.chd_enc_hidden
    return {
        "gru_fwd": gru_init(gen, cfg.chord.dim, h),
        "gru_bwd": gru_init(gen, cfg.chord.dim, h),
        "mu": dense_params(gen, 2 * h, cfg.chd_z_dim),
        "std": dense_params(gen, 2 * h, cfg.chd_z_dim),
    }


def apply(p: dict, c: torch.Tensor) -> DiagNormal:
    """c: (B, 8, 36) expanded chord -> DiagNormal over (B, z_chd)."""
    h = bigru_last(p["gru_fwd"], p["gru_bwd"], c)
    # the Gaussian heads run in f32 (bf16 h promotes in JAX; cast here)
    return DiagNormal(dense_apply(p["mu"], head_input(p["mu"], h)),
                      torch.exp(dense_apply(p["std"],
                                            head_input(p["std"], h))))
