"""Autoregressive chord decoder (``pctd_tpu/models/chord_decoder.py``):
z_chd -> 8 beats of (root, chroma, bass) logits, with argmax feedback
one-hots built per sample and the batch-global teacher coins ``coins3``
(num_step,) bool as an input: coin[t] feeds the ground-truth beat t to
step t+1."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.ops import gru_cell_pre, gru_init
from pctd_tpu_torch.utils.init import dense_apply, dense_params, free_param


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    h, zin, dim = cfg.chd_dec_hidden, cfg.chd_dec_z_in, cfg.chord.dim
    return {
        "z2hid": dense_params(gen, cfg.chd_z_dim, h),
        "z2in": dense_params(gen, cfg.chd_z_dim, zin),
        "gru": gru_init(gen, dim + zin, h),
        "root": dense_params(gen, h, 12),
        "chroma": dense_params(gen, h, 24),
        "bass": dense_params(gen, h, 12),
        "init_input": free_param(gen, (dim,)),
    }


def apply(p: dict, z_chd: torch.Tensor, c: Optional[torch.Tensor],
          coins: Optional[torch.Tensor], num_step: int = 8
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """z_chd (B, z_chd); c (B, S, 36) ground truth or None (inference).
    Returns (root (B, S, 12), chroma (B, S, 12, 2), bass (B, S, 12))
    logits."""
    B = z_chd.shape[0]
    dim = p["init_input"].shape[0]
    h = dense_apply(p["z2hid"], z_chd)
    z_in = dense_apply(p["z2in"], z_chd)
    g = p["gru"]
    w_tok = g.w_ih[:dim]
    gi_z = z_in @ g.w_ih[dim:] + g.b_ih
    token = p["init_input"].expand(B, dim)
    roots, chromas, basses = [], [], []
    for t in range(num_step):
        h = gru_cell_pre(g, gi_z + token @ w_tok, h)
        r_root = dense_apply(p["root"], h)
        r_chroma = dense_apply(p["chroma"], h).reshape(B, 12, 2)
        r_bass = dense_apply(p["bass"], h)
        roots.append(r_root)
        chromas.append(r_chroma)
        basses.append(r_bass)
        if t + 1 == num_step:
            break
        one_hot = lambda l: torch.nn.functional.one_hot(
            l.argmax(-1), 12).to(h.dtype)
        pred = torch.cat([one_hot(r_root), r_chroma.argmax(-1).to(h.dtype),
                          one_hot(r_bass)], dim=-1)
        if c is not None:
            pred = torch.where(coins[t], c[:, t], pred)
        token = pred
    return (torch.stack(roots, 1), torch.stack(chromas, 1),
            torch.stack(basses, 1))
