"""Parameter initializers: the JAX package's distributions
(``pctd_tpu/utils/init.py``), drawn from an explicit ``torch.Generator``.

- dense / GRU weights: U(-1/sqrt(fan), 1/sqrt(fan))
- conv:                U(-sqrt(k), sqrt(k)), k = 1/(in_ch * prod(kernel))
- free parameters:     U(0, 1)

Layouts are the JAX package's: dense ``w`` is (in, out), conv ``w`` is HWIO.
The draws are made on the generator's device (the CPU for a CPU generator)
and returned there; callers move the finished tree.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def uniform(gen: torch.Generator, shape: Sequence[int], scale: float
            ) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return u * (2.0 * scale) - scale


def dense_params(gen: torch.Generator, in_dim: int, out_dim: int) -> dict:
    s = 1.0 / math.sqrt(in_dim)
    return {"w": uniform(gen, (in_dim, out_dim), s),
            "b": uniform(gen, (out_dim,), s)}


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def conv2d_params(gen: torch.Generator, in_ch: int, out_ch: int,
                  kernel: Sequence[int]) -> dict:
    s = 1.0 / math.sqrt(in_ch * kernel[0] * kernel[1])
    return {"w": uniform(gen, (kernel[0], kernel[1], in_ch, out_ch), s),
            "b": uniform(gen, (out_ch,), s)}


def free_param(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """torch.rand equivalent: U(0, 1)."""
    return torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                      device=gen.device)
