"""Mixed-precision policy (a copy of ``pctd_tpu/utils/precision.py``).

``ModelConfig.compute_dtype = "bfloat16"`` runs the matmul-heavy compute
path (GRUs, embeddings, the conv texture encoder, output heads and the
train-frame kernels) in bf16 while keeping

- the master params in f32: the cast lives inside the loss and is
  differentiable, so autograd returns f32 gradients to the f32 leaves;
- the Gaussian heads (``mu`` / ``std``) and all loss math in f32.

Heads stay f32 by exclusion: a param subtree named in ``F32_KEYS`` is not
cast, and callers cast the head input with :func:`head_input` (torch
refuses a bf16 @ f32 product where JAX promotes it).
"""
from __future__ import annotations

import torch

from pctd_tpu_torch.ops.gru import GRUParams

#: param-dict keys whose subtrees stay f32 (the Gaussian heads)
F32_KEYS = frozenset({"mu", "std"})


def cast_params(params, dtype: torch.dtype):
    """``params`` with every floating tensor cast to ``dtype`` (a
    differentiable ``.to``), leaving ``F32_KEYS`` subtrees untouched."""
    if isinstance(params, dict):
        return {k: (v if k in F32_KEYS else cast_params(v, dtype))
                for k, v in params.items()}
    if isinstance(params, GRUParams):
        return GRUParams(*(cast_params(t, dtype) for t in params))
    if params.is_floating_point():
        return params.to(dtype)
    return params


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    """The torch dtype named by ``cfg.compute_dtype`` (float32 or
    bfloat16)."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the port "
                         f"runs {sorted(_DTYPES)}")
    return _DTYPES[cfg.compute_dtype]


def head_input(p_head: dict, h: torch.Tensor) -> torch.Tensor:
    """A head's input cast to the head weight's dtype (f32 for the Gaussian
    heads)."""
    return h.to(p_head["w"].dtype)
