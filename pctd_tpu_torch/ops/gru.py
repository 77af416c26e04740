"""GRU primitives (``pctd_tpu/ops/gru.py``) as plain tensor code.

Written as explicit matmul loops, not ``nn.GRU``/cuDNN, so the gate
arithmetic is the JAX package's and no TF32 can enter. Weights keep the JAX
layout: ``w_ih`` (in, 3H), ``w_hh`` (H, 3H), gates in the torch (r, z, n)
order:

    r = sig(Wr x + br + Ur h + cr)
    z = sig(Wz x + bz + Uz h + cz)
    n = tanh(Wn x + bn + r * (Un h + cn))
    h' = (1 - z) * n + z * h

Variable lengths follow ``pack_padded_sequence``: masked steps hold the
carried hidden, so the forward final state is the hidden after step
``length-1`` and the backward direction starts at the last valid step.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pctd_tpu_torch.utils.init import uniform


class GRUParams(NamedTuple):
    w_ih: torch.Tensor  # (in_dim, 3H)
    w_hh: torch.Tensor  # (H, 3H)
    b_ih: torch.Tensor  # (3H,)
    b_hh: torch.Tensor  # (3H,)

    @property
    def hidden_dim(self) -> int:
        return self.w_hh.shape[0]


def gru_init(gen: torch.Generator, in_dim: int, hidden_dim: int
             ) -> GRUParams:
    s = 1.0 / math.sqrt(hidden_dim)
    return GRUParams(
        w_ih=uniform(gen, (in_dim, 3 * hidden_dim), s),
        w_hh=uniform(gen, (hidden_dim, 3 * hidden_dim), s),
        b_ih=uniform(gen, (3 * hidden_dim,), s),
        b_hh=uniform(gen, (3 * hidden_dim,), s),
    )


def input_proj(p: GRUParams, x: torch.Tensor) -> torch.Tensor:
    """x @ W_ih + b_ih over any leading dims."""
    return x @ p.w_ih + p.b_ih


class _XlaLogistic(torch.autograd.Function):
    """The logistic as XLA expands it, ``1 / (1 + exp(-x))``, with JAX's
    VJP ``g * (y * (1 - y))``; every op rounds to the tensors' dtype."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1.0 - y))


class _XlaTanh(torch.autograd.Function):
    """``tanh`` with JAX's VJP ``(g + g * y) * (1 - y)``, every op rounding
    to the tensors' dtype."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return (g + g * y) * (1.0 - y)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` in float32. In bf16 the JAX package's bf16 GRUs'
    logistic, op by op (:class:`_XlaLogistic`): with ``torch.sigmoid`` and
    ``torch.tanh`` the bf16 loss's ``kl_chd`` sits 3.4e-4 (relative) from
    the JAX package's at tiny width, against 1.26e-4 with them."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return _XlaLogistic.apply(x)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """``torch.tanh``; in bf16 with JAX's VJP (:class:`_XlaTanh`)."""
    if x.dtype == torch.float32:
        return torch.tanh(x)
    return _XlaTanh.apply(x)


def gru_gates(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor):
    """:func:`gru_gates_pre` with its gates: (new hidden, (r, z, n, h_n)),
    the values a hand-written backward reads."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = _sigmoid(i_r + h_r)
    z = _sigmoid(i_z + h_z)
    n = _tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h, (r, z, n, h_n)


def gru_gates_pre(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor
                  ) -> torch.Tensor:
    """Gate math from precomputed input and hidden projections (B, 3H), in
    their dtype. In bf16 every op rounds, forward and backward, in the
    order of the JAX package's bf16 GRUs under XLA."""
    return gru_gates(gi, gh, h)[0]


def gru_cell_pre(p: GRUParams, gi: torch.Tensor, h: torch.Tensor
                 ) -> torch.Tensor:
    """One GRU step given a precomputed input projection ``gi`` (B, 3H)."""
    return gru_gates_pre(gi, h @ p.w_hh + p.b_hh, h)


def gru_scan(p: GRUParams, xs: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None,
             reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over xs (B, T, D). Returns (ys (B, T, H), h_final (B, H)).

    ``reverse=True`` walks T-1 .. 0 (ys stays aligned with xs); ``mask``
    (B, T) bool holds the carried hidden on False steps."""
    B, T, _ = xs.shape
    h = xs.new_zeros((B, p.hidden_dim)) if h0 is None else h0
    gi = input_proj(p, xs)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new = gru_cell_pre(p, gi[:, t], h)
        if mask is not None:
            h_new = torch.where(mask[:, t, None], h_new, h)
        h = h_new
        ys[t] = h
    return torch.stack(ys, dim=1), h


def bigru_last(p_fwd: GRUParams, p_bwd: GRUParams, xs: torch.Tensor
               ) -> torch.Tensor:
    """Bidirectional GRU over full-length sequences: [h_fwd, h_bwd] (B, 2H),
    the torch ``gru(x)[-1]`` + transpose + view idiom."""
    return bigru_last_masked(p_fwd, p_bwd, xs, None)


def bigru_last_masked(p_fwd: GRUParams, p_bwd: GRUParams,
                      xs: torch.Tensor,
                      lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Bidirectional GRU with per-sample valid lengths (pack_padded parity).

    xs (B, T, D), lengths (B,) int or None. Returns (B, 2H): the forward
    hidden after step len-1 and the backward hidden after t = len-1 .. 0."""
    T = xs.shape[1]
    mask = None
    if lengths is not None:
        mask = (torch.arange(T, device=xs.device)[None, :]
                < lengths[:, None])
    _, hf = gru_scan(p_fwd, xs, mask=mask)
    _, hb = gru_scan(p_bwd, xs, mask=mask, reverse=True)
    return torch.cat([hf, hb], dim=-1)
