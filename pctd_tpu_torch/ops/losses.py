"""Cross-entropy losses with torch ``CrossEntropyLoss`` reduction semantics
(``pctd_tpu/ops/losses.py``): the ignore-index mean averages over the
non-ignored elements only. Loss math runs in f32.

``group`` (a ``torch.distributed`` process group) selects the exact
data-parallel reduction, the counterpart of the JAX ``axis_name``: the
numerator and the denominator are each summed over the group's ranks
before the division, so a batch split over the ranks gives the loss of
the whole batch. The sum's backward is a sum over the ranks too (as JAX
transposes ``psum`` to ``psum``), so each rank's gradient is its own
numerator's, scaled by ``world / den_global``, and the mean of the ranks'
gradients is exactly the gradient of the whole batch's loss.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``, forward and backward."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, with gradients (the JAX
    ``psum``)."""
    return _AllReduceSum.apply(t, group)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element negative log likelihood ``logsumexp(l) - l[target]``.
    logits (..., C), targets (...) integer."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    return lse - picked


def masked_ce_parts(logits: torch.Tensor, targets: torch.Tensor,
                    ignore_index: int, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the ignore-index mean: the NLL summed
    over elements whose target is not ``ignore_index``, and their count.
    Ignored targets are clamped to 0 before the pick; their term is masked
    out. With ``group`` both are summed over its ranks (one all-reduce; the
    count then comes back as a float tensor)."""
    mask = targets != ignore_index
    safe_t = torch.where(mask, targets, torch.zeros_like(targets))
    num = (_nll(logits, safe_t) * mask).sum()
    den = mask.sum()
    if group is not None:
        num, den = all_reduce_sum(torch.stack([num, den.to(num.dtype)]),
                                  group).unbind()
    return num, den


def cross_entropy_ignore(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_index: int, group=None) -> torch.Tensor:
    """Mean CE over elements where target != ignore_index; over the ranks
    of ``group`` when given (the clamp of the count to 1 after the sum)."""
    num, den = masked_ce_parts(logits, targets, ignore_index, group)
    return num / den.clamp(min=1)


def cross_entropy_mean(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """Plain mean CE over all elements (the chord loss)."""
    return _nll(logits, targets).mean()
