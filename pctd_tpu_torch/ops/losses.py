"""Cross-entropy losses with torch ``CrossEntropyLoss`` reduction semantics
(``pctd_tpu/ops/losses.py``): the ignore-index mean averages over the
non-ignored elements only. Loss math runs in f32."""
from __future__ import annotations

from typing import Tuple

import torch


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element negative log likelihood ``logsumexp(l) - l[target]``.
    logits (..., C), targets (...) integer."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    return lse - picked


def masked_ce_parts(logits: torch.Tensor, targets: torch.Tensor,
                    ignore_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the ignore-index mean: the NLL summed
    over elements whose target is not ``ignore_index``, and their count.
    Ignored targets are clamped to 0 before the pick; their term is masked
    out."""
    mask = targets != ignore_index
    safe_t = torch.where(mask, targets, torch.zeros_like(targets))
    num = (_nll(logits, safe_t) * mask).sum()
    return num, mask.sum()


def cross_entropy_ignore(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_index: int) -> torch.Tensor:
    """Mean CE over elements where target != ignore_index."""
    num, den = masked_ce_parts(logits, targets, ignore_index)
    return num / den.clamp(min=1)


def cross_entropy_mean(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """Plain mean CE over all elements (the chord loss)."""
    return _nll(logits, targets).mean()
