"""Diagonal-Gaussian latent (``pctd_tpu/ops/distributions.py``): an explicit
(mean, std) pair, std parameterized as ``exp(linear(x))`` as in the
reference model."""
from __future__ import annotations

from typing import NamedTuple

import torch


class DiagNormal(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        eps = torch.randn(self.mean.shape, generator=generator,
                          dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * eps
