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
        return self.rsample_eps(eps)

    def rsample_eps(self, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterised sample with the caller's standard-normal noise
        (the training loss takes its noise as an input)."""
        return self.mean + self.std * eps


def kl_std_normal(dist: DiagNormal) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)), mean over batch and dim."""
    mu, std = dist.mean, dist.std
    var = std * std
    kl = 0.5 * (var + mu * mu - 1.0) - torch.log(std)
    return kl.mean()
