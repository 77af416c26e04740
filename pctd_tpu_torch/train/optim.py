"""The optimizer chain of ``pctd_tpu/train/schedules.py::make_optimizer``
with optax semantics: global-norm clipping, then Adam (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0) at the scheduled learning rate.

``clip_by_global_norm`` scales by ``max / norm`` unless ``norm < max``,
with no epsilon in the norm, so it is not
``torch.nn.utils.clip_grad_norm_``. The update is written out in tensor
ops in optax's order of operations; parameters are updated in place.

The scalars that change from update to update (the learning rate and the
two bias corrections, :meth:`Adam.hyper`) are host numbers, or a tensor
that the caller passes: the Trainer's on the card, which a captured CUDA
graph reads at each replay. The same ops run either way, but CUDA divides
by a host number as a multiply by its f32 reciprocal and by a tensor as a
true division, so the two differ by rounding.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from pctd_tpu_torch.config import TrainConfig
from pctd_tpu_torch.train import schedules
from pctd_tpu_torch.utils import trace


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a 0-d tensor)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The clipped gradients and the global norm they had before."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads], norm


class Adam:
    """Clip + Adam over a flat list of parameter tensors, as
    ``optax.chain(clip_by_global_norm(clip), adam(lr_schedule))``."""

    b1, b2, eps, eps_root = 0.9, 0.999, 1e-8, 0.0

    def __init__(self, params: Sequence[torch.Tensor], cfg: TrainConfig):
        self.params = list(params)
        self.cfg = cfg
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def hyper(self) -> List[float]:
        """The next update's (learning rate, 1 - b1^t, 1 - b2^t), t =
        ``count`` + 1, on the host."""
        t = self.count + 1
        return [schedules.lr_at(self.count, self.cfg), 1.0 - self.b1 ** t,
                1.0 - self.b2 ** t]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], scalars=None
             ) -> torch.Tensor:
        """One update from ``grads`` (same order as the params) at
        ``scalars``, the update's (learning rate, 1 - b1^t, 1 - b2^t): a
        (3,) tensor of them, or by default :meth:`hyper`'s host numbers.
        Advances ``count``; returns the gradients' global norm before
        clipping (a 0-d tensor)."""
        with trace.span("train.optim"):
            grads, norm = clip_by_global_norm(grads, self.cfg.clip_norm)
            lr, c1, c2 = self.hyper() if scalars is None else scalars
            for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
                mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
                nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
                upd = (mu / c1) / (torch.sqrt(nu / c2 + self.eps_root)
                                   + self.eps)
                p.sub_(lr * upd)
            self.count += 1
            return norm
