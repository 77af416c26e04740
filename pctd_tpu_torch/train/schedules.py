"""Training-parameter schedules (``pctd_tpu/train/schedules.py``):
scheduled-sampling teacher forcing, mirrored KL annealing and the
per-step exponential learning-rate decay with a floor. Host scalars in
float32, as the JAX package evaluates them."""
from __future__ import annotations

from typing import Dict

import numpy as np

from pctd_tpu_torch.config import TrainConfig

f32 = np.float32


def _sigmoid_ramp(i):
    """1 / (1 + exp(10 (i - 0.5))) in float32."""
    x = f32(10.0) * (f32(i) - f32(0.5))
    with np.errstate(over="ignore"):  # exp overflows to inf: the ramp is 0
        return f32(1.0) / (f32(1.0) + np.exp(x, dtype=f32))


def scheduled_sampling(i, high: float, low: float) -> float:
    """sigmoid(-10 (i - 0.5)) scaled to [low, high]."""
    return float(f32(high - low) * _sigmoid_ramp(i) + f32(low))


def kl_annealing(i, high: float, low: float) -> float:
    """Mirror ramp from low up to high."""
    hh, ll = 1.0 - low, 1.0 - high
    return float(f32(1.0) - (f32(hh - ll) * _sigmoid_ramp(i) + f32(ll)))


def train_params_at(step: int, cfg: TrainConfig) -> Dict[str, float]:
    """The scheduled scalars at ``step``: tfr1/2/3 and beta."""
    i = f32(step) / f32(cfg.sched_horizon)
    (h1, l1), (h2, l2), (h3, l3) = cfg.tf_rates
    return {"tfr1": scheduled_sampling(i, h1, l1),
            "tfr2": scheduled_sampling(i, h2, l2),
            "tfr3": scheduled_sampling(i, h3, l3),
            "beta": kl_annealing(i, cfg.beta, 0.0)}


def final_params(cfg: TrainConfig) -> Dict[str, float]:
    """The schedules' end values: tfr at their low ends, beta at its
    target (schedule-invariant validation)."""
    (_, l1), (_, l2), (_, l3) = cfg.tf_rates
    return {"tfr1": l1, "tfr2": l2, "tfr3": l3, "beta": cfg.beta}


def lr_at(count: int, cfg: TrainConfig) -> float:
    """Learning rate of update ``count`` (0 for the first): optax's
    ``exponential_decay(lr, 1, lr_decay, end_value=lr_min)``."""
    if count <= 0:
        value = f32(cfg.lr)
    else:
        value = f32(cfg.lr) * np.power(f32(cfg.lr_decay), f32(count),
                                       dtype=f32)
    floor = f32(cfg.lr_min)
    value = max(value, floor) if cfg.lr_decay < 1.0 else min(value, floor)
    return float(value)
