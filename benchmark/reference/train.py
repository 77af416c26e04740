"""Plain PyTorch reference of training steps: the published schedules
(scheduled sampling, mirrored KL annealing, exponential learning-rate
decay with a floor), the latent noise and teacher coins drawn from one
seeded generator, the loss of :mod:`benchmark.reference.model`, autograd,
and global-norm clipping followed by Adam (optax's semantics: no epsilon
in the norm, b1 0.9, b2 0.999, eps 1e-8). It imports nothing of the
program under test."""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import data
from benchmark.reference.model import Reference, Widths, loss

Tensor = torch.Tensor
f32 = np.float32


class TrainSettings(NamedTuple):
    """The hyperparameters of a training mix (``traffic/<mix>.json``)."""
    lr: float
    lr_decay: float
    lr_min: float
    clip_norm: float
    beta: float
    weights: tuple
    tf_rates: tuple
    sched_horizon: float


def settings_of(mix: dict) -> TrainSettings:
    return TrainSettings(
        mix["lr"], mix["lr_decay"], mix["lr_min"],
        mix["clip_norm"], mix["beta"], tuple(mix["weights"]),
        tuple(tuple(r) for r in mix["tf_rates"]), mix["sched_horizon"])


def _ramp(i) -> f32:
    """1 / (1 + exp(10 (i - 0.5))) in float32."""
    x = f32(10.0) * (f32(i) - f32(0.5))
    with np.errstate(over="ignore"):
        return f32(1.0) / (f32(1.0) + np.exp(x, dtype=f32))


def schedules_at(step: int, s: TrainSettings) -> Dict[str, float]:
    """Teacher-forcing rates tfr1..3 (from high down to low) and the KL
    weight (from 0 up to ``beta``) at ``step``."""
    i = f32(step) / f32(s.sched_horizon)
    r = _ramp(i)
    out = {f"tfr{n + 1}": float(f32(hi - lo) * r + f32(lo))
           for n, (hi, lo) in enumerate(s.tf_rates)}
    hh, ll = 1.0 - 0.0, 1.0 - s.beta
    out["beta"] = float(f32(1.0) - (f32(hh - ll) * r + f32(ll)))
    return out


def lr_at(count: int, s: TrainSettings) -> float:
    """The learning rate of update ``count`` (0 for the first)."""
    v = f32(s.lr) if count <= 0 else f32(s.lr) * np.power(
        f32(s.lr_decay), f32(count), dtype=f32)
    floor = f32(s.lr_min)
    return float(max(v, floor) if s.lr_decay < 1.0 else min(v, floor))


def draw_noise(gen: torch.Generator, w: Widths, B: int, sched: dict):
    """(eps_chd, eps_rhy, coins1 (T,), coins2 (T, K), coins3 (S,)) in the
    order they are drawn from ``gen``: two standard-normal blocks, then
    uniforms below the teacher-forcing rates."""
    dev = gen.device
    eps_chd = torch.randn((B, w.chd_z), generator=gen, device=dev)
    eps_rhy = torch.randn((B, w.txt_z), generator=gen, device=dev)
    coins1 = torch.rand((w.T,), generator=gen, device=dev) < sched["tfr1"]
    coins2 = torch.rand((w.T, w.K), generator=gen, device=dev) \
        < sched["tfr2"]
    coins3 = torch.rand((w.chord_steps,), generator=gen, device=dev) \
        < sched["tfr3"]
    return eps_chd, eps_rhy, coins1, coins2, coins3


class Adam:
    """Global-norm clipping, then Adam, over a dict of leaves."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, Tensor], s: TrainSettings):
        self.p, self.s = params, s
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Update the params in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        keep = norm < self.s.clip_norm
        clipped = {k: torch.where(keep, g, g / norm * self.s.clip_norm)
                   for k, g in grads.items()}
        lr = lr_at(self.count, self.s)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, g in clipped.items():
            self.mu[k] = (1.0 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[k]
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                       + self.eps)
            self.p[k].sub_(lr * upd)
        return clipped


class StepsOut(NamedTuple):
    losses: List[float]              # each step's total loss
    first_grads: Dict[str, Tensor]   # step 1's clipped gradient, by leaf
    params: Dict[str, Tensor]        # the params after the steps
    margins: Optional[List[float]] = None  # each step's nearest tie


def train_steps(params0: Dict[str, Tensor], w: Widths, s: TrainSettings,
                batches, seed: int, device, tf32: str = "off",
                rows: Optional[slice] = None,
                alter: Optional[str] = None, watch: bool = False
                ) -> StepsOut:
    """The reference's steps from ``params0`` (copied) over raw batches
    ``[{pr, chord, shift}]`` (numpy), one step a batch, with its noise from
    a generator on ``device`` seeded with ``seed``. ``rows`` keeps only
    those rows of each batch after the noise is drawn (a planted fault:
    part of the batch left out, the mean over the rest); ``alter="pitch"``
    moves every note of the grid up a semitone where the grid is made (a
    planted fault: a token altered). ``watch`` keeps each step's smallest
    margin of an argmax decision of the decode (``Reference.margin``)."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params0.items()}
    opt = Adam(p, s)
    ref = Reference(p, w, tf32=tf32)
    gen = torch.Generator(device=device).manual_seed(seed)
    losses, first, margins = [], None, []
    for step, b in enumerate(batches):
        if watch:
            ref.margin = torch.tensor(float("inf"), device=device)
        raw = [torch.as_tensor(np.asarray(b[k]), device=device)
               for k in ("pr", "chord", "shift")]
        f = data.features(*raw, w)
        if alter == "pitch":
            x = f["x"].clone()
            note = x[..., 0] < w.pitch_sos
            x[..., 0] = torch.where(note, (x[..., 0] + 1) % 128, x[..., 0])
            f["x"] = x
            if "dt_x" in f:
                f["dt_x"] = data.detrend(x, f["c"])
        sched = schedules_at(step, s)
        eps_chd, eps_rhy, c1, c2, c3 = draw_noise(gen, w, raw[0].shape[0],
                                                  sched)
        sl = rows or slice(None)
        m = loss(ref, f["x"][sl], f["c"][sl], f["pr_mat"][sl],
                 f["dt_x"][sl] if "dt_x" in f else None, eps_chd[sl],
                 eps_rhy[sl], c1, c2, c3, sched["beta"], s.weights)
        grads = torch.autograd.grad(m["loss"], list(p.values()))
        clipped = opt.step(dict(zip(p.keys(), grads)))
        losses.append(float(m["loss"].detach()))
        if watch:
            margins.append(float(ref.margin))
        if first is None:
            first = {k: g.detach() for k, g in clipped.items()}
    return StepsOut(losses, first, {k: v.detach() for k, v in p.items()},
                    margins if watch else None)
