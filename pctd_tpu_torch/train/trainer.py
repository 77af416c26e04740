"""Train and eval steps and a minimal Trainer
(``pctd_tpu/train/trainer.py``).

A train step is: raw uint8 segments -> on-device tensorize -> the
DisentangleVAE loss (its decode through the K1/K2 kernel pair on the card,
in the loss mode that ``ModelConfig.fused_loss`` names) -> backward ->
global-norm clip + Adam at the scheduled learning rate. The schedules are
evaluated at the step count; the latent noise and the teacher coins come
from one ``torch.Generator`` seeded from ``TrainConfig.seed``. Eval draws
from a generator of its own (:data:`EVAL_SEED`). Checkpoints, metric
writers and the training CLI are not ported yet.

With ``ModelConfig.compute_dtype="bfloat16"`` the step runs under the
mixed-precision policy (``pctd_tpu_torch.utils.precision``): the master
params, their gradients, the gradient norm and the Adam moments stay f32,
and the loss casts the params to bf16 inside, so autograd returns f32
gradients to the f32 leaves; the frame kernels K1/K2 run in their bf16
mode. Train and eval follow ``compute_dtype`` through the loss. Building a
bf16 ``Trainer`` sets ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`` to False for the process, and
leaves it so: PyTorch's default lets a split-K bf16 GEMM sum its partial
products in bf16, where JAX sums them in f32.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig, TrainConfig
from pctd_tpu_torch.data import tensorize as tz
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.train import schedules
from pctd_tpu_torch.train.optim import Adam
from pctd_tpu_torch.utils.device import resolve_device

#: the constant that keeps eval noise apart from the train stream (the JAX
#: trainer's ``fold_in(key, 0x5EED)``)
EVAL_SEED = 0x5EED


def batch_features(pr, chord, shift, mcfg: ModelConfig):
    """Raw segments (uint8 pr (B, 32, 128), chord (B, 8, 14), shift (B,))
    on the device -> (x (B, 32, K, 6) int32, c (B, 8, 36), pr_mat
    (B, 32, 128))."""
    pr_mat = tz.pr_to_dur_matrix(tz.shift_pr(pr.to(torch.int32), shift))
    x = tz.dur_matrix_to_grid(pr_mat, mcfg.pianotree)
    c = tz.expand_chord_batch(chord, shift)
    return x, c, pr_mat


def param_list(params) -> List[torch.Tensor]:
    """Every tensor of a params tree, in a fixed (insertion) order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_list(v)]
    if isinstance(params, tuple):
        return [t for v in params for t in param_list(v)]
    return [params]


def loss_and_grads(params, mcfg: ModelConfig, tcfg: TrainConfig, step: int,
                   gen: torch.Generator, x, c, pr_mat, accum: int = 1
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """The 11 metrics and the gradients of every parameter (``param_list``
    order) at ``step``'s schedules. With ``accum`` > 1 the batch splits into
    that many contiguous microbatches, each with its own noise, and metrics
    and gradients are their means."""
    sched = schedules.train_params_at(step, tcfg)
    leaves = param_list(params)
    B = x.shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} "
                         "microbatches")
    mb = B // accum
    sums, gsums = None, None
    for i in range(accum):
        part = slice(i * mb, (i + 1) * mb)
        noise = dv.draw_noise(gen, mcfg, mb, sched["tfr1"], sched["tfr2"],
                              sched["tfr3"])
        total, metrics = dv.loss(params, mcfg, x[part], c[part],
                                 pr_mat[part], noise, beta=sched["beta"],
                                 weights=tcfg.weights,
                                 weighted_dur=tcfg.weighted_dur)
        grads = torch.autograd.grad(total, leaves)
        m = torch.stack([metrics[k].detach() for k in dv.METRIC_NAMES])
        sums = m if sums is None else sums + m
        gsums = list(grads) if gsums is None else [
            a + g for a, g in zip(gsums, grads)]
    if accum > 1:
        sums = sums * (1.0 / accum)
        gsums = [g * (1.0 / accum) for g in gsums]
    return dict(zip(dv.METRIC_NAMES, sums)), gsums


@torch.no_grad()
def eval_metrics(params, mcfg: ModelConfig, tcfg: TrainConfig, step: int,
                 gen: torch.Generator, pr, chord, shift
                 ) -> Dict[str, torch.Tensor]:
    """Validation metrics of one batch: the training forward without
    gradients (the frame kernel's forward only), at the current schedules
    or, with ``eval_fixed_schedule``, at their end values."""
    x, c, pr_mat = batch_features(pr, chord, shift, mcfg)
    sched = (schedules.final_params(tcfg) if tcfg.eval_fixed_schedule
             else schedules.train_params_at(step, tcfg))
    noise = dv.draw_noise(gen, mcfg, x.shape[0], sched["tfr1"],
                          sched["tfr2"], sched["tfr3"])
    _, metrics = dv.loss(params, mcfg, x, c, pr_mat, noise,
                         beta=sched["beta"], weights=tcfg.weights,
                         weighted_dur=tcfg.weighted_dur)
    return metrics


class Trainer:
    """Parameters, optimizer state and step count of one run, with train and
    eval steps over ``{pr, chord, shift}`` host batches
    (:class:`~pctd_tpu_torch.data.loaders.SegmentBatches`). ``history`` keeps
    the 11 metrics of every train step, ``grad_norms`` the gradient global
    norm before clipping."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig, train_batches,
                 val_batches=None, device=None, params: Optional[dict] = None):
        self.mcfg, self.tcfg = mcfg, tcfg
        self.device = resolve_device(device)
        if mcfg.compute_dtype == "bfloat16":    # f32 partial sums, as JAX
            torch.backends.cuda.matmul \
                .allow_bf16_reduced_precision_reduction = False
        self.train_batches, self.val_batches = train_batches, val_batches
        self.params = params if params is not None else dv.init_params(
            mcfg, seed=tcfg.seed, device=self.device)
        self.leaves = param_list(self.params)
        for t in self.leaves:
            t.requires_grad_(True)
        self.opt = Adam(self.leaves, tcfg)
        self.gen = torch.Generator(device=self.device).manual_seed(
            tcfg.seed)
        self.accum = max(tcfg.accum_steps, 1)
        self.step_count = 0
        self.history: List[Dict[str, float]] = []
        self.grad_norms: List[float] = []
        self.step_seconds: List[float] = []

    def _to_device(self, batch):
        to = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        return to(batch["pr"]), to(batch["chord"]), to(batch["shift"])

    def train_step(self, batch) -> Dict[str, float]:
        """One optimizer step on a host batch; returns its metrics."""
        t0 = time.perf_counter()
        pr, chord, shift = self._to_device(batch)
        x, c, pr_mat = batch_features(pr, chord, shift, self.mcfg)
        metrics, grads = loss_and_grads(
            self.params, self.mcfg, self.tcfg, self.step_count, self.gen,
            x, c, pr_mat, self.accum)
        norm = self.opt.step(grads)
        self.step_count += 1
        host = torch.stack([metrics[k] for k in dv.METRIC_NAMES]).tolist()
        self.history.append(dict(zip(dv.METRIC_NAMES, host)))
        self.grad_norms.append(norm.item())
        self.step_seconds.append(time.perf_counter() - t0)
        return self.history[-1]

    def batches(self) -> Iterator[dict]:
        """Train batches, epoch after epoch."""
        while True:
            empty = True
            for batch in self.train_batches.epoch():
                empty = False
                yield batch
            if empty:
                raise ValueError("the train loader yields no batch")

    def train_steps(self, n: int) -> List[Dict[str, float]]:
        it = self.batches()
        return [self.train_step(next(it)) for _ in range(n)]

    def train_epoch(self) -> Dict[str, float]:
        """One pass over the train batches; the mean of its metrics (0.0
        each when the loader yields no batch, as in the JAX trainer)."""
        rows = [self.train_step(b) for b in self.train_batches.epoch()]
        if not rows:
            return {k: 0.0 for k in dv.METRIC_NAMES}
        return _mean(rows)

    def eval_generator(self) -> torch.Generator:
        """The generator of an eval: seeded from the run seed and
        :data:`EVAL_SEED` alone, so every eval draws the same noise (as the
        JAX trainer's ``fold_in(fold_in(state.key, 0x5EED), i)``, whose key
        never changes) and none repeats the train stream (seeded with the
        run seed alone)."""
        return torch.Generator(device=self.device).manual_seed(
            self.tcfg.seed + EVAL_SEED)

    def eval_epoch(self) -> Dict[str, float]:
        """Mean metrics over the val batches (inf when there are none, so an
        empty split never looks best)."""
        gen = self.eval_generator()
        rows = []
        for batch in self.val_batches.epoch():
            m = eval_metrics(self.params, self.mcfg, self.tcfg,
                             self.step_count, gen, *self._to_device(batch))
            rows.append(dict(zip(dv.METRIC_NAMES, torch.stack(
                [m[k] for k in dv.METRIC_NAMES]).tolist())))
        if not rows:
            return {k: float("inf") for k in dv.METRIC_NAMES}
        return _mean(rows)


def _mean(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {k: float(np.mean([r[k] for r in rows])) for k in dv.METRIC_NAMES}
