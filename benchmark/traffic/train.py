"""The training driver: the program's ``Trainer`` runs its epoch loop
(``Trainer.train_epoch``, as ``cli.train`` runs it) over synthetic
segments made from the seed, ``steps_per_epoch`` steps an epoch, each
epoch ending in one read of its metrics to the host.

The mix file gives the corpus (``segments`` synthetic 2-bar segments,
every one at each transposition from ``shift_low`` to ``shift_high``,
walked in an order drawn from the seed), the batch and the published
training hyperparameters. Set-up builds the Trainer on the benchmark's
weights and runs its first ``check_steps`` steps as epochs of one step
through the same call and feed as the window, on rows that all differ:
they warm every shape, and the plain reference follows them after the
window. The numbers compared: each step's loss (``loss_gap``), the
first gradient as the optimizer received it, worked out from Adam's
first moment after one step (``grad_gap``), and the parameters' change
over the steps (``change_gap``), the last two by the worst leaf."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, port
from benchmark.reference import train as ref_train
from benchmark.reference.model import make_weights

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves under Adam by rounding alone: its change is not compared
STILL_LEAF = 1e-3
#: the mix cut to a few tiny steps, and the configuration at the
#: program's CPU-test widths: the size of the benchmark's CPU tests
TINY_MIX = {"batch_size": 8, "segments": 64, "steps_per_epoch": 2,
            "trace_steps": 1}
tiny_config = port.tiny_config


def segments(rng: np.random.Generator, n: int, density: float, hold: float):
    """Synthetic raw segments: uint8 rolls, onset 2 / sustain 1 / rest 0
    (a note is held on with probability ``hold`` a step), and raw chord
    rows [root, chroma (12), bass]."""
    pr = np.zeros((n, 32, 128), np.uint8)
    pr[rng.random((n, 32, 128)) < density] = 2
    for t in range(1, 32):
        held = ((pr[:, t - 1] > 0) & (pr[:, t] == 0)
                & (rng.random((n, 128)) < hold))
        pr[:, t][held] = 1
    chord = np.zeros((n, 8, 14), np.float32)
    chord[..., 0] = rng.integers(0, 12, (n, 8))
    chord[..., 1:13] = rng.integers(0, 2, (n, 8, 12))
    chord[..., 13] = rng.integers(0, 12, (n, 8))
    return pr, chord


class Feed:
    """Host batches ``{pr, chord, shift}`` for ``Trainer.train_epoch``:
    ``steps`` batches an epoch, walking (segment, shift) pairs in a seeded
    order."""

    def __init__(self, pr, chord, shifts, batch: int, rng):
        self.pr, self.chord, self.shifts = pr, chord, shifts
        self.batch, self.rng = batch, rng
        self.order = rng.permutation(len(pr) * len(shifts))
        self.pos, self.steps = 0, 1

    def next_batch(self) -> dict:
        if self.pos + self.batch > len(self.order):
            self.order, self.pos = self.rng.permutation(len(self.order)), 0
        idx = self.order[self.pos:self.pos + self.batch]
        self.pos += self.batch
        seg, sh = idx // len(self.shifts), idx % len(self.shifts)
        self.last = {"pr": self.pr[seg], "chord": self.chord[seg],
                     "shift": self.shifts[sh].astype(np.int32)}
        return self.last

    def epoch(self):
        for _ in range(self.steps):
            yield self.next_batch()


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; over the leaves ``keep`` names."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, tracer=None):
        self.cell, self.mix, self.w = cell, cell.mix, cell.widths
        self.seed, self.device, self.tracer = seed, device, tracer
        self.settings = ref_train.settings_of(cell.mix)
        self.noise_seed = harness.sub_seed(seed, "noise")

    def setup(self) -> None:
        mix = self.mix
        rng = np.random.default_rng(harness.sub_seed(self.seed, "segments"))
        pr, chord = segments(rng, mix["segments"], mix["onset_density"],
                             mix["hold"])
        shifts = np.arange(mix["shift_low"], mix["shift_high"] + 1)
        self.feed = Feed(pr, chord, shifts, mix["batch_size"], rng)
        self.p0 = make_weights(self.w, harness.sub_seed(self.seed,
                                                        "weights"),
                               self.device)
        tree = port.params_tree({k: v.clone() for k, v in self.p0.items()})
        tcfg = port.TrainConfig(
            batch_size=mix["batch_size"], lr=mix["lr"],
            lr_decay=mix["lr_decay"], lr_min=mix["lr_min"],
            clip_norm=mix["clip_norm"], beta=mix["beta"],
            weights=tuple(mix["weights"]),
            tf_rates=tuple(tuple(r) for r in mix["tf_rates"]),
            sched_horizon=mix["sched_horizon"], seed=self.noise_seed,
            accum_steps=mix["accum_steps"])
        self.trainer = port.Trainer(port.model_config(self.cell.config),
                                    tcfg, self.feed, device=self.device,
                                    params=tree,
                                    log_every=mix["steps_per_epoch"])
        names = port.leaf_names(self.trainer.params)
        leaves = dict(zip(names, self.trainer.leaves))
        # the first steps, one an epoch, through the window's own call
        self.batches: List[dict] = []
        self.losses: List[float] = []
        self.feed.steps = 1
        for step in range(mix["check_steps"]):
            self.losses.append(self.trainer.train_epoch()["loss"])
            self.batches.append(self.feed.last)
            if step == 0:
                b1 = self.trainer.opt.b1
                self.g1 = {n: m.detach() / (1.0 - b1) for n, m in
                           zip(names, self.trainer.opt.mu)}
        self.p_after = {n: t.detach().clone() for n, t in leaves.items()}
        if self.tracer is not None:
            self.tracer.warm()

    def run_window(self, run) -> None:
        mix, tracer = self.mix, self.tracer
        B = mix["batch_size"]
        start = run.window_t0
        first = tracer is not None
        while not run.epochs or time.perf_counter() - start < run.seconds:
            traced = first
            first = False
            self.feed.steps = (mix["trace_steps"] if traced
                               else mix["steps_per_epoch"])
            t0 = time.perf_counter()
            if traced:
                tracer.start()
            with tracer.span() if traced else contextlib.nullcontext():
                self.trainer.train_epoch()
            if traced:
                tracer.stop()
            run.epochs.append(harness.Epoch(t0, time.perf_counter(),
                                            self.feed.steps,
                                            self.feed.steps * B, traced))
        run.window_s = run.epochs[-1].t1 - start

    def release(self) -> None:
        del self.trainer

    def _numbers(self, out: ref_train.StepsOut) -> Dict[str, float]:
        """The three numbers of the program's first steps against ``out``."""
        g_ref = _norms(out.first_grads)
        med = float(np.median(list(g_ref.values())))
        moving = {k for k, v in g_ref.items() if v >= STILL_LEAF * med}
        change = lambda p: _norms({k: p[k] - self.p0[k] for k in p})
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(self.losses, out.losses)),
            "grad_gap": worst_leaf(_norms(self.g1), g_ref),
            "change_gap": worst_leaf(change(self.p_after),
                                     change(out.params), moving)}

    def _reference(self, tf32: str = "off", rows=None, alter=None):
        return ref_train.train_steps(self.p0, self.w, self.settings,
                                     self.batches, self.noise_seed,
                                     self.device, tf32=tf32, rows=rows,
                                     alter=alter)

    def check(self) -> dict:
        harness.reference_precision()
        nums = self._numbers(self._reference())
        return {k: (v, self.cell.limits.get(k, float("nan")))
                for k, v in nums.items()}

    def control(self, emulate: bool = False) -> Dict[str, Dict[str, float]]:
        """The numbers of the reference against the reference in the
        program's place: in TF32 (the control; emulated off the card),
        with half of each batch left out (the mean over the rest), with
        each note's pitch moved a semitone where the grid is made, and
        with the state left unchanged."""
        harness.reference_precision()
        ref = self._reference()
        keep = (self.g1, self.losses, self.p_after)
        out = {}
        try:
            B = self.mix["batch_size"]
            runs = {"half_batch": dict(rows=slice(0, B // 2)),
                    "token": dict(alter="pitch")}
            if emulate:
                runs["control"] = dict(tf32="emulate")
            else:
                with harness.tf32_on():
                    planted = self._reference()
                out["control"] = self._adopt(planted, ref)
            for name, kw in runs.items():
                out[name] = self._adopt(self._reference(**kw), ref)
            still = {k: torch.zeros_like(v)
                     for k, v in ref.first_grads.items()}
            out["unchanged"] = self._adopt(ref_train.StepsOut(
                ref.losses, still, self.p0), ref)
        finally:
            self.g1, self.losses, self.p_after = keep
        return out

    def _adopt(self, planted: ref_train.StepsOut, ref) -> Dict[str, float]:
        """The numbers with ``planted`` in the program's place."""
        self.g1, self.losses = planted.first_grads, planted.losses
        self.p_after = planted.params
        return self._numbers(ref)
