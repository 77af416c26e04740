"""Train and eval steps and the training run (``pctd_tpu/train/trainer.py``).

A train step is: raw uint8 segments -> on-device tensorize (and, for the
pianotree texture encoder, the detrended grid) -> the DisentangleVAE loss
(its decode through the K1/K2 kernel pair on the card, in the loss mode
that ``ModelConfig.fused_loss`` names) -> backward -> global-norm clip +
Adam at the scheduled learning rate. The schedules are evaluated at the
step count; the latent noise and the teacher coins come from one
``torch.Generator`` seeded from ``TrainConfig.seed``. Eval draws from a
generator of its own (:data:`EVAL_SEED`). On the card a single-device
step, from the batch on the device to its metrics and gradient norm, is a
CUDA-graph replay (:class:`StepGraph`, one a batch shape): the host copies
the batch and the step's scalars and launches the graph, where it issued
every op of the step before.

:class:`Trainer` runs epochs (``run``): the train and eval epochs sum their
metrics on the device and read the host only every ``log_every`` steps
(for the metric writers) and at the epoch's end; it saves the ``epoch``,
``valid`` (best val loss) and ``final`` checkpoints
(:mod:`pctd_tpu_torch.train.checkpoint`) into its run directory. The JAX
trainer's degrade from a kernel that fails to compile to the XLA path has
no counterpart: the port has no fallback from a kernel. ``Trainer(...,
mesh=)`` is one rank of a data-parallel run
(:mod:`pctd_tpu_torch.parallel.mesh`).

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

import gc
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig, TrainConfig
from pctd_tpu_torch.data import tensorize as tz
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.train import checkpoint, schedules
from pctd_tpu_torch.train.logging import MetricWriters, RunPaths
from pctd_tpu_torch.train.optim import Adam
from pctd_tpu_torch.utils import device_mem, trace
from pctd_tpu_torch.utils.device import names_device, resolve_device
from pctd_tpu_torch.utils.weights import named_leaves

#: the constant that keeps eval noise apart from the train stream (the JAX
#: trainer's ``fold_in(key, 0x5EED)``)
EVAL_SEED = 0x5EED

#: the scheduled values of a step (``schedules.train_params_at``), the
#: first four of a step's scalars (``Trainer._scalars``); Adam's three
#: (``Adam.hyper``) follow
SCHEDULED = ("tfr1", "tfr2", "tfr3", "beta")


#: the largest batch (segments) of one step that fits the card, by
#: (texture encoder, num_step): K1 keeps every frame's activations for K2,
#: so a segment's bytes grow with its frames. Measured by chip_smoke.py's
#: phases "auto accumulation" (T=32) and "stretch training" (T=128):
#: torch.cuda.max_memory_allocated of an f32 step, CE fused in, at B=128
#: and 512, extrapolated linearly to 90% of the card's memory, rounded down
#: to 128, on an NVIDIA H100 80GB HBM3 at a 700 W power limit; scaled to
#: another card's memory by device_mem.scale_by_hbm
STEP_ENVELOPE = {("conv", 32): 3840, ("pianotree", 32): 2560,
                 ("conv", 128): 896}


def step_envelope(mcfg: ModelConfig) -> int:
    """:data:`STEP_ENVELOPE` of ``mcfg``; raises for a configuration whose
    envelope was not measured."""
    key = (mcfg.txt_encoder, mcfg.pianotree.num_step)
    if key not in STEP_ENVELOPE:
        raise ValueError(
            f"no step envelope measured for texture encoder {key[0]!r} at "
            f"num_step={key[1]} (measured: {sorted(STEP_ENVELOPE)}); set "
            "TrainConfig.accum_steps explicitly")
    return STEP_ENVELOPE[key]


def batch_features(pr, chord, shift, mcfg: ModelConfig):
    """Raw segments (uint8 pr (B, 32, 128), chord (B, 8, 14), shift (B,))
    on the device -> (x (B, 32, K, 6) int32, c (B, 8, 36), pr_mat
    (B, 32, 128), dt_x): dt_x is the detrended grid (B, 32, 16, 39) for
    the pianotree texture encoder, else None."""
    f = tz.tensorize_batch(pr, chord, shift, spec=mcfg.pianotree,
                           with_detrend=mcfg.txt_encoder == "pianotree")
    return f["x"], f["c"], f["pr_mat"], f.get("dt_x")


def auto_accum_steps(mcfg: ModelConfig, tcfg: TrainConfig,
                     device=None) -> int:
    """``TrainConfig.accum_steps``, where 0 is automatic: the smallest
    microbatch count that divides the batch and keeps each microbatch
    inside the step envelope (:func:`step_envelope`, scaled to the memory
    of ``device``; unknown memory, the CPU's included, keeps it as
    measured). A batch whose smallest such divisor would make many tiny
    microbatches raises (the JAX function's search and error)."""
    if tcfg.accum_steps > 0:
        return tcfg.accum_steps
    envelope = device_mem.scale_by_hbm(step_envelope(mcfg), device)
    B = tcfg.batch_size
    ideal = max(1, -(-B // envelope))
    need = ideal
    while B % need:
        need += 1
    if need > max(8, 4 * ideal):
        raise ValueError(
            f"batch_size={B} exceeds the single-step HBM envelope "
            f"({envelope}) but its smallest divisor >= {ideal} is {need}, "
            f"which would scan {need} tiny microbatches. Pick a batch size "
            f"divisible by a small count (e.g. {ideal * envelope}) or set "
            f"accum_steps explicitly.")
    return need


def param_list(params) -> List[torch.Tensor]:
    """Every tensor of a params tree, in a fixed (insertion) order: the
    checkpoint's order."""
    return list(named_leaves(params).values())


def loss_and_grads(params, mcfg: ModelConfig, tcfg: TrainConfig,
                   sched: Dict[str, object], gen: torch.Generator, x, c,
                   pr_mat, accum: int = 1, dt_x=None, group=None,
                   noise: Optional[dv.Noise] = None
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """The 11 metrics and the gradients of every parameter (``param_list``
    order) at the scheduled values ``sched``
    (:func:`schedules.train_params_at`'s keys, as numbers or as 0-d tensors
    on the batch's device). With ``accum`` > 1 the batch splits into that
    many contiguous microbatches, each with its own noise, and metrics and
    gradients are their means. ``dt_x`` as :func:`batch_features` gives it.
    ``group`` as :func:`~pctd_tpu_torch.models.disentangle_vae.loss` takes
    it (the data-parallel step's). ``noise`` replaces the draw from ``gen``
    (one microbatch only)."""
    leaves = param_list(params)
    B = x.shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} "
                         "microbatches")
    if noise is not None and accum != 1:
        raise ValueError("noise is given for one microbatch, not "
                         f"{accum}")
    mb = B // accum
    sums, gsums = None, None
    for i in range(accum):
        part = slice(i * mb, (i + 1) * mb)
        with trace.span("train.forward"):
            drawn = noise if noise is not None else dv.draw_noise(
                gen, mcfg, mb, sched["tfr1"], sched["tfr2"], sched["tfr3"])
            total, metrics = dv.loss(
                params, mcfg, x[part], c[part], pr_mat[part], drawn,
                beta=sched["beta"], weights=tcfg.weights,
                weighted_dur=tcfg.weighted_dur,
                dt_x=None if dt_x is None else dt_x[part], group=group)
        with trace.span("train.backward"):
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
                 gen: torch.Generator, pr, chord, shift, group=None
                 ) -> Dict[str, torch.Tensor]:
    """Validation metrics of one batch: the training forward without
    gradients (the frame kernel's forward only), at the current schedules
    or, with ``eval_fixed_schedule``, at their end values. ``group`` as
    :func:`~pctd_tpu_torch.models.disentangle_vae.loss` takes it."""
    x, c, pr_mat, dt_x = batch_features(pr, chord, shift, mcfg)
    sched = (schedules.final_params(tcfg) if tcfg.eval_fixed_schedule
             else schedules.train_params_at(step, tcfg))
    noise = dv.draw_noise(gen, mcfg, x.shape[0], sched["tfr1"],
                          sched["tfr2"], sched["tfr3"])
    _, metrics = dv.loss(params, mcfg, x, c, pr_mat, noise,
                         beta=sched["beta"], weights=tcfg.weights,
                         weighted_dur=tcfg.weighted_dur, dt_x=dt_x,
                         group=group)
    return metrics


def _replays(device: torch.device) -> bool:
    """Whether a single-device step on ``device`` goes through a
    :class:`StepGraph`."""
    return device.type == "cuda"


class StepGraph:
    """One batch shape's train step ``run(*inputs)`` as a CUDA graph on a
    side stream of ``device``; ``inputs`` are the batch and the step's
    scalars on the device. :meth:`warm` runs a step eagerly on that stream
    (the warm-up PyTorch asks for before a capture: lazy set-up, the
    stream's cuBLAS workspace). :meth:`capture` captures the next one over
    its inputs, which stay the graph's static inputs, and registers ``gen``,
    so a replay draws the noise an eager step would and advances the
    generator's state as it would; ``torch.cuda.graph`` empties the
    allocator's cache first, so the warm-up's blocks do not stay beside the
    graph's. The kernel wrappers count their launches at the capture, as
    in an eager step; a replay runs the captured kernels and no wrapper, so
    it counts none. :meth:`replay` reruns the step over what the inputs
    hold now and overwrites ``outputs``. :meth:`release` lets the graph
    and its memory go; the next step captures again, with no warm-up. The
    graph keeps no reference to ``run``'s Trainer, so a Trainer let go
    frees its graphs at once; no garbage collection runs during a capture,
    since freeing another CUDA graph there would invalidate it."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self._gen = gen
        self._stream = torch.cuda.Stream(device)
        self._graph = None
        self.inputs = self.outputs = None

    def warm(self, run, inputs):
        main = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = run(*inputs)
        main.wait_stream(self._stream)
        return out

    def capture(self, run, inputs) -> None:
        self.inputs = inputs
        self._graph = torch.cuda.CUDAGraph()
        self._graph.register_generator_state(self._gen)
        collecting = gc.isenabled()
        gc.disable()    # a graph that a collection frees ends the capture
        try:
            with torch.cuda.graph(self._graph, stream=self._stream):
                self.outputs = run(*inputs)
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self._graph.replay()

    def release(self) -> None:
        self._graph = self.inputs = self.outputs = None


def stacked(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The 11 metrics as one (11,) tensor in ``METRIC_NAMES`` order."""
    return torch.stack([metrics[k] for k in dv.METRIC_NAMES])


def named(values: Sequence[float]) -> Dict[str, float]:
    return dict(zip(dv.METRIC_NAMES, values))


class Trainer:
    """Parameters, optimizer state and step count of one run, with train and
    eval steps over ``{pr, chord, shift}`` host batches
    (:class:`~pctd_tpu_torch.data.loaders.SegmentBatches`), and the epoch
    loop (:meth:`run`). :meth:`train_step` reads its metrics to the host:
    ``history`` keeps the 11 metrics of every such step, ``grad_norms`` the
    gradient global norm before clipping, ``step_seconds`` its host time.
    The epoch loop does not fill them: it sums on the device, and with
    ``writers`` writes a step's metrics every ``log_every`` steps.
    ``profile_steps`` (start, stop) takes a ``torch.profiler`` trace of
    those train steps of the first epoch into ``<run>/profile``; checkpoints
    go to ``run_paths.model_path(name, tag)``.

    On a CUDA device without a mesh a step is a CUDA-graph replay
    (:meth:`_graph_step`): the first step of a batch shape runs eagerly, the
    second is captured (:class:`StepGraph`, one a shape), and it and every
    later step of that shape replay the graph. An eval lets the graphs go,
    so that it has the step's memory, and the next train step captures
    again. ``step_captures`` and ``step_replays`` count them; on the CPU and
    with a mesh every step runs eagerly and both stay 0.

    With ``mesh`` (a :class:`~pctd_tpu_torch.parallel.mesh.Mesh` of one
    device and a process group) the Trainer is one rank of a data-parallel
    run: every rank reads the same global batches from loaders seeded
    alike and keeps its rows, the steps go through
    :func:`~pctd_tpu_torch.parallel.mesh.make_parallel_train_step` and
    :func:`~pctd_tpu_torch.parallel.mesh.make_parallel_eval_step` (metrics
    averaged over the ranks), rank 0's params are broadcast at the start,
    and the rank's generators are seeded by
    :func:`~pctd_tpu_torch.parallel.mesh.rank_seed`. Every rank calls
    :meth:`save_checkpoint` (it gathers the ranks' generator states); only
    the Trainer given ``run_paths`` writes, which is rank 0's in
    ``cli.train``. Only rank 0 prints the epoch lines."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig, train_batches,
                 val_batches=None, device=None, params: Optional[dict] = None,
                 name: str = "disvae", run_paths: Optional[RunPaths] = None,
                 writers: Optional[MetricWriters] = None, log_every: int = 16,
                 profile_steps: Optional[Tuple[int, int]] = None,
                 mesh=None):
        self.mcfg, self.tcfg = mcfg, tcfg
        self.mesh = mesh
        if mesh is not None:
            if len(mesh.devices) != 1:
                raise ValueError(f"a training rank drives one device, not "
                                 f"{len(mesh.devices)}")
            if not names_device(device, mesh.device):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        if mcfg.compute_dtype == "bfloat16":    # f32 partial sums, as JAX
            torch.backends.cuda.matmul \
                .allow_bf16_reduced_precision_reduction = False
        self.train_batches, self.val_batches = train_batches, val_batches
        self.name, self.run_paths, self.writers = name, run_paths, writers
        self.log_every, self.profile_steps = log_every, profile_steps
        self.params = params if params is not None else dv.init_params(
            mcfg, seed=tcfg.seed, device=self.device)
        self.leaves = param_list(self.params)
        for t in self.leaves:
            t.requires_grad_(True)
        self.opt = Adam(self.leaves, tcfg)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self._seed(tcfg.seed))
        if mesh is None:
            self.accum = auto_accum_steps(mcfg, tcfg, self.device)
        else:
            from pctd_tpu_torch.parallel import mesh as pm

            pm.replicate(mesh, self.params)
            self.accum = 1
            self._parallel_step = pm.make_parallel_train_step(
                mcfg, tcfg, self.opt, mesh)
            self._parallel_eval = pm.make_parallel_eval_step(mcfg, tcfg,
                                                             mesh)
        self.step_count = 0
        self.step_captures = self.step_replays = 0
        self._graphs: Dict[tuple, StepGraph] = {}
        if mesh is None and _replays(self.device):
            # one copy a step writes the schedules' and Adam's scalars
            self._dev_scalars = torch.zeros(len(SCHEDULED) + 3,
                                            device=self.device)
        self.train_counter = self.val_counter = 0
        self.history: List[Dict[str, float]] = []
        self.grad_norms: List[float] = []
        self.step_seconds: List[float] = []
        self._profiler = None

    @property
    def is_main(self) -> bool:
        """Rank 0 of a data-parallel run, or a single-device Trainer."""
        return self.mesh is None or self.mesh.rank == 0

    def _seed(self, seed: int) -> int:
        if self.mesh is None:
            return seed
        from pctd_tpu_torch.parallel.mesh import rank_seed

        return rank_seed(seed, self.mesh.rank)

    def _to_device(self, batch):
        """A host batch on the device: with a mesh, this rank's rows."""
        arrays = batch["pr"], batch["chord"], batch["shift"]
        with trace.span("train.data"):
            if self.mesh is not None:
                from pctd_tpu_torch.parallel.mesh import shard_batch

                return shard_batch(self.mesh, *arrays)
            return tuple(torch.as_tensor(np.asarray(a), device=self.device)
                         for a in arrays)

    def _scalars(self) -> torch.Tensor:
        """The step's scalars, a (7,) f32 CPU tensor: the scheduled values
        at ``step_count`` (:data:`SCHEDULED`), then Adam's next update's
        (lr, 1 - b1^t, 1 - b2^t) (:meth:`Adam.hyper`)."""
        sched = schedules.train_params_at(self.step_count, self.tcfg)
        return torch.tensor([sched[k] for k in SCHEDULED]
                            + self.opt.hyper(), dtype=torch.float32)

    def _run(self, pr, chord, shift, scalars
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A single-device step's device work: the features, the noise,
        loss and gradients of every microbatch, clip + Adam, from the batch
        and ``scalars`` (:meth:`_scalars`) on the device to (its 11 metrics
        (11,), the gradient norm). Reads nothing to the host and counts no
        step but Adam's ``count``: the function a :class:`StepGraph`
        captures."""
        n = len(SCHEDULED)
        with trace.span("train.forward"):
            x, c, pr_mat, dt_x = batch_features(pr, chord, shift, self.mcfg)
        metrics, grads = loss_and_grads(
            self.params, self.mcfg, self.tcfg,
            dict(zip(SCHEDULED, scalars[:n])), self.gen, x, c, pr_mat,
            self.accum, dt_x)
        return stacked(metrics), self.opt.step(grads, scalars[n:])

    def _graph_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_run` through a :class:`StepGraph` a batch shape: the
        shape's first step warms it, its second is captured and replayed,
        every later one replayed over the batch copied into the graph's
        inputs. The step's scalars go to the device in one copy first. The
        host's copies leave from pinned memory and do not wait for the
        card. The outputs are cloned, so no caller holds what the next
        replay overwrites."""
        arrays = [np.asarray(batch[k]) for k in ("pr", "chord", "shift")]
        key = tuple((a.shape, a.dtype.str) for a in arrays)
        graph = self._graphs.get(key)
        self._dev_scalars.copy_(self._pinned(self._scalars()),
                                non_blocking=True)
        if graph is None or graph.inputs is None:
            inputs = (*self._to_device(batch), self._dev_scalars)
            if graph is None:
                graph = self._graphs[key] = StepGraph(self.gen, self.device)
                return graph.warm(self._run, inputs)
            self._written()     # the weights' caches miss: packed inside
            count = self.opt.count
            graph.capture(self._run, inputs)
            self.opt.count = count  # the captured update runs at a replay
            self.step_captures += 1
        else:
            with trace.span("train.data"):
                for dst, a in zip(graph.inputs, arrays):
                    dst.copy_(self._pinned(torch.as_tensor(a)),
                              non_blocking=True)
        with trace.span("train.step"):
            graph.replay()
            out = tuple(t.clone() for t in graph.outputs)
        self.opt.count += 1
        self.step_replays += 1
        self._written()
        return out

    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor in pinned memory where the device is a card, so
        that a copy to it need not wait for the card; as it is elsewhere."""
        return t.pin_memory() if self.device.type == "cuda" else t

    def _release_graphs(self) -> None:
        """Let every captured step graph and its memory go; the next step
        of each shape captures again. What runs next (an eval) then reuses
        the step's memory as it would beside eager steps, and fits beside
        the train state at the step envelope."""
        if any(g.inputs is not None for g in self._graphs.values()):
            for graph in self._graphs.values():
                graph.release()
            torch.cuda.empty_cache()

    def _written(self) -> None:
        """Bump the params' version counters: a replay writes them where
        no PyTorch op says so, and a cache keyed by the weights' versions
        (K1's panels, ``train_frame.panels``) has to miss after it, and at
        a capture, so that the capture packs inside the graph."""
        torch.autograd.graph.increment_version(self.leaves)

    def _step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step; (its 11 metrics (11,), the gradient norm) on
        the device, nothing read to the host."""
        if self.mesh is not None:
            m, norm = self._parallel_step(self.params, self.step_count,
                                          self.gen, *self._to_device(batch))
        else:
            m, norm = (self._graph_step(batch) if _replays(self.device)
                       else self._run(*self._to_device(batch),
                                      self._scalars()))
        self.step_count += 1
        return m, norm

    def train_step(self, batch) -> Dict[str, float]:
        """One optimizer step on a host batch; returns its metrics."""
        t0 = time.perf_counter()
        m, norm = self._step(batch)
        self.history.append(named(m.tolist()))
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

    # -- phases ---------------------------------------------------------------

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._profiler = profile(activities=acts)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """Stop the trace of ``profile_steps`` and write it as a Chrome
        trace under ``<run>/profile``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = os.path.join(self.run_paths.log_path, "profile")
        os.makedirs(out, exist_ok=True)
        a, b = self.profile_steps
        self._profiler.export_chrome_trace(
            os.path.join(out, f"train_steps_{a}_{b}.json"))
        self._profiler = None

    def _epoch_end(self, sums, n: int, empty: float) -> Dict[str, float]:
        if n == 0:
            return {k: empty for k in dv.METRIC_NAMES}
        return named((sums / n).tolist())

    def train_epoch(self) -> Dict[str, float]:
        """One pass over the train batches: the mean of its metrics, summed
        on the device (0.0 each when the loader yields no batch, as in the
        JAX trainer). Writes a step's metrics every ``log_every`` steps."""
        sums, n = None, 0
        prof = self.profile_steps if self.run_paths else None
        batches = iter(self.train_batches.epoch())
        while True:
            with trace.span("train.data"):
                batch = next(batches, None)
            if batch is None:
                break
            if prof and self.train_counter == prof[0]:
                self._start_profile()
            m, _ = self._step(batch)
            if self._profiler is not None and self.train_counter == prof[1]:
                self._stop_profile()
            sums = m if sums is None else sums + m
            if self.writers and self.train_counter % self.log_every == 0:
                self.writers.write_task("train", named(m.tolist()),
                                        self.train_counter)
            self.train_counter += 1
            n += 1
        if self._profiler is not None:
            self._stop_profile()
        return self._epoch_end(sums, n, 0.0)

    def eval_generator(self) -> torch.Generator:
        """The generator of an eval: seeded from the run seed and
        :data:`EVAL_SEED` alone, so every eval draws the same noise (as the
        JAX trainer's ``fold_in(fold_in(state.key, 0x5EED), i)``, whose key
        never changes) and none repeats the train stream (seeded with the
        run seed alone); with a mesh, the rank's seed of that sum."""
        return torch.Generator(device=self.device).manual_seed(
            self._seed(self.tcfg.seed + EVAL_SEED))

    def eval_epoch(self) -> Dict[str, float]:
        """Mean metrics over the val batches, summed on the device (inf when
        there are none, so an empty split never looks best). Writes a
        batch's metrics every ``log_every`` batches. Lets the step graphs go
        first (:meth:`_release_graphs`)."""
        gen = self.eval_generator()
        sums, n = None, 0
        self._release_graphs()
        batches = () if self.val_batches is None else self.val_batches.epoch()
        for batch in batches:
            if self.mesh is not None:
                m = self._parallel_eval(self.params, self.step_count, gen,
                                        *self._to_device(batch))
            else:
                m = stacked(eval_metrics(self.params, self.mcfg, self.tcfg,
                                         self.step_count, gen,
                                         *self._to_device(batch)))
            sums = m if sums is None else sums + m
            if self.writers and self.val_counter % self.log_every == 0:
                self.writers.write_task("val", named(m.tolist()),
                                        self.val_counter)
            self.val_counter += 1
            n += 1
        return self._epoch_end(sums, n, float("inf"))

    # -- checkpointing ----------------------------------------------------------

    def save_checkpoint(self, tag: str) -> None:
        """Write the train state under ``tag`` where ``run_paths`` is given;
        with a mesh, every rank's generator state (every rank must call
        this: the states are gathered over the group)."""
        rank_gens = None
        if self.mesh is not None:
            from pctd_tpu_torch.parallel.mesh import gather_states

            rank_gens = gather_states(self.mesh, self.gen.get_state())
        if self.run_paths is None:
            return
        checkpoint.save_state(self.run_paths.model_path(self.name, tag),
                              self.params, self.opt, self.step_count,
                              self.gen, self.mcfg, rank_gens)

    def restore_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of a run of this world size (a
        single-device run's is of world size 1); another raises."""
        rank, world = ((0, 1) if self.mesh is None
                       else (self.mesh.rank, self.mesh.world))
        self.step_count = checkpoint.restore_state(
            path, self.params, self.opt, self.gen, rank, world)

    # -- the run ----------------------------------------------------------------

    def run(self, n_epoch: Optional[int] = None) -> Dict[str, object]:
        """Train and evaluate ``n_epoch`` epochs (default
        ``TrainConfig.n_epoch``), saving ``epoch`` after each,
        ``valid`` when the val loss improves and ``final`` at the end.
        Returns the last epoch's ``{"train", "val", "epoch_seconds"}`` (as
        the JAX trainer does) with its ``train_seconds`` and
        ``train_steps``."""
        n_epoch = n_epoch or self.tcfg.n_epoch
        best_val = float("inf")
        last = {}
        for epoch in range(n_epoch):
            t0 = time.time()
            steps = self.train_counter
            train_m = self.train_epoch()
            t_train = time.time() - t0
            val_m = self.eval_epoch()
            dt = time.time() - t0
            if self.tcfg.save_every_epoch:
                self.save_checkpoint("epoch")
            if val_m["loss"] < best_val:
                best_val = val_m["loss"]
                self.save_checkpoint("valid")
            if self.is_main:
                mins, secs = divmod(int(dt), 60)
                print(f"Epoch: {epoch + 1:02} | Time: {mins}m {secs}s",
                      flush=True)
                print(f"\tTrain Loss: {train_m['loss']:.3f}", flush=True)
                print(f"\t Valid. Loss: {val_m['loss']:.3f}", flush=True)
            last = {"train": train_m, "val": val_m, "epoch_seconds": dt,
                    "train_seconds": t_train,
                    "train_steps": self.train_counter - steps}
        self.save_checkpoint("final")
        return last
