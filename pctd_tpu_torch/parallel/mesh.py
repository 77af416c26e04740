"""Data parallel over ``torch.distributed`` (``pctd_tpu/parallel/mesh.py``).

The JAX package runs one process over a mesh of local devices, with the
train step under ``shard_map``. PyTorch's idiom is one process a device,
joined by a process group, and the port takes it:

- every rank holds the same params and optimizer state (:func:`replicate`
  broadcasts rank 0's);
- every rank takes its own rows of the global batch (:func:`shard_batch`);
- the step runs the loss on those rows, then averages the gradients and the
  11 metrics over the ranks with one ``all_reduce`` (NCCL on the card, gloo
  on the CPU) before the same clip + Adam on every rank.

With ``exact_loss=True`` (the default) the masked reconstruction CE sums
its numerators and denominators over the ranks before the division
(``group=`` of :func:`~pctd_tpu_torch.models.disentangle_vae.loss`), so the
loss and the gradient of N ranks equal those of one device on the whole
batch. ``False`` is the reference-compat mode: each rank's own means, then
their mean over the ranks (DataParallel's reduction).

RNG follows DataParallel semantics, as the JAX step does by folding the
replica index into its key: each rank draws its own teacher coins and
latent noise, from a ``torch.Generator`` seeded with :func:`rank_seed` of
``TrainConfig.seed`` and the rank (rank 0 with the seed itself, so a run of
one rank draws what a single-device run draws).

The JAX parallel step has no gradient accumulation, and neither has this
one: :func:`make_parallel_train_step` raises when the configuration asks
for more than one microbatch of the rank's share.

Serving has no collectives (the JAX ``Sampler``'s mesh splits rows over
local devices): a :class:`Mesh` without a process group lists the devices
that ``Sampler(mesh=)`` splits each chunk's rows over.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pctd_tpu_torch.config import ModelConfig, TrainConfig
from pctd_tpu_torch.train import schedules
from pctd_tpu_torch.train.optim import Adam

#: the stride between the ranks' generator seeds (the golden-ratio
#: constant, so the seeds of neighbouring ranks share no low bits)
RANK_SEED_STRIDE = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices this process drives and the process group it belongs
    to. Training: one device, and ``group`` the ranks that share the batch
    (``None``: this process alone). Serving: the local devices a
    ``Sampler`` splits rows over, and no group."""
    devices: Tuple[torch.device, ...]
    group: Optional[object] = None
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} of world {self.world}")

    @property
    def device(self) -> torch.device:
        """The device of a training rank (its only one)."""
        return self.devices[0]


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of ``rank``: ``seed + rank * RANK_SEED_STRIDE``
    (rank 0: ``seed``)."""
    return seed + rank * RANK_SEED_STRIDE


def local_device(device_type: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` (torchrun's variable;
    without it the rank modulo the visible cards), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; make the mesh with "
                           "device_type='cpu' to run on the CPU")
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = (dist.get_rank() if dist.is_initialized() else 0) \
            % torch.cuda.device_count()
    return torch.device("cuda", index)


def make_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> Mesh:
    """Inside a process group (``torch.distributed`` initialised): this
    rank's device and the world group. Else the first ``n_devices`` local
    devices (default: every visible card; on the CPU, ``n_devices`` times
    the CPU) and no group."""
    if dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a torch rank drives one device, not "
                             f"{n_devices}")
        return Mesh((local_device(device_type),), dist.group.WORLD,
                    dist.get_rank(), dist.get_world_size())
    if device_type != "cuda":
        return Mesh((torch.device(device_type),) * (n_devices or 1))
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is available; make the mesh with "
                           "device_type='cpu' to run on the CPU")
    n = n_devices or count
    if n > count:
        raise ValueError(f"{n} devices asked for, {count} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def batch_rows(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch of ``global_batch`` rows."""
    if global_batch % mesh.world:
        raise ValueError(f"a batch of {global_batch} rows does not split "
                         f"over {mesh.world} ranks")
    share = global_batch // mesh.world
    return slice(mesh.rank * share, (mesh.rank + 1) * share)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of global host arrays (axis 0), as tensors on its
    device."""
    rows = batch_rows(mesh, arrays[0].shape[0])
    out = tuple(torch.as_tensor(np.asarray(a[rows]), device=mesh.device)
                for a in arrays)
    return out if len(out) > 1 else out[0]


@torch.no_grad()
def replicate(mesh: Mesh, params):
    """Rank 0's params on every rank, copied in place (a broadcast over the
    group; the tensors keep their identity). Returns ``params``."""
    if mesh.group is not None:
        from pctd_tpu_torch.utils.weights import named_leaves

        for t in named_leaves(params).values():
            dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
    return params


def mean_over_ranks(mesh: Mesh, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks (the JAX ``pmean``: the sum over
    the ranks, divided by their count), in one all-reduce of their
    concatenation. All tensors share one dtype and the mesh's device."""
    if mesh.group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = flat / mesh.world
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def gather_states(mesh: Mesh, state: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``state`` (a uint8 tensor of one size on all ranks, such
    as a generator's state), in rank order, on every rank. One all-reduce
    of a (world, n) tensor that each rank fills in its own row: gloo has no
    all-gather of CUDA tensors."""
    if mesh.group is None:
        return [state]
    rows = torch.zeros((mesh.world, state.numel()), dtype=torch.uint8,
                       device=mesh.device)
    rows[mesh.rank] = state.reshape(-1).to(mesh.device)
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=mesh.group)
    return [r.cpu().clone() for r in rows]


def _check_no_accumulation(mcfg: ModelConfig, tcfg: TrainConfig,
                           mesh: Mesh) -> None:
    from pctd_tpu_torch.train.trainer import auto_accum_steps

    share = batch_rows(mesh, tcfg.batch_size)
    share = share.stop - share.start
    need = auto_accum_steps(mcfg, dataclasses.replace(tcfg,
                                                      batch_size=share),
                            mesh.device)
    if need > 1:
        raise ValueError(
            f"the data-parallel step takes no gradient accumulation, as the "
            f"JAX one (accum_steps={tcfg.accum_steps}; {need} microbatches "
            f"of the rank's {share} rows): use more ranks or a smaller "
            f"batch")


def make_parallel_train_step(mcfg: ModelConfig, tcfg: TrainConfig,
                             opt: Adam, mesh: Mesh,
                             exact_loss: bool = True) -> Callable:
    """The data-parallel train step ``step(params, step, gen, pr, chord,
    shift, noise=None) -> (metrics (11,), grad norm)``: ``pr``, ``chord``,
    ``shift`` are this rank's rows on its device (:func:`shard_batch`),
    ``gen`` its generator and ``step`` the step count at whose schedules
    the loss runs (the caller counts steps). It tensorizes the rows, runs
    the loss on them (noise drawn from ``gen``, or ``noise``: a
    :class:`~pctd_tpu_torch.models.disentangle_vae.Noise` of the rank's
    rows), averages the gradients and the metrics over the ranks and takes
    ``opt``'s clip + Adam step on every rank; nothing is read to the host.
    ``tcfg.batch_size`` is the global batch. ``exact_loss`` as the module
    says. Raises ValueError where ``tcfg`` asks for gradient accumulation
    (``accum_steps`` > 1, or an automatic count above 1 for the rank's
    share)."""
    from pctd_tpu_torch.train import trainer as tr

    _check_no_accumulation(mcfg, tcfg, mesh)
    group = mesh.group if exact_loss else None

    def step(params, step_count: int, gen: torch.Generator, pr, chord,
             shift, noise=None):
        x, c, pr_mat, dt_x = tr.batch_features(pr, chord, shift, mcfg)
        metrics, grads = tr.loss_and_grads(
            params, mcfg, tcfg, schedules.train_params_at(step_count, tcfg),
            gen, x, c, pr_mat, dt_x=dt_x, group=group, noise=noise)
        *grads, m = mean_over_ranks(mesh, [*grads, tr.stacked(metrics)])
        return m, opt.step(grads)

    return step


def make_parallel_eval_step(mcfg: ModelConfig, tcfg: TrainConfig,
                            mesh: Mesh) -> Callable:
    """The data-parallel eval step ``step(params, step, gen, pr, chord,
    shift) -> metrics (11,)``: the validation metrics of this rank's rows
    (:func:`~pctd_tpu_torch.train.trainer.eval_metrics`), averaged over the
    ranks (the exact masked CE over the group's rows); no gradient."""
    from pctd_tpu_torch.train import trainer as tr

    def step(params, step_count: int, gen: torch.Generator, pr, chord,
             shift):
        m = tr.stacked(tr.eval_metrics(params, mcfg, tcfg, step_count, gen,
                                       pr, chord, shift,
                                       group=mesh.group))
        return mean_over_ranks(mesh, [m])[0]

    return step
