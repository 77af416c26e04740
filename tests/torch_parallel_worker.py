"""One rank of the CPU data-parallel tests of the port (a gloo process
group), launched by ``tests/test_torch_port_parallel.py`` once a rank:

    python -m tests.torch_parallel_worker RANK WORLD PORT DIR

Reads ``DIR/inputs.pt`` (the model configuration, the params, the global
batch of the loss cases, the beta of step 0) and writes ``DIR/rank<R>.pt``:

- ``loss``: for each loss mode (``fused_loss`` True and False), the
  data-parallel step on this rank's rows of the global batch with zero
  latent noise and every teacher coin on, exact (``group``) and in the
  compat mode: the metrics averaged over the ranks and the averaged
  gradients that reached the optimizer;
- ``trainer``: a ``Trainer(mesh=)`` run of 4 steps on global batches of
  ``TRAIN_B`` rows from one seeded loader on every rank: its params after
  steps 1, 3 and 4, its history, its generator's state when it saved a
  checkpoint after step 2, and an eval epoch (one val batch of 4 rows, 2 a
  rank); its reference: ``make_parallel_train_step`` on fresh params, this
  rank's rows of the first global batch (``shard_batch``) and a generator
  seeded with ``rank_seed(seed, rank)`` (its metrics and params), and
  ``make_parallel_eval_step`` on the run's params, the val batch's rows
  and the rank seed of the eval seed; and a fresh Trainer restored from
  the checkpoint the run saved after step 2, 2 steps on: its params and
  history.

Imports nothing of JAX.
"""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pctd_tpu_torch.config import TrainConfig
from pctd_tpu_torch.data.loaders import SegmentCorpus, make_loaders
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.parallel import mesh as pm
from pctd_tpu_torch.train import checkpoint
from pctd_tpu_torch.train.logging import RunPaths
from pctd_tpu_torch.train.optim import Adam
from pctd_tpu_torch.train.trainer import EVAL_SEED, Trainer, named, \
    param_list
from pctd_tpu_torch.utils.weights import named_leaves

TRAIN_B = 8


class RecordingOpt:
    """Records the gradients a step hands to the optimizer."""

    def __init__(self):
        self.grads = None

    def step(self, grads):
        self.grads = [g.clone() for g in grads]
        return torch.zeros(())


def loss_cases(inputs, mesh) -> dict:
    params = checkpoint.params_of(inputs["params"], "cpu")
    for t in param_list(params):
        t.requires_grad_(True)
    batch = inputs["batch"]
    tcfg = TrainConfig(batch_size=len(batch["pr"]), accum_steps=1)
    pr, chord, shift = pm.shard_batch(mesh, batch["pr"], batch["chord"],
                                      batch["shift"])
    noise = dv.fixed_noise(inputs["cfg"], pr.shape[0], coins=True)
    out = {}
    for fused in (True, False):
        cfg = dataclasses.replace(inputs["cfg"], fused_loss=fused)
        for exact in (True, False):
            opt = RecordingOpt()
            step = pm.make_parallel_train_step(cfg, tcfg, opt, mesh,
                                               exact_loss=exact)
            m, _ = step(params, 0, None, pr, chord, shift, noise=noise)
            out[(fused, exact)] = {"metrics": m, "grads": dict(
                zip(named_leaves(params), opt.grads))}
    return out


def rows(mesh, batch):
    return pm.shard_batch(mesh, batch["pr"], batch["chord"], batch["shift"])


def step_reference(inputs, cfg, tcfg, mesh, rank: int, batch) -> dict:
    """The parallel step from the run's initial params on this rank's rows
    of ``batch``, noise drawn from the rank's generator."""
    params = checkpoint.params_of(inputs["params"], "cpu")
    leaves = param_list(params)
    for t in leaves:
        t.requires_grad_(True)
    step = pm.make_parallel_train_step(cfg, tcfg, Adam(leaves, tcfg), mesh)
    gen = torch.Generator().manual_seed(pm.rank_seed(tcfg.seed, rank))
    m, _ = step(params, 0, gen, *rows(mesh, batch))
    return {"metrics": named(m.tolist()),
            "params": [t.detach().clone() for t in leaves]}


def eval_reference(trainer, mesh, rank: int) -> dict:
    """The parallel eval step on the Trainer's params over its val batches
    (this rank's rows), noise from the rank seed of the eval seed."""
    step = pm.make_parallel_eval_step(trainer.mcfg, trainer.tcfg, mesh)
    gen = torch.Generator().manual_seed(
        pm.rank_seed(trainer.tcfg.seed + EVAL_SEED, rank))
    ms = [step(trainer.params, trainer.step_count, gen, *rows(mesh, b))
          for b in trainer.val_batches.epoch()]
    return named((sum(ms[1:], ms[0]) / len(ms)).tolist())


def trainer_run(inputs, mesh, rank: int, out_dir: str) -> dict:
    cfg = inputs["cfg"]
    rng = np.random.RandomState(11)
    pr = (rng.rand(4, 32, 128) < 0.03).astype(np.uint8) * 2
    chord = np.zeros((4, 8, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (4, 8))
    chord[..., 1:13] = rng.randint(0, 2, (4, 8, 12))
    chord[..., 13] = chord[..., 0]
    corpus = SegmentCorpus(pr, chord)
    tcfg = TrainConfig(batch_size=TRAIN_B, seed=5)

    def trainer(paths=None):
        train_b, val_b = make_loaders(corpus, corpus, TRAIN_B, seed=3)
        return Trainer(cfg, tcfg, train_b, val_b,
                       params=checkpoint.params_of(inputs["params"], "cpu"),
                       mesh=mesh, run_paths=paths)

    paths = RunPaths(root="run", with_date=False, base_dir=out_dir) \
        if rank == 0 else None
    whole = trainer(paths)
    batches = whole.batches()
    got = {}
    for i in range(4):
        batch = next(batches)
        whole.train_step(batch)
        if i == 0:
            got["step1_reference"] = step_reference(inputs, cfg, tcfg, mesh,
                                                    rank, batch)
        if i == 1:
            whole.save_checkpoint("half")
            got["gen_at_half"] = whole.gen.get_state()
        if i in (0, 2, 3):
            got[f"params{i + 1}"] = [t.detach().clone()
                                     for t in whole.leaves]
    got["history"] = whole.history
    got["val"] = whole.eval_epoch()
    got["val_reference"] = eval_reference(whole, mesh, rank)
    dist.barrier()
    resumed = trainer()
    resumed.restore_checkpoint(os.path.join(out_dir, "run", "models",
                                            "disvae_half"))
    later = resumed.batches()
    for _ in range(2):          # the loader's epoch order, as whole's
        next(later)
    for _ in range(2):
        resumed.train_step(next(later))
    got["resumed_params"] = [t.detach().clone() for t in resumed.leaves]
    got["resumed_history"] = resumed.history
    got["resumed_step"] = resumed.step_count
    return got


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = pm.make_mesh(device_type="cpu")
        assert (mesh.rank, mesh.world) == (rank, world)
        inputs = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
        result = {"loss": loss_cases(inputs, mesh),
                  "trainer": trainer_run(inputs, mesh, rank, out_dir)}
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
