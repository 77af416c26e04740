"""Multi-process training launcher (the port's counterpart of the JAX
package's ``scripts/launch_distributed.py``).

A torch rank drives one device. On one host ``torchrun`` starts the ranks:

    torchrun --nproc-per-node 8 -m pctd_tpu_torch.cli.train --parallel

This launcher starts one rank with an explicit coordinator (a rank a host,
or any topology that torchrun does not describe), and rehearses the
data-parallel step on this machine's CPU:

  # explicit: run once a rank, process ids 0..N-1; the rank's card is
  # cuda:LOCAL_RANK (without LOCAL_RANK: the rank modulo the visible cards)
  python -m pctd_tpu_torch.cli.launch_distributed --coordinator host0:29500 \\
      --num-processes 2 --process-id 0 --dist-backend nccl -- --epochs 6

  # local rehearsal: N CPU processes joined over gloo, each one
  # data-parallel step of the tiny model on its rows of one seeded global
  # batch (zero latent noise, every teacher coin on), printing the loss
  python -m pctd_tpu_torch.cli.launch_distributed --rehearse 2

The arguments after ``--`` go to ``pctd_tpu_torch.cli.train``, with
``--parallel`` and the launcher's ``--dist-backend``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Optional, Sequence

#: the rehearsal's global batch (rows) and how long it waits for its ranks
REHEARSAL_BATCH = 16
REHEARSAL_TIMEOUT = 600


def rehearsal_batch() -> dict:
    """The rehearsal's seeded global batch ``{pr, chord, shift}``: the first
    batch of a synthetic corpus's train loader."""
    import dataclasses

    from pctd_tpu_torch.config import DataConfig
    from pctd_tpu_torch.data.loaders import make_loaders
    from pctd_tpu_torch.data.synthetic import synthetic_corpora

    train, val = synthetic_corpora(
        n_songs=4, seed=2, n_bars=8,
        cfg=dataclasses.replace(DataConfig(), portion=4))
    return next(make_loaders(train, val, REHEARSAL_BATCH, seed=0)[0]
                .epoch())


def rehearsal_step(mesh) -> float:
    """One data-parallel step of the tiny model (seed 0) on this rank's rows
    of :func:`rehearsal_batch`, with zero latent noise and every teacher
    coin on; returns the step's loss (its mean over the ranks)."""
    from pctd_tpu_torch.config import TrainConfig, tiny_model_config
    from pctd_tpu_torch.models import disentangle_vae as dv
    from pctd_tpu_torch.parallel import mesh as pm
    from pctd_tpu_torch.train.optim import Adam
    from pctd_tpu_torch.train.trainer import param_list

    cfg = tiny_model_config()
    params = dv.init_params(cfg, seed=0, device=mesh.device)
    leaves = param_list(params)
    for t in leaves:
        t.requires_grad_(True)
    tcfg = TrainConfig(batch_size=REHEARSAL_BATCH, accum_steps=1)
    pm.replicate(mesh, params)
    step = pm.make_parallel_train_step(cfg, tcfg, Adam(leaves, tcfg), mesh)
    b = rehearsal_batch()
    pr, chord, shift = pm.shard_batch(mesh, b["pr"], b["chord"], b["shift"])
    noise = dv.fixed_noise(cfg, pr.shape[0], mesh.device, coins=True)
    metrics, _ = step(params, 0, None, pr, chord, shift, noise=noise)
    return metrics[0].item()


def rehearsal_worker(rank: int, world: int, port: int) -> None:
    """One rank of :func:`rehearse`: joins the gloo group, runs
    :func:`rehearsal_step`, prints its loss."""
    import torch
    import torch.distributed as dist

    from pctd_tpu_torch.parallel import distributed
    from pctd_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    formed = distributed.initialize(f"localhost:{port}", world, rank, "gloo")
    try:
        loss = rehearsal_step(make_mesh(device_type="cpu"))
    finally:
        if formed:
            dist.destroy_process_group()
    print(f"REHEARSAL_OK rank={rank} world={world} loss={loss!r}",
          flush=True)


def rehearse(n_proc: int, timeout: float = REHEARSAL_TIMEOUT) -> int:
    """Spawn ``n_proc`` local CPU ranks of :func:`rehearsal_worker`, wait
    for them (killing any still running after ``timeout`` seconds) and
    return the largest exit code."""
    from pctd_tpu_torch.parallel.distributed import free_port

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pctd_tpu_torch.cli.launch_distributed",
         "--rehearsal-rank", str(rank), str(n_proc), str(port)],
        env=env, cwd=repo) for rank in range(n_proc)]
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                rcs.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"rehearsal: {n_proc} processes x 1 device, rcs={rcs}",
          flush=True)
    return max(rcs)


def parser() -> argparse.ArgumentParser:
    from pctd_tpu_torch.parallel.distributed import BACKENDS

    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="nccl on the card, gloo on the cpu (required "
                         "unless rehearsing, which runs gloo)")
    ap.add_argument("--rehearse", type=int, default=0, metavar="N",
                    help="spawn N local CPU ranks over gloo and run one "
                         "data-parallel step (a smoke test, no training)")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="accepted and ignored: a torch rank drives one "
                         "device (the JAX launcher's processes drive many)")
    ap.add_argument("--rehearsal-rank", type=int, nargs=3, default=None,
                    metavar=("RANK", "WORLD", "PORT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("train_args", nargs="*",
                    help="arguments forwarded to pctd_tpu_torch.cli.train "
                         "(after --)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    if args.rehearsal_rank:
        rehearsal_worker(*args.rehearsal_rank)
        return 0
    if args.rehearse:
        return rehearse(args.rehearse)
    if args.dist_backend is None:
        raise SystemExit("name the backend: --dist-backend nccl (the card) "
                         "or gloo (the cpu)")
    import torch.distributed as dist

    from pctd_tpu_torch.cli import train
    from pctd_tpu_torch.parallel import distributed

    formed = distributed.initialize(args.coordinator, args.num_processes,
                                    args.process_id, args.dist_backend)
    try:
        train.main(["--parallel", "--dist-backend", args.dist_backend,
                    *args.train_args])
    finally:
        if formed:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
