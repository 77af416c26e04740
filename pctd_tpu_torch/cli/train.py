"""Train the chord/texture-disentangled VAE on the card (the port's
counterpart of the JAX package's ``train.py``).

Defaults are the canonical configuration (conv texture encoder); pass
``--variant pianotree`` for the PianoTree texture encoder. ``--midi-dir``
ingests a directory of MIDI files; else, without an npz corpus at
``--data-path``, a synthetic corpus is generated. Runs on
``cuda`` unless ``--device cpu`` is given.

``--parallel`` trains data-parallel over ``torch.distributed``, one rank a
card: under ``torchrun`` every rank runs on ``cuda:LOCAL_RANK`` and takes
its rows of each global ``--batch-size`` batch; without torchrun the run
is a process group of one rank. ``--dist-backend`` names the backend
(default: nccl on the card, gloo with ``--device cpu``). Only rank 0 writes
the run directory. Across hosts, ``pctd_tpu_torch.cli.launch_distributed``
starts a rank with an explicit coordinator.

Examples:
    python -m pctd_tpu_torch.cli.train --epochs 6 --batch-size 128
    torchrun --nproc-per-node 8 -m pctd_tpu_torch.cli.train --parallel
    python -m pctd_tpu_torch.cli.train --device cpu --parallel --epochs 1
    python -m pctd_tpu_torch.cli.train --variant pianotree --synthetic-songs 40
    python -m pctd_tpu_torch.cli.train --midi-dir songs/ --corpus-cache c/songs
    python -m pctd_tpu_torch.cli.train --device cpu --epochs 1 --batch-size 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from pctd_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from pctd_tpu_torch.data.loaders import make_loaders
from pctd_tpu_torch.models.disentangle_vae import METRIC_NAMES
from pctd_tpu_torch.parallel.distributed import (BACKENDS, initialize,
                                                 initialize_local,
                                                 under_torchrun)
from pctd_tpu_torch.parallel.mesh import make_mesh
from pctd_tpu_torch.train.logging import MetricWriters, RunPaths
from pctd_tpu_torch.train.trainer import Trainer
from pctd_tpu_torch.utils.device import resolve_device


def load_corpora(data_path: str, synthetic_songs: int, dcfg: DataConfig,
                 midi_dir: Optional[str] = None,
                 corpus_cache: Optional[str] = None):
    """(train, val) corpora and a description of where they came from: the
    MIDI files under ``midi_dir`` when given (ingested, and cached at
    ``corpus_cache``.{train,val}.npz when that is given), else the npz
    corpus when ``data_path`` is a directory, else synthetic songs."""
    if midi_dir:
        from pctd_tpu_torch.data.ingest import ingest_directory

        return (*ingest_directory(midi_dir, dcfg, cache=corpus_cache),
                f"ingested MIDI at {midi_dir}")
    if os.path.isdir(data_path):
        from pctd_tpu_torch.data.corpus import prepare_dataset

        return (*prepare_dataset(dcfg), f"npz at {data_path}")
    from pctd_tpu_torch.data.synthetic import synthetic_corpora

    return (*synthetic_corpora(n_songs=synthetic_songs, seed=dcfg.seed,
                               cfg=dcfg),
            f"synthetic, {synthetic_songs} songs")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=3345)
    ap.add_argument("--variant", choices=["conv", "pianotree"],
                    default="conv")
    ap.add_argument("--name", default="disvae")
    ap.add_argument("--data-path",
                    default="data/POP09-PIANOROLL-4-bin-quantization")
    ap.add_argument("--midi-dir", default=None,
                    help="build the corpus by ingesting the MIDI files "
                         "under this directory (pctd_tpu_torch.data.ingest)")
    ap.add_argument("--corpus-cache", default=None, metavar="PREFIX",
                    help="cache the ingested corpus at PREFIX.{train,val}.npz")
    ap.add_argument("--synthetic-songs", type=int, default=40,
                    help="synthetic corpus size when no npz data exists")
    ap.add_argument("--sched-horizon", type=float, default=1.0)
    ap.add_argument("--log-every", type=int, default=16,
                    help="write a step's metrics every N train steps (epoch "
                         "means are summed on the device regardless)")
    ap.add_argument("--eval-fixed-schedule", action="store_true",
                    help="evaluate at the schedules' final tfr/beta values")
    ap.add_argument("--result-dir", default=".")
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--fused-loss", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fuse the reconstruction CE into the frame kernels "
                         "(--no-fused-loss: logits out, scored apart)")
    ap.add_argument("--accum-steps", type=int, default=0,
                    help="gradient-accumulation microbatches a step (0 = "
                         "auto: engage when the batch exceeds the card's "
                         "measured step envelope)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="take a torch.profiler trace of N early steps")
    ap.add_argument("--parallel", action="store_true",
                    help="data parallel over torch.distributed, one rank a "
                         "device (torchrun's ranks, else one rank)")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="the process group's backend with --parallel "
                         "(default: nccl on cuda, gloo on the cpu)")
    ap.add_argument("--remat", action="store_true",
                    help="accepted and ignored: the port always decodes "
                         "through its frame kernels K1/K2a/K2b, which keep "
                         "what the backward needs (the JAX flag "
                         "rematerializes the XLA scans' activations)")
    ap.add_argument("--frame-kernel", action="store_true",
                    help="accepted and ignored: the port always decodes "
                         "through its frame kernels K1/K2a/K2b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def parallel_mesh(args, device: torch.device):
    """The data-parallel mesh of ``--parallel``: this rank's device and the
    process group, formed here (from torchrun's environment, else of this
    process alone) unless the caller formed one. Returns (mesh, whether
    this call formed the group)."""
    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise SystemExit("--dist-backend nccl runs on cuda; use gloo with "
                         "--device cpu")
    formed = not dist.is_initialized()
    if formed:
        if under_torchrun():
            initialize(backend=backend)
        else:
            initialize_local(backend)
    mesh = make_mesh(device_type=device.type)
    if device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh, formed


def main(argv: Optional[Sequence[str]] = None,
         model_config: Optional[ModelConfig] = None) -> dict:
    """Train as the flags say; ``model_config`` replaces the canonical
    widths (the flags' variant, dtype and loss mode still apply). Returns
    the last epoch's metrics, also written to ``<run>/final_metrics.json``."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh, formed = (parallel_mesh(args, device) if args.parallel
                    else (None, False))
    try:
        return _run(args, device, mesh, model_config)
    finally:
        if formed:
            dist.destroy_process_group()


def _run(args, device, mesh, model_config) -> dict:
    main_rank = mesh is None or mesh.rank == 0
    mcfg = dataclasses.replace(model_config or ModelConfig(),
                               txt_encoder=args.variant,
                               compute_dtype=args.compute_dtype,
                               fused_loss=args.fused_loss)
    tcfg = TrainConfig(batch_size=args.batch_size, n_epoch=args.epochs,
                       lr=args.lr, beta=args.beta, clip_norm=args.clip,
                       seed=args.seed, sched_horizon=args.sched_horizon,
                       eval_fixed_schedule=args.eval_fixed_schedule,
                       accum_steps=args.accum_steps)
    dcfg = DataConfig(data_path=args.data_path, seed=args.seed)
    train_c, val_c, source = load_corpora(args.data_path,
                                          args.synthetic_songs, dcfg,
                                          args.midi_dir, args.corpus_cache)
    say = print if main_rank else (lambda *a, **k: None)
    say(f"corpus: {len(train_c)} train / {len(val_c)} val segments "
        f"({source})")
    # with a mesh, every val batch splits evenly over the ranks
    val_batch = None if mesh is None else (
        min(args.batch_size, len(val_c)) // mesh.world * mesh.world)
    if val_batch == 0:
        raise SystemExit(f"{len(val_c)} val segments do not give each of "
                         f"{mesh.world} ranks a row")
    tl, vl = make_loaders(train_c, val_c, args.batch_size, dcfg.shift_low,
                          dcfg.shift_high, seed=args.seed,
                          val_batch_size=val_batch)
    paths = (RunPaths(readme_fn=__file__, base_dir=args.result_dir)
             if main_rank else None)
    writers = MetricWriters(METRIC_NAMES, paths.writer_path) if paths \
        else None
    trainer = Trainer(mcfg, tcfg, tl, vl, device=device, name=args.name,
                      run_paths=paths, writers=writers,
                      log_every=args.log_every,
                      profile_steps=((2, 2 + args.profile) if args.profile
                                     else None), mesh=mesh)
    say(f"device: {trainer.device}"
        + (f" ({torch.cuda.get_device_name(trainer.device)})"
           if trainer.device.type == "cuda" else ""))
    if mesh is not None:
        say(f"data-parallel over {mesh.world} rank(s), "
            f"{args.batch_size // mesh.world} rows each, "
            f"{dist.get_backend(mesh.group)}")
    try:
        result = trainer.run()
    finally:
        if writers:
            writers.close()
    if paths:
        with open(os.path.join(paths.log_path, "final_metrics.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
    say("Model saved.")
    return result


if __name__ == "__main__":
    main()
