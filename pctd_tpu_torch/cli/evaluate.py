"""Reconstruction NLL and ELBO terms of a checkpoint on a validation corpus
(the port's counterpart of the JAX package's ``scripts/evaluate.py``): the
11 loss metrics at teacher-forcing rate 0 and beta 0.1, averaged over the
val batches (shift 0, in order). ``--deterministic`` draws zero latent
noise (z is the posterior mean), so with every teacher coin 0 the result
has no randomness and compares with the JAX package's on the same weights.

Usage:
    python -m pctd_tpu_torch.cli.evaluate --checkpoint result_*/models/disvae_final
    python -m pctd_tpu_torch.cli.evaluate --deterministic   # fresh model
    python -m pctd_tpu_torch.cli.evaluate --checkpoint CKPT --midi-dir songs/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Sequence

import torch

from pctd_tpu_torch.cli.train import load_corpora
from pctd_tpu_torch.config import DataConfig, ModelConfig
from pctd_tpu_torch.data.loaders import make_loaders
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.train import checkpoint
from pctd_tpu_torch.train.trainer import batch_features, param_list, \
    stacked
from pctd_tpu_torch.utils.device import resolve_device

#: the seed offset of the non-deterministic evaluation's noise (the JAX
#: script's ``PRNGKey(seed ^ 0xE7A1)``)
EVAL_NOISE = 0xE7A1
#: the KL weight of the evaluated ELBO (the JAX script's)
BETA = 0.1


@torch.no_grad()
def evaluate(params: dict, mcfg: ModelConfig, val_batches,
             deterministic: bool = False,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, float]:
    """Mean of the 11 metrics over ``val_batches`` (teacher-forcing rate 0,
    :data:`BETA`), on the params' device, and ``num_batches``. Without
    ``deterministic`` the latent noise is drawn from ``generator``."""
    dev = param_list(params)[0].device
    sums, n = None, 0
    for batch in val_batches.epoch():
        pr, chord, shift = (torch.as_tensor(batch[k], device=dev)
                            for k in ("pr", "chord", "shift"))
        x, c, pr_mat, dt_x = batch_features(pr, chord, shift, mcfg)
        noise = (dv.fixed_noise(mcfg, x.shape[0], dev) if deterministic else
                 dv.draw_noise(generator, mcfg, x.shape[0], 0.0, 0.0, 0.0))
        _, metrics = dv.loss(params, mcfg, x, c, pr_mat, noise, beta=BETA,
                             dt_x=dt_x)
        m = stacked(metrics)
        sums = m if sums is None else sums + m
        n += 1
    result = (dict(zip(dv.METRIC_NAMES, (sums / n).tolist())) if n else
              {k: float("nan") for k in dv.METRIC_NAMES})
    result["num_batches"] = n
    return result


def main(argv: Optional[Sequence[str]] = None,
         model_config: Optional[ModelConfig] = None) -> Dict[str, float]:
    """Evaluate as the flags say and print the result as JSON. The model is
    the checkpoint's (its saved configuration), else a fresh one of
    ``model_config`` (default: the canonical widths) with ``--variant``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--variant", choices=["conv", "pianotree"],
                    default="conv")
    ap.add_argument("--data-path",
                    default="data/POP09-PIANOROLL-4-bin-quantization")
    ap.add_argument("--midi-dir", default=None,
                    help="evaluate on a corpus ingested from the MIDI files "
                         "under this directory")
    ap.add_argument("--synthetic-songs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=3345)
    ap.add_argument("--deterministic", action="store_true",
                    help="use posterior means instead of sampling")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dcfg = DataConfig(data_path=args.data_path, seed=args.seed)
    _, val_c, _ = load_corpora(args.data_path, args.synthetic_songs, dcfg,
                               args.midi_dir)
    mcfg = dataclasses.replace(model_config or ModelConfig(),
                               txt_encoder=args.variant)
    if args.checkpoint:
        saved = checkpoint.load_state(args.checkpoint)
        mcfg = checkpoint.model_config_of(saved) or mcfg
        params = checkpoint.params_of(saved, device)
        # a converted checkpoint holds params alone, and no step
        step = saved.get("step")
        print(f"loaded {args.checkpoint}"
              + ("" if step is None else f" (step {step})"))
    else:
        params = dv.init_params(mcfg, seed=args.seed, device=device)
    _, vl = make_loaders(val_c, val_c, args.batch_size, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed ^ EVAL_NOISE)
    result = evaluate(params, mcfg, vl, args.deterministic, gen)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
