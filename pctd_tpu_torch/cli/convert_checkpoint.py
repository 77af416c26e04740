"""Convert checkpoints between the PyTorch reference and the port (the
port's counterpart of the JAX package's ``scripts/convert_checkpoint.py``).

    # a reference .pt (torch.save of its state dict, DataParallel prefix
    # or not) -> a port checkpoint that cli.serve --checkpoint serves
    python -m pctd_tpu_torch.cli.convert_checkpoint --from-torch \\
        disvae_final.pt --out converted_ckpt

    # a port checkpoint (a run's, or a converted one) -> a .pt the
    # reference's PytorchModel.load_model reads
    python -m pctd_tpu_torch.cli.convert_checkpoint --to-torch out.pt \\
        --checkpoint <run>/models/disvae_valid

Importing, the texture-encoder variant (conv or pianotree) is read from the
state dict; exporting, from the checkpoint's model configuration (from its
params where it has none). ``--variant`` cross-checks either. A converted
checkpoint holds params and the model configuration (the canonical widths,
or ``main``'s ``model_config``, with the variant found): it serves as a
run's checkpoint does but does not resume. The params pass through the
device (``--device``, the card by default), as every entry point's do.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.train import checkpoint
from pctd_tpu_torch.utils import torch_interop as ti
from pctd_tpu_torch.utils.device import resolve_device
from pctd_tpu_torch.utils.weights import named_leaves


def _variant(params) -> str:
    return "conv" if "conv" in params["txt_enc"] else "pianotree"


def _shapes(params) -> dict:
    return {n: tuple(t.shape) for n, t in named_leaves(params).items()}


def main(argv: Optional[Sequence[str]] = None,
         model_config: Optional[ModelConfig] = None) -> str:
    """Convert as the flags say; returns the path written. ``model_config``
    replaces the canonical widths that an imported state dict must have."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--from-torch", default=None,
                    help="reference .pt state dict to import")
    ap.add_argument("--to-torch", default=None,
                    help="write a reference-loadable .pt here")
    ap.add_argument("--checkpoint", default=None,
                    help="port checkpoint to export (with --to-torch)")
    ap.add_argument("--train-state", action="store_true",
                    help="accepted for the JAX script's command lines and "
                         "ignored: a run's train state and a params-only "
                         "save are read alike")
    ap.add_argument("--out", default=None,
                    help="output checkpoint (with --from-torch)")
    ap.add_argument("--variant", default=None,
                    choices=["conv", "pianotree"],
                    help="expected texture-encoder variant (cross-check)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    base = model_config or ModelConfig()

    if args.from_torch:
        if not args.out:
            ap.error("--from-torch needs --out")
        params = ti.load_reference_checkpoint(args.from_torch,
                                              device=device)
        variant = _variant(params)
        if args.variant and args.variant != variant:
            ap.error(f"checkpoint is {variant!r}, --variant says "
                     f"{args.variant!r}")
        cfg = dataclasses.replace(base, txt_encoder=variant)
        want = _shapes(dv.init_params(cfg, device="cpu"))
        if _shapes(params) != want:
            diff = sorted(set(_shapes(params).items()) ^ set(want.items()))
            raise SystemExit(f"{args.from_torch}: its widths are not the "
                             f"model configuration's: {diff[:4]}")
        checkpoint.save_params(args.out, params, cfg)
        print(f"imported {args.from_torch} ({variant} texture variant) "
              f"-> {args.out}")
        return args.out
    if args.to_torch:
        if not args.checkpoint:
            ap.error("--to-torch needs --checkpoint")
        saved = checkpoint.load_state(args.checkpoint)
        params = checkpoint.params_of(saved, device)
        cfg = checkpoint.model_config_of(saved)
        variant = cfg.txt_encoder if cfg is not None else _variant(params)
        if args.variant and args.variant != variant:
            ap.error(f"checkpoint is {variant!r}, --variant says "
                     f"{args.variant!r}")
        ti.save_reference_checkpoint(args.to_torch, params)
        print(f"exported {args.checkpoint} -> {args.to_torch} "
              f"({variant} texture variant, reference state_dict format)")
        return args.to_torch
    ap.error("pass --from-torch or --to-torch")


if __name__ == "__main__":
    main()
