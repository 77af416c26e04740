"""Checkpoints of the whole train state (``pctd_tpu/train/checkpoint.py``,
whose orbax save holds params, optimizer state, step and PRNG key), with
``torch.save``/``torch.load``: the params by their tree names, Adam's
``mu``, ``nu`` and ``count``, the step count, and the train
``torch.Generator``'s state, which plays the part of the JAX key (the JAX
key is stateless, the generator is not). A data-parallel run saves every
rank's generator state instead, in rank order (``generators``), and
resumes only at the same world size. A restored run continues exactly as
the uninterrupted one does. The model configuration rides along, so a
checkpoint names the widths it was trained at, and :func:`load_model`
serves a checkpoint (or fresh weights) at those widths to the serving
CLIs. :func:`save_params` writes a checkpoint of params alone (a model
converted from the reference's ``.pt``, ``cli.convert_checkpoint``), which
serves as a run's does but does not resume.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from pctd_tpu_torch.config import ChordSpec, ModelConfig, PianoTreeSpec
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.utils.weights import named_leaves, params_from_jax


def save_state(path: str, params, opt, step: int,
               generator: torch.Generator,
               mcfg: Optional[ModelConfig] = None,
               rank_generators: Optional[List[torch.Tensor]] = None
               ) -> None:
    """Write the train state to ``path`` (one file). ``rank_generators``
    (a data-parallel run's generator states, in rank order) replaces
    ``generator``'s state."""
    gen = ({"generator": generator.get_state()} if rank_generators is None
           else {"generators": [g.cpu() for g in rank_generators]})
    torch.save({
        "params": {n: t.detach().cpu()
                   for n, t in named_leaves(params).items()},
        "mu": [t.cpu() for t in opt.mu], "nu": [t.cpu() for t in opt.nu],
        "count": opt.count, "step": step, **gen,
        "model_config": None if mcfg is None else dataclasses.asdict(mcfg),
    }, path)


def save_params(path: str, params, mcfg: ModelConfig) -> None:
    """Write the params of a model and its configuration to ``path`` (one
    file; no optimizer, step or generator state)."""
    torch.save({"params": {n: t.detach().cpu()
                           for n, t in named_leaves(params).items()},
                "model_config": dataclasses.asdict(mcfg)}, path)


def load_state(path: str) -> dict:
    """The saved dict, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_state(path: str, params, opt, generator: torch.Generator,
                  rank: int = 0, world: int = 1) -> int:
    """Copy the state saved at ``path`` into ``params``, ``opt`` and
    ``generator`` in place (the tensors keep their identity, so the
    optimizer and the kernels' weight caches see the new values); returns
    the saved step count. ``generator`` takes the state of ``rank`` of a
    run of ``world`` ranks; a checkpoint of another world size raises
    ValueError (a single-device run's is of world size 1)."""
    saved = load_state(path)
    mine = named_leaves(params)
    if list(mine) != list(saved["params"]):
        raise ValueError(f"{path}: its params are not this model's")
    states = saved.get("generators", [saved.get("generator")])
    if len(states) != world:
        raise ValueError(
            f"{path} was saved by a run of {len(states)} rank(s); it "
            f"resumes only at that world size, not at {world}")
    for n, t in mine.items():
        t.copy_(saved["params"][n])
    for dst, src in ((opt.mu, saved["mu"]), (opt.nu, saved["nu"])):
        for a, b in zip(dst, src, strict=True):
            a.copy_(b)
    opt.count = saved["count"]
    generator.set_state(states[rank])
    return saved["step"]


def model_config_of(saved: dict) -> Optional[ModelConfig]:
    """The :class:`ModelConfig` a loaded checkpoint names, if any."""
    d = saved.get("model_config")
    if d is None:
        return None
    return ModelConfig(**dict(d, pianotree=PianoTreeSpec(**d["pianotree"]),
                              chord=ChordSpec(**d["chord"])))


def params_of(saved: dict, device=None):
    """The params tree of a loaded checkpoint on ``device`` (default
    ``cuda``)."""
    tree: dict = {}
    for name, t in saved["params"].items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(t.numpy())
    return params_from_jax(tree, device)


def load_model(path: Optional[str], cfg: ModelConfig, seed: int, device
               ) -> Tuple[dict, ModelConfig]:
    """(params on ``device``, the serving config) for the serving CLIs: a
    checkpoint's params at the widths it names (``cfg``'s where it names
    none), else fresh ones of ``cfg`` from ``seed``; served in float32.
    They serve the conv texture encoder only, as the JAX package's scripts
    do: they compute no detrended grid, so a pianotree checkpoint raises
    ValueError."""
    if path:
        saved = load_state(path)
        cfg = model_config_of(saved) or cfg
    if cfg.txt_encoder != "conv":
        raise ValueError(
            f"{path or 'a fresh model'}: the {cfg.txt_encoder!r} texture "
            "encoder reads a detrended grid, which the serving CLIs do not "
            "compute; they serve 'conv' models only (serve this one with "
            "disentangle_vae's workflows and dt_x)")
    params = (params_of(saved, device) if path
              else dv.init_params(cfg, seed=seed, device=device))
    return params, dataclasses.replace(cfg, compute_dtype="float32")
