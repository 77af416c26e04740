"""The program under test as the benchmark drives it: ``pctd_tpu_torch``'s
configuration built from a configuration file, its parameter tree built
from the benchmark's weights, and its entry points. This is the only
module of the benchmark that imports the program."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from pctd_tpu_torch.config import (ChordSpec, ModelConfig,  # noqa: F401
                                   PianoTreeSpec, TrainConfig,
                                   tiny_model_config)
from pctd_tpu_torch.models.sampler import Sampler  # noqa: F401
from pctd_tpu_torch.ops.gru import GRUParams
from pctd_tpu_torch.train.trainer import Trainer  # noqa: F401
from pctd_tpu_torch.utils.weights import named_leaves


def model_config(cfg: dict) -> ModelConfig:
    """The program's configuration of a configuration file."""
    return ModelConfig(**cfg["model"],
                       pianotree=PianoTreeSpec(**cfg["pianotree"]),
                       chord=ChordSpec(**cfg["chord"]))


def tiny_config(cfg: dict) -> dict:
    """A configuration file's configuration at the widths of the program's
    CPU tests (``tiny_model_config``), its texture encoder and its
    ``pianotree`` and ``chord`` sections kept: the size at which the
    benchmark's CPU tests run a cell."""
    tiny = dataclasses.asdict(tiny_model_config(
        txt_encoder=cfg["model"]["txt_encoder"]))
    tiny.pop("pianotree")
    tiny.pop("chord")
    return dict(cfg, model=tiny)


def params_tree(flat: Dict[str, torch.Tensor]) -> dict:
    """The program's parameter tree of the benchmark's flat weights (the
    same tensors): nested dicts by name, a GRU's four leaves as one
    ``GRUParams``."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t

    def gru(node):
        if not isinstance(node, dict):
            return node
        if set(node) == set(GRUParams._fields):
            return GRUParams(*(node[f] for f in GRUParams._fields))
        return {k: gru(v) for k, v in node.items()}

    return gru(tree)


def leaf_names(params: dict):
    """The flat names of a parameter tree's leaves, in the program's
    order (its optimizer's)."""
    return list(named_leaves(params))
