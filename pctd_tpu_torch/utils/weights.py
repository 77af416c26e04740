"""The weight bridge between the JAX package's parameter tree and the port.

The port keeps the JAX names and the JAX ``(in, out)`` layout (conv HWIO),
which the CUDA kernels read coalesced, so carrying a tree across is a copy
of every leaf: nested dicts stay dicts, a GRU entry (anything with
``w_ih/w_hh/b_ih/b_hh``, as attributes or keys) becomes a
:class:`~pctd_tpu_torch.ops.gru.GRUParams`, and every array becomes a
float32 tensor. :func:`export_params` is the inverse, bit-exact.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from pctd_tpu_torch.ops.gru import GRUParams
from pctd_tpu_torch.utils.device import resolve_device

_GRU_FIELDS = GRUParams._fields


def _gru_leaves(node: Any):
    """The four GRU arrays of ``node`` in field order, or None."""
    if isinstance(node, dict):
        if all(f in node for f in _GRU_FIELDS):
            return [node[f] for f in _GRU_FIELDS]
        return None
    if all(hasattr(node, f) for f in _GRU_FIELDS):
        return [getattr(node, f) for f in _GRU_FIELDS]
    return None


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.float32:
        raise TypeError(f"parameter of dtype {arr.dtype}; the port's "
                        "serving path takes float32 parameters")
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(tree: Any,
                    device: Optional[Union[str, torch.device]] = None):
    """JAX parameter tree (nested dicts of numpy arrays) -> the port's tree
    of tensors on ``device`` (default ``cuda``)."""
    device = resolve_device(device)

    def conv(node):
        leaves = _gru_leaves(node)
        if leaves is not None:
            return GRUParams(*(_tensor(a, device) for a in leaves))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, device)

    return conv(tree)


def export_params(params: Any):
    """The port's tree -> nested dicts of numpy arrays (a GRU entry becomes a
    dict with the four ``w_ih/w_hh/b_ih/b_hh`` keys)."""
    if isinstance(params, GRUParams):
        return {f: export_params(getattr(params, f)) for f in _GRU_FIELDS}
    if isinstance(params, dict):
        return {k: export_params(v) for k, v in params.items()}
    return params.detach().cpu().numpy().copy()


def params_to(params: Any, device: torch.device):
    """The same tree with every tensor on ``device``."""
    if isinstance(params, GRUParams):
        return GRUParams(*(t.to(device) for t in params))
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)
