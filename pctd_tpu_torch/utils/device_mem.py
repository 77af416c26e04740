"""Device memory of the card, for the trainer's automatic gradient
accumulation (the HBM half of ``pctd_tpu/utils/device_mem.py``; VMEM is a
TPU budget with no counterpart here).

The step envelope in ``train.trainer`` was measured on one card
(:data:`MEASURED_HBM` bytes); a card with other memory scales it linearly
(activation memory dominates and grows with the batch). Resolution order:

1. the override ``PCTD_HBM_BYTES`` (bytes), as in the JAX package;
2. ``torch.cuda.get_device_properties(device).total_memory`` for a CUDA
   device;
3. unknown (None) otherwise, the CPU included: the envelope stays as
   measured.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

#: ``total_memory`` of the card the envelope was measured on (NVIDIA H100
#: 80GB HBM3, ``torch.cuda.get_device_properties(0).total_memory``)
MEASURED_HBM = 85_017_493_504


def hbm_bytes(device=None) -> Optional[int]:
    """Memory of ``device`` (default: the current CUDA device, when there
    is one) in bytes, or None if unknowable."""
    env = os.environ.get("PCTD_HBM_BYTES")
    if env:
        return int(env)
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def scale_by_hbm(base: int, device=None, granularity: int = 128,
                 floor: int = 128) -> int:
    """Scale a batch envelope measured on :data:`MEASURED_HBM` to this
    device's memory (linear), rounded down to ``granularity``. Unknown or
    equal memory -> ``base`` unchanged."""
    hbm = hbm_bytes(device)
    if hbm is None or hbm == MEASURED_HBM:
        return base
    scaled = int(base * (hbm / MEASURED_HBM))
    return max(floor, (scaled // granularity) * granularity)
