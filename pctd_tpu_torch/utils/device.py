"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no card and no explicit device this raises: the port never
    falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def names_device(given: Optional[Union[str, torch.device]],
                 device: torch.device) -> bool:
    """Whether ``given`` (a device a caller named, or None) is ``device``:
    None, or the same type and no index or the same one."""
    if given is None:
        return True
    given = torch.device(given)
    return given.type == device.type and given.index in (None, device.index)
