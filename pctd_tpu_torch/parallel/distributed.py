"""Multi-process initialisation (``pctd_tpu/parallel/distributed.py``).

The JAX package adds processes only across hosts, each driving its local
chips. A torch rank drives one device, so here every device is a process:
:func:`initialize` joins this process to the job's group (over TCP, or from
``torchrun``'s environment). The JAX global and hybrid ``(dcn_data, data)``
meshes both become :func:`~pctd_tpu_torch.parallel.mesh.make_mesh` over
the world group (this rank's device, every rank of the job): NCCL reduces
hierarchically by itself (NVLink within a host, the network across hosts).
A rank's share of the global batch is
:func:`~pctd_tpu_torch.parallel.mesh.batch_rows`, its rows as tensors
:func:`~pctd_tpu_torch.parallel.mesh.shard_batch`, and rank 0's params on
every rank :func:`~pctd_tpu_torch.parallel.mesh.replicate`.

The backend is named by the caller: ``nccl`` on the card, ``gloo`` on the
CPU (gloo also takes CUDA tensors, which is how two ranks share one card).
Nothing switches from one to the other, and a group that cannot be formed
raises.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
#: how long a rank waits for the others to join the group or a collective
TIMEOUT = datetime.timedelta(minutes=10)


def _check_backend(backend: Optional[str]) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"name the backend: one of {BACKENDS}, not "
                         f"{backend!r}")
    return backend


def free_port() -> int:
    """A TCP port that was free on localhost a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join this process to the job's process group over ``backend``;
    returns whether a group was formed. A no-op (False) at
    ``num_processes`` <= 1. With ``coordinator_address`` (``host:port`` of
    rank 0) the group forms over TCP with ``num_processes`` ranks, this one
    ``process_id``; with no arguments, from ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``)."""
    backend = _check_backend(backend)
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in os.environ]
        if num_processes is not None or process_id is not None or missing:
            raise ValueError(
                "give coordinator_address, num_processes and process_id, or "
                f"run under torchrun (missing from the environment: "
                f"{missing})")
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
        return True
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and "
                         "process_id")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return True


def initialize_local(backend: Optional[str]) -> None:
    """A process group of this process alone (world size 1) over
    ``backend`` on a free localhost port: the collectives of the parallel
    step then run, as identities."""
    _check_backend(backend)
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, timeout=TIMEOUT)


def under_torchrun() -> bool:
    """Whether torchrun's environment names this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))
