"""The benchmark's harness, driven by data: a cell
(``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<mix>.json``),
the configuration names its plain reference (``reference``, a path from
the checkout's root), whose ``widths_of`` gives its sizes, the mix names
its driver (``traffic/<driver>.py``), and each metric that
``BENCHMARK.json`` lists for the cell is read by its own reader
(``metrics/<metric>.py``). Nothing here names a cell, a configuration, a
model's sections, a mix or a metric.

One call of :func:`run_cell` is one run of one cell: the traffic driver
sets up the program and warms every shape the traffic uses (``setup_s``
runs from process start to the window's first request or step), the
window runs for the given seconds (with ``trace`` a short sub-window of
it under ``torch.profiler``), the program's state is freed, and the
traffic driver's comparison with the plain reference decides
``correct``. The result is
the last line of standard output; each number compared, beside its
limit, ends standard error and is the result's last key.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: top-level modules that may not be loaded by a run: JAX and the JAX
#: package (the port, ``pctd_tpu_torch``, is another top-level name)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pctd_tpu"})


def load_json(kind: str, name: str, root: Path = BENCH) -> dict:
    """``<root>/<kind>/<name>.json``; a name outside the allowed
    characters is refused."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = BENCH):
    """The module ``<root>/<kind>/<name>.py``, loaded by its path."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(cfg: dict):
    """The plain reference that a configuration names (``reference``: a
    ``.py`` file under the checkout's root), imported by the dotted name of
    its path, so that it is the one module object the traffic drivers
    import."""
    path = Path(cfg["reference"])
    if (path.suffix != ".py" or path.is_absolute() or ".." in path.parts
            or not all(NAME.match(p) for p in path.with_suffix("").parts)):
        raise ValueError(f"bad reference {cfg['reference']!r}")
    return importlib.import_module(".".join(path.with_suffix("").parts))


class Cell(NamedTuple):
    name: str
    config: dict
    mix: dict
    limits: dict
    widths: Any             # the reference module's ``widths_of(config)``


def load_cell(name: str, root: Path = BENCH, overrides: Optional[dict] = None
              ) -> Cell:
    """A cell with its configuration and mix; ``overrides`` (tests) may
    replace sections of the configuration and keys of the mix."""
    spec = load_json("workloads", name, root)
    cfg = load_json("configs", spec["config"], root)
    mix = load_json("traffic", spec["traffic"], root)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("mix", {})}
    return Cell(name, cfg, mix, spec.get("limits", {}),
                reference_module(cfg).widths_of(cfg))


def manifest_metrics(cell: str, trace: bool, root: Path = ROOT) -> List[dict]:
    """The metrics ``BENCHMARK.json`` lists for ``cell``: the end-to-end
    ones without a trace, the per-layer ones with it. A metric without a
    ``workloads`` key belongs to every cell."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if cell in m.get("workloads", [cell])]


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of randomness of a run (weights,
    requests, the check's sample...), from the run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64),
                                 zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Request(NamedTuple):
    arrival: float      # when it was due (host clock)
    t0: float           # its service began
    t1: float           # its grid was in hand
    segments: int       # rows decoded (an interpolation's points included)
    kind: str
    traced: bool
    ok: bool


class Epoch(NamedTuple):
    t0: float
    t1: float
    steps: int
    segments: int
    traced: bool


class RunRecord:
    """What a run measured, as the metric readers read it."""

    def __init__(self, cell: Cell, seconds: float):
        self.seconds = seconds
        self.widths = cell.widths
        self.mix = cell.mix
        self.kind = cell.mix["driver"]
        self.setup_s: Optional[float] = None
        self.window_t0: Optional[float] = None
        self.window_s: Optional[float] = None
        self.requests: List[Request] = []
        self.epochs: List[Epoch] = []
        self.batch_size: Optional[int] = cell.mix.get("batch_size")
        self.trace = None                 # tracing.TraceView with --trace 1
        self.setup_peak_bytes: Optional[int] = None
        self.window_peak_bytes: Optional[int] = None


def _set_precision(tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def reference_precision():
    """Float32 with TF32 off, for the plain reference on the card."""
    _set_precision(False)


class tf32_on:
    """TF32 on inside the ``with`` block (the lower-precision control)."""

    def __enter__(self):
        _set_precision(True)

    def __exit__(self, *exc):
        _set_precision(False)


def free_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(device: torch.device) -> dict:
    """The device block of the result: the card's name, the cards used,
    the memory peak and the power limit read by ``nvidia-smi``."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            timeout=30)
        info["power_limit_w"] = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit_w"] = "not read"
    return info


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & FORBIDDEN)


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[dict] = None, out=None, err=None) -> int:
    """One run of cell ``name``; prints the result line and returns the
    exit code. ``t_start`` is the process's start on the host clock."""
    out = out or sys.stdout
    err = err or sys.stderr
    cell = load_cell(name, overrides=overrides)
    metrics = manifest_metrics(name, trace)
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in metrics}
    driver_mod = load_module("traffic", cell.mix["driver"])
    dev = torch.device(device)
    run = RunRecord(cell, seconds)
    tracer = None
    if trace:
        from benchmark.tracing import Tracer
        tracer = Tracer(dev)
    drv = driver_mod.Driver(cell, seed, dev, tracer)
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        run.setup_peak_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.window_t0 = time.perf_counter()
    run.setup_s = run.window_t0 - t_start
    drv.run_window(run)
    memory_peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        memory_peak = max(run.setup_peak_bytes, run.window_peak_bytes)
    if tracer is not None:
        run.trace = tracer.view()
    drv.release()
    free_device_memory()
    checks = drv.check()
    failed = sum(not r.ok for r in run.requests)
    attempted = len(run.requests) + sum(e.steps for e in run.epochs)
    correct = failed == 0 and bool(checks) and all(
        v <= lim for v, lim in checks.values())
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is None or not math.isfinite(v):
            print(f"metric {m['name']}: nothing to read in this run ({v})",
                  file=err)
            continue
        values[m["name"]] = {"value": v, "unit": m["unit"]}
    info = device_info(dev)
    info["memory_peak_bytes"] = int(memory_peak)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": info}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": _number(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    bad = loaded_forbidden()
    if bad:
        print(f"refused: the run loaded {bad} (JAX or the JAX package)",
              file=err)
        return 3
    print(json.dumps(result), file=out, flush=True)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {_number(v)} (limit {lim})", file=err, flush=True)
    return 0
