"""CPU tests of the benchmark. They run the program's plain CPU path and
the reference at tiny widths; tests marked ``gpu`` decide inside the test
whether a card is present:

    python -m pytest benchmark/tests -q
"""
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# tiny products gain nothing from threads; workers would oversubscribe
torch.set_num_threads(1)

#: mixes cut to a few tiny requests or steps, for runs on the CPU
TINY_MIX = {
    "serve": {"deck": 4, "check_requests": 4, "trace_requests": 2,
              "windows": {"min": 2, "max": 4, "spread": "log"},
              "interp": {"pairs": {"min": 1, "max": 2}, "int_count": 3,
                         "what": ["chord", "texture", "both"]}},
    "train": {"batch_size": 8, "segments": 64, "steps_per_epoch": 2,
              "trace_steps": 1},
}


def tiny_overrides(cell: str) -> dict:
    """Overrides that run ``cell`` at the tiny widths of the program's
    CPU tests, with a few small requests or steps."""
    from pctd_tpu_torch.config import tiny_model_config
    from benchmark import harness
    spec = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", spec["config"])
    mix = harness.load_json("traffic", spec["traffic"])
    tiny = dataclasses.asdict(tiny_model_config(
        txt_encoder=cfg["model"]["txt_encoder"]))
    tiny.pop("pianotree")
    tiny.pop("chord")
    return {"config": dict(cfg, model=tiny),
            "mix": TINY_MIX[mix["driver"]]}


def tiny_cell(cell: str):
    from benchmark import harness
    return harness.load_cell(cell, overrides=tiny_overrides(cell))


def cells():
    return sorted(p.stem for p in (ROOT / "benchmark" / "workloads").glob(
        "*.json"))


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
