"""CPU tests of the benchmark. They run the program's plain CPU path and
the reference at tiny widths; tests marked ``gpu`` decide inside the test
whether a card is present:

    python -m pytest benchmark/tests -q
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# tiny products gain nothing from threads; workers would oversubscribe
torch.set_num_threads(1)


def tiny_overrides(cell: str) -> dict:
    """Overrides that run ``cell`` on the CPU, as its traffic driver, the
    code of its model's family, cuts it: the configuration at that
    family's tiny widths (``tiny_config``) and a few small requests or
    steps (``TINY_MIX``)."""
    from benchmark import harness
    spec = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", spec["config"])
    mix = harness.load_json("traffic", spec["traffic"])
    driver = harness.load_module("traffic", mix["driver"])
    return {"config": driver.tiny_config(cfg), "mix": driver.TINY_MIX}


def tiny_cell(cell: str):
    from benchmark import harness
    return harness.load_cell(cell, overrides=tiny_overrides(cell))


def cells():
    return sorted(p.stem for p in (ROOT / "benchmark" / "workloads").glob(
        "*.json"))


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
