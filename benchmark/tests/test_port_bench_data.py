"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric added as new files are found by name with no edit
to a file that is there, also where the configuration is of another model
family, with its own reference and driver; every cell names a
configuration and a mix that exist, every mix a driver that exists, every
metric a reader; the manifest agrees with the cell files and keeps the
allowed characters."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, cells, manifest
from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "pctd-conv-2bar.json").read_text())
    (root / "configs" / "new-config.json").write_text(
        json.dumps(dict(cfg, name="new-config")))
    mix = json.loads((root / "traffic" / "songs.json").read_text())
    (root / "traffic" / "new-mix.json").write_text(
        json.dumps(dict(mix, deck=8)))
    (root / "workloads" / "new-cell.json").write_text(json.dumps(
        {"config": "new-config", "traffic": "new-mix", "chips": 1,
         "why": "a cell added as data", "limits": {"logit_gap": 1e-3}}))
    (root / "metrics" / "new_metric.serve.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = manifest()
    bench["per_layer"].append({"name": "new_metric.serve", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "serve_p95_ms",
                               "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("new-cell", root)
    assert cell.mix["deck"] == 8 and cell.config["name"] == "new-config"
    assert cell.limits == {"logit_gap": 1e-3}
    names = [m["name"] for m in harness.manifest_metrics("new-cell", True,
                                                         tmp_path)]
    assert names == ["new_metric.serve"]
    assert harness.load_module("metrics", "new_metric.serve",
                               root).read(None) == 42.0
    assert harness.load_module("traffic", cell.mix["driver"], root).Driver
    assert all(p.read_bytes() == b for p, b in before.items())


#: a model family of its own: sizes in a section no DisentangleVAE
#: configuration has, its plain reference in float64
STUB_REFERENCE = '''"""A stub family's plain reference: ``depth`` products
and tanh over ``channels``, in float64, or in bfloat16 (the control)."""
import torch


def widths_of(cfg):
    return cfg["unet"]["channels"], cfg["unet"]["depth"]


def chain(x, w, depth, dtype=torch.float64):
    x, w = x.to(dtype), w.to(dtype)
    for _ in range(depth):
        x = torch.tanh(x @ w)
    return x.double()
'''

#: its driver: the program is the same products in float32 under a span
#: of its own, one step an epoch
STUB_DRIVER = '''"""A stub family's traffic driver."""
import contextlib
import time

import torch

from benchmark import harness
from benchmark.reference import stub as ref
from pctd_tpu_torch.utils import trace

TINY_MIX = {"rows": 4}


def tiny_config(cfg):
    return dict(cfg, unet=dict(cfg["unet"], channels=8))


class Driver:
    def __init__(self, cell, seed, device, tracer=None):
        self.cell, self.device, self.tracer = cell, device, tracer
        self.ch, self.depth = cell.widths
        self.gen = torch.Generator().manual_seed(
            harness.sub_seed(seed, "stub"))

    def setup(self):
        rows = self.cell.mix["rows"]
        self.x = torch.randn(rows, self.ch, generator=self.gen)
        self.w = torch.randn(self.ch, self.ch, generator=self.gen)
        self.w /= self.ch ** 0.5
        self.step()

    def step(self):
        with trace.span("stub.step"):
            y = self.x.to(self.device)
            for _ in range(self.depth):
                y = torch.tanh(y @ self.w.to(self.device))
        self.y = y.cpu().double()

    def run_window(self, run):
        traced = self.tracer is not None
        t0 = time.perf_counter()
        if traced:
            self.tracer.start()
        with self.tracer.span() if traced else contextlib.nullcontext():
            self.step()
        if traced:
            self.tracer.stop()
        t1 = time.perf_counter()
        run.epochs.append(harness.Epoch(t0, t1, 1, len(self.x), traced))
        run.window_s = t1 - run.window_t0

    def release(self):
        pass

    def _gap(self, y):
        return float((y - ref.chain(self.x, self.w, self.depth)).abs().max())

    def check(self):
        return {"gap": (self._gap(self.y), self.cell.limits["gap"])}

    def control(self, emulate=False):
        low = ref.chain(self.x, self.w, self.depth, torch.bfloat16)
        return {"control": {"gap": self._gap(low)}}
'''

STUB_RUN = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
import benchmark.reference.stub as stub
assert stub.__file__.startswith({root!r}), stub.__file__
for trace in (False, True):
    assert harness.run_cell("stub-cell", 2 ** 33 + 3, 0.1, trace,
                            time.perf_counter(), device="cpu") == 0
"""


def _stub_family(root):
    """Add, as new files only, a cell of a stub family to the copy of the
    benchmark at ``root``: a configuration without the DisentangleVAE's
    sections, its reference, a mix naming a new driver, the driver, a
    cell and two metric readers, and their manifest entries."""
    bench = root / "benchmark"
    (bench / "configs" / "stub-config.json").write_text(json.dumps(
        {"name": "stub-config", "reference": "benchmark/reference/stub.py",
         "unet": {"channels": 16, "depth": 3}}))
    (bench / "reference" / "stub.py").write_text(STUB_REFERENCE)
    (bench / "traffic" / "stub-mix.json").write_text(json.dumps(
        {"driver": "stub", "rows": 8}))
    (bench / "traffic" / "stub.py").write_text(STUB_DRIVER)
    why = "a stub family: products on the CPU"
    (bench / "workloads" / "stub-cell.json").write_text(json.dumps(
        {"config": "stub-config", "traffic": "stub-mix", "chips": 1,
         "why": why, "limits": {"gap": 1e-5}}))
    (bench / "metrics" / "stub_rows_per_s.py").write_text(
        "def read(run):\n"
        "    return sum(e.segments for e in run.epochs) / run.window_s\n")
    (bench / "metrics" / "stub_idle_ms.py").write_text(
        "from benchmark import spans\n\n\n"
        "def read(run):\n"
        "    return spans.idle_ms(run.trace, ['pctd.stub.step'], 1)\n")
    b = manifest()
    b["configs"].append({"name": "stub-config", "source": "none",
                         "file": "benchmark/configs/stub-config.json",
                         "reduced": [], "why": why})
    b["workloads"].append({"name": "stub-cell", "config": "stub-config",
                           "traffic": "stub-mix", "chips": 1, "why": why})
    b["end_to_end"].append({"name": "stub_rows_per_s", "unit": "rows/s",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["stub-cell"]})
    b["per_layer"].append({"name": "stub_idle_ms", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "stub", "moves": "stub_rows_per_s",
                           "workloads": ["stub-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def _in_copy(root, args, timeout):
    """``python args`` from the checkout copy at ``root``, which finds the
    copy's ``benchmark`` first and the program where it is."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=timeout, cwd=root, env=env)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out


def test_a_family_of_its_own_runs_from_new_files_only(tmp_path):
    """A configuration with none of the DisentangleVAE's sections, with its
    own reference, driver, cell and readers added as new files, runs
    through ``run_cell`` on the CPU with ``correct`` true, with and
    without a trace; the cell-parametrised tests take it; no file that
    was there changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    _stub_family(tmp_path)
    out = _in_copy(tmp_path, ["-c", STUB_RUN.format(root=str(tmp_path))],
                   300)
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 2
    for result, key in zip(lines, ("stub_rows_per_s", "stub_idle_ms")):
        assert result["correct"] is True, result
        assert result["attempted"] == 1 and result["failed"] == 0
        assert result["metrics"][key]["value"] > 0
        assert list(result["checks"]) == ["gap"]
    assert "setup_s" in lines[0]["metrics"]
    tests = tmp_path / "benchmark" / "tests"
    got = _in_copy(tmp_path, [
        "-m", "pytest", "-q", "-p", "no:cacheprovider", "-k", "stub-cell",
        str(tests / "test_port_bench_isolation.py"),
        str(tests / "test_port_bench_data.py"),
        str(tests / "test_port_bench_faults.py")], 600).stdout
    assert re.search(r"\b3 passed", got), got[-2000:]
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("cell", cells())
def test_cell_files_name_what_exists(cell):
    spec = harness.load_json("workloads", cell)
    assert (ROOT / "benchmark" / "configs" / f"{spec['config']}.json").exists()
    mix = harness.load_json("traffic", spec["traffic"])
    assert (ROOT / "benchmark" / "traffic" / f"{mix['driver']}.py").exists()
    assert spec["chips"] in (1, 4)
    listed = {w["name"]: w for w in manifest()["workloads"]}
    if cell in listed:
        w = listed[cell]
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            spec["config"], spec["traffic"], spec["chips"], spec["why"])
        assert spec["limits"], "a listed cell has its limits"


def test_manifest_keeps_its_format():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
        for k in c["reduced"]:
            assert NAME.match(k)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    cells_listed = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells_listed)) <= cells_listed
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
