"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric added as new files are found by name with no edit
to a file that is there; every cell names a configuration and a mix that
exist, every mix a driver that exists, every metric a reader; the
manifest agrees with the cell files and keeps the allowed characters."""
import json
import re
import shutil

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
