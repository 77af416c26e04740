"""What a cell's run loads, in a fresh process: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``pctd_tpu`` (the JAX package;
the port, ``pctd_tpu_torch``, is another top-level name); the reference
loads nothing of the program either."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, cells

FORBIDDEN = {"jax", "jaxlib", "flax", "pctd_tpu"}

CELL_GRAPH = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness, tracing
cell = harness.load_cell({cell!r})
harness.load_module("traffic", cell.mix["driver"])
for m in harness.manifest_metrics({cell!r}, False) + \\
        harness.manifest_metrics({cell!r}, True):
    harness.load_module("metrics", m["name"])
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE_GRAPH = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.model, benchmark.reference.data
import benchmark.reference.train, benchmark.reference.serve
import benchmark.work
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", cells())
def test_cell_loads_no_jax(cell):
    names = _top_level(CELL_GRAPH.format(root=str(ROOT), cell=cell))
    assert "pctd_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE_GRAPH.format(root=str(ROOT)))
    assert not names & (FORBIDDEN | {"pctd_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark import harness
    assert harness.FORBIDDEN == FORBIDDEN
    for near in ("pctd_tpu_torch_x", "jaxlib_x", "flaxen"):
        monkeypatch.setitem(sys.modules, near, sys)
    monkeypatch.setitem(sys.modules, "pctd_tpu.models", sys)
    found = harness.loaded_forbidden()
    assert "pctd_tpu" in found
    assert not {"pctd_tpu_torch_x", "jaxlib_x", "flaxen"} & set(found)
