"""The readers of the program's spans (``benchmark/spans.py``): on a
hand-built trace, known spans and device operations give known idle ms;
ranges of one name that overlap count once; a span is clipped to the
traced window; a trace without the spans (the program before them) reads
``None``; the train step's idle reads the step graph's replay and the
eager step alike. Every per-layer metric has its reader and lists only
cells that report the end-to-end metric it moves. A traced run of the
harness on the CPU reads every span metric of its cell. The train cells'
memory peak takes set-up's and the window's."""
import io
import json
import time
from types import SimpleNamespace

import pytest

from conftest import cells, manifest, tiny_overrides
from benchmark import harness, spans
from benchmark.tracing import TraceView

SPAN_METRICS = sorted(m["name"] for m in manifest()["per_layer"]
                      if m["name"].split(".")[0].endswith("_idle_ms"))


def _trace(host_ops, device_ops=(), marks=((0.0, 1000.0),)):
    return TraceView(list(device_ops), list(host_ops), list(marks))


def _train_run(trace, steps=2):
    return SimpleNamespace(kind="train", trace=trace, epochs=[
        harness.Epoch(0.0, 1.0, steps, 8 * steps, True),
        harness.Epoch(1.0, 2.0, 16, 128, False)])


#: a traced step's host spans over 100-300 and 500-600 us, on the card's
#: graph path, on the eager path (the CPU, a mesh), both at once (a
#: shape's eager step beside a replay), and on neither
STEP_PATHS = {
    "graph": [("pctd.train.step", 100.0, 300.0),
              ("pctd.train.step", 500.0, 600.0)],
    "eager": [("pctd.train.forward", 100.0, 180.0),
              ("pctd.train.backward", 180.0, 300.0),
              ("pctd.train.optim", 500.0, 600.0)],
    "both": [("pctd.train.step", 100.0, 300.0),
             ("pctd.train.forward", 150.0, 250.0),
             ("pctd.train.optim", 500.0, 600.0)],
    "neither": [("pctd.train.data", 100.0, 300.0)],
}


@pytest.mark.parametrize("path", sorted(STEP_PATHS))
def test_idle_inside_spans_is_their_length_less_the_busy_time(path):
    t = _trace(host_ops=STEP_PATHS[path] + [("aten::mul", 150.0, 160.0)],
               device_ops=[("k", 120.0, 180.0), ("k", 250.0, 550.0)])
    reader = harness.load_module("metrics", "step_idle_ms.train")
    run = _train_run(t)
    if path == "neither":
        assert reader.read(run) is None
        return
    # idle: 100-120, 180-250 in the first; 550-600 in the second: 140 us
    names = {n for n, _, _ in STEP_PATHS[path]}
    assert spans.idle_ms(t, names, 2) == pytest.approx(0.07)
    assert spans.step_idle_ms(run, names) == pytest.approx(0.07)
    assert reader.read(run) == pytest.approx(0.07)


def test_overlapping_ranges_of_one_name_count_once():
    nested = _trace(host_ops=[("pctd.train.data", 0.0, 400.0),
                              ("pctd.train.data", 100.0, 200.0),
                              ("pctd.train.data", 300.0, 500.0)],
                    device_ops=[("k", 450.0, 460.0)])
    assert spans.idle_ms(nested, ["pctd.train.data"], 1) == pytest.approx(
        0.49)


def test_spans_are_clipped_to_the_window():
    t = _trace(host_ops=[("pctd.sampler.swap", -500.0, 200.0),
                         ("pctd.sampler.interp", 900.0, 1500.0)],
               marks=[(0.0, 1000.0)])
    assert spans.idle_ms(t, spans.WORKFLOWS, 1) == pytest.approx(0.3)


def test_requests_divide_by_the_traced_requests():
    t = _trace(host_ops=[("pctd.sampler.decode", 10.0, 30.0),
                         ("pctd.sampler.decode", 110.0, 130.0)],
               device_ops=[("full_group_kernel", 15.0, 25.0)],
               marks=[(0.0, 50.0), (100.0, 150.0)])
    run = SimpleNamespace(kind="serve", trace=t)
    for cell in ("serve", "serve_p95"):
        reader = harness.load_module("metrics", f"decode_idle_ms.{cell}")
        assert reader.read(run) == pytest.approx(0.015)
    assert harness.load_module("metrics", "encode_idle_ms.serve").read(
        run) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_without_spans_reads_none(name):
    """The program before its spans: every span metric reads None, and so
    does a run of the other kind or without a trace."""
    bare = _trace(host_ops=[("aten::mm", 0.0, 900.0)],
                  device_ops=[("k", 0.0, 100.0)])
    reader = harness.load_module("metrics", name)
    kind = "train" if name.endswith(".train") else "serve"
    assert reader.read(SimpleNamespace(kind=kind, trace=bare,
                                       epochs=[])) is None
    assert reader.read(SimpleNamespace(kind=kind, trace=None,
                                       epochs=[])) is None
    other = "serve" if kind == "train" else "train"
    full = _trace(host_ops=[(n, 0.0, 900.0) for n in (
        *spans.WORKFLOWS, "pctd.sampler.encode", "pctd.sampler.decode",
        "pctd.train.data", "pctd.train.step", "pctd.train.forward",
        "pctd.train.backward", "pctd.train.optim")])
    assert reader.read(SimpleNamespace(kind=other, trace=full,
                                       epochs=[])) is None


def test_every_metric_lists_cells_that_report_what_it_moves():
    b = manifest()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    every = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        moves = e2e[m["moves"]]
        assert set(m.get("workloads", every)) <= set(
            moves.get("workloads", every)), m["name"]
    assert len(SPAN_METRICS) == 8


@pytest.mark.parametrize("cell", [c for c in cells() if c in (
    "conv-serve-songs", "conv-train-b512")])
def test_a_traced_run_reads_every_span_metric(cell):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, 2 ** 33 + 7, 0.2, True, time.perf_counter(),
                          device="cpu", overrides=tiny_overrides(cell),
                          out=out, err=err)
    assert rc == 0, err.getvalue()
    got = json.loads(out.getvalue().strip().splitlines()[-1])["metrics"]
    mine = [m for m in harness.manifest_metrics(cell, True)
            if m["name"] in SPAN_METRICS]
    assert len(mine) == (3 if "serve" in cell else 2)
    for m in mine:
        assert got[m["name"]]["value"] > 0, m["name"]


@pytest.mark.parametrize("setup,window,gib", [
    (3 * 2 ** 30, 2 ** 29, 3.0),        # the step graph's capture, in set-up
    (2 ** 29, 3 * 2 ** 30, 3.0),        # eager steps: the window's
    (None, 2 ** 30, 1.0),
    (None, None, None)])                # the CPU: no peak read
def test_peak_memory_takes_the_larger_of_setup_and_window(setup, window,
                                                          gib):
    reader = harness.load_module("metrics", "peak_mem_gib.train")
    run = SimpleNamespace(kind="train", setup_peak_bytes=setup,
                          window_peak_bytes=window)
    assert reader.read(run) == gib
    run.kind = "serve"
    assert reader.read(run) is None
