"""The readers of K4's launches a traced request (``k4_launches.*``): on a
hand-built trace, the ``full_group_kernel`` launches inside the traced
window over the traced requests; ``None`` for a trace without K4, a run
without a trace and a training run."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tracing import TraceView

K4 = "void full_group_kernel<1>(DecoderWeightsT<float>, int, int, float*)"
NAMES = ("k4_launches.serve_p95", "k4_launches.serve")


def _run(device_ops, kind="serve"):
    trace = TraceView(list(device_ops), [("pctd.sampler.swap", 0.0, 300.0)],
                      [(0.0, 100.0), (200.0, 300.0)])
    return SimpleNamespace(kind=kind, trace=trace)


@pytest.mark.parametrize("name", NAMES)
def test_k4_launches_in_the_window_over_the_traced_requests(name):
    reader = harness.load_module("metrics", name)
    run = _run([(K4, 10.0, 60.0), ("gemmSN_NN_kernel", 62.0, 63.0),
                (K4, 210.0, 240.0), (K4, 245.0, 290.0),
                (K4, 400.0, 450.0)])            # after the window
    assert reader.read(run) == pytest.approx(1.5)
    assert reader.read(_run([(K4, 10.0, 60.0), (K4, 210.0, 260.0)])) == 1.0


@pytest.mark.parametrize("name", NAMES)
def test_no_k4_no_trace_or_a_training_run_reads_none(name):
    reader = harness.load_module("metrics", name)
    assert reader.read(_run([("gemmSN_NN_kernel", 10.0, 20.0)])) is None
    assert reader.read(SimpleNamespace(kind="serve", trace=None)) is None
    assert reader.read(_run([(K4, 10.0, 60.0)], kind="train")) is None
