"""The program's own spans (``pctd.*``, ``pctd_tpu_torch/utils/trace.py``)
in a traced run: the profiler records them as host operations, on the
clock of the device operations. A metric reads the card-idle time inside
the spans of given names, their union clipped to the traced window, per
traced request or step. A program without such spans reads ``None``."""
from __future__ import annotations

from typing import Iterable, Optional

from benchmark.tracing import _union

#: the spans of the Sampler's workflow calls: a request each
WORKFLOWS = ("pctd.sampler.swap", "pctd.sampler.posterior_sample",
             "pctd.sampler.prior_sample", "pctd.sampler.interp",
             "pctd.sampler.reconstruct")


def idle_ms(trace, names: Iterable[str], per: int) -> Optional[float]:
    """ms in which the card was idle inside the host spans named ``names``
    within ``trace``'s window, over ``per``; None without such a span."""
    names = set(names)
    spans = [(max(a, trace.t0), min(b, trace.t1))
             for name, a, b in trace.host_ops
             if name in names and b > trace.t0 and a < trace.t1]
    if not spans or not per:
        return None
    idle = sum((b - a) - trace.busy_in(a, b) for a, b in _union(spans))
    return idle / per * 1e-3


def request_idle_ms(run, names: Iterable[str]) -> Optional[float]:
    """:func:`idle_ms` per traced request of a serving run."""
    t = run.trace
    if run.kind != "serve" or t is None:
        return None
    return idle_ms(t, names, len(t.marks))


def step_idle_ms(run, names: Iterable[str]) -> Optional[float]:
    """:func:`idle_ms` per traced step of a training run."""
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    return idle_ms(t, names, sum(e.steps for e in run.epochs if e.traced))
