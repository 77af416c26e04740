"""The traced sub-window: ``torch.profiler`` over the CPU and the card,
and what the metric readers take from its trace. The traffic driver
marks each traced request or epoch with
``torch.profiler.record_function`` under :data:`SPAN`; the traced window
is the extent of those marks."""
from __future__ import annotations

import bisect
import collections
import re
from typing import List, Optional, Tuple

import torch

#: the name of the marks around traced requests and epochs
SPAN = "bench.span"
#: kernels of the port's own library (``csrc/*.cu``)
LIBRARY = re.compile(r"\b(frame_group|full_group|train_fwd_group|train_fwd|"
                     r"train_bwd_slots|train_bwd_chain|train_bwd_proj|wgrad|"
                     r"wgrad_reduce|l2_stream|mma_peak)_kernel\b")
TOP = 10


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, template arguments or
    parameters, cut to ``width`` characters."""
    n = re.sub(r"^void ", "", name)
    depth, keep = 0, []
    for ch in n:
        if ch in "<(":
            if depth == 0 and ch == "(" and keep:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            keep.append(ch)
    return ("".join(keep).strip() or n)[:width]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _clipped(spans, a: float, b: float) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in spans)


class TraceView:
    """The device operations, host operations and marks of a trace, times
    in microseconds on the profiler's clock."""

    def __init__(self, device_ops, host_ops, marks):
        self.device_ops = device_ops          # [(name, start, end)]
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self._starts = [e[1] for e in self.host_ops]
        self.marks = sorted(marks)            # [(start, end)]
        self.busy = _union([(a, b) for _, a, b in device_ops])
        if self.marks:
            self.t0, self.t1 = self.marks[0][0], max(b for _, b in self.marks)
        else:
            self.t0 = self.t1 = 0.0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return self.busy_in(self.t0, self.t1) * 1e-6

    def busy_in(self, a: float, b: float) -> float:
        """Microseconds in [a, b] in which some device operation ran."""
        return _clipped(self.busy, a, b)

    def device_time(self, pattern: Optional[str] = None,
                    library: Optional[bool] = None) -> Tuple[float, int]:
        """(seconds, count) of the device operations inside the window
        whose name matches ``pattern``, or, with ``library``, that are (or
        are not) the port's own kernels."""
        total, n = 0.0, 0
        for name, a, b in self.device_ops:
            if b < self.t0 or a > self.t1:
                continue
            if pattern is not None and not re.search(pattern, name):
                continue
            if library is not None and bool(LIBRARY.search(name)) != library:
                continue
            total += b - a
            n += 1
        return total * 1e-6, n

    def kernel_launches(self) -> int:
        """Kernels launched in the window (copies and fills left out)."""
        return sum(1 for name, a, b in self.device_ops
                   if self.t0 <= a <= self.t1
                   and not re.match(r"(Memcpy|Memset)", name))

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at time t."""
        i = bisect.bisect_right(self._starts, t)
        for j in range(i - 1, max(-1, i - 4000), -1):
            name, a, b = self.host_ops[j]
            if b >= t:
                return name
        return "(between host operations)"

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle
        time by the host operation that ran at the start of each gap."""
        by_op = collections.Counter()
        for name, a, b in self.device_ops:
            if self.t0 <= a <= self.t1:
                by_op[short_name(name)] += (b - a) * 1e-6
        gaps = collections.Counter()
        edge = self.t0
        for a, b in _union([(max(a, self.t0), min(b, self.t1))
                            for _, a, b in self.device_ops
                            if b > self.t0 and a < self.t1]) + [
                (self.t1, self.t1)]:
            if a > edge:
                gaps[self._host_at(edge)] += (a - edge) * 1e-6
            edge = max(edge, b)
        return {"device_ops": [[k, v] for k, v in by_op.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}


class Tracer:
    """``torch.profiler`` for the traced sub-window: started and stopped by
    the traffic driver, read once after the window."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._make = lambda: profile(activities=acts)
        self.device = device
        self.prof = None

    def warm(self) -> None:
        """One short trace in set-up, so the window's trace pays no
        profiler start-up."""
        with self._make():
            torch.ones(8, device=self.device).sum().item()

    def start(self) -> None:
        self.prof = self._make()
        self.prof.start()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()

    def span(self):
        return torch.profiler.record_function(SPAN)

    def view(self) -> TraceView:
        from torch.autograd import DeviceType
        dev, host, marks = [], [], []
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.name == SPAN:
                if e.device_type == DeviceType.CPU:
                    marks.append((a, b))
            elif e.device_type == DeviceType.CUDA:
                dev.append((e.name, a, b))
            else:
                host.append((e.name, a, b))
        return TraceView(dev, host, marks)
