"""Readings that several metric readers share: a serving metric is split
by the end-to-end metric it moves (``.serve`` where the cell reports
``serve_segments_per_s``, ``.serve_p95`` where it reports
``serve_p95_ms``), and both halves read the same quantity."""
from __future__ import annotations

from benchmark import work


def k4_roofline(run):
    """The least time of the work the traced requests need, their real
    rows only (each launch its weights once and each real row's inputs and
    grid once), over K4's device time, in %. A launch decodes
    ``fixed_batch`` rows of a request at a time, or all of them where the
    mix has none."""
    t = run.trace
    if run.kind != "serve" or t is None:
        return None
    k4_s, launches = t.device_time(r"full_group_kernel")
    if not launches:
        return None
    fb = run.mix.get("fixed_batch")
    bound = 0.0
    for r in run.requests:
        left = r.segments if r.traced else 0
        while left > 0:
            rows = min(left, fb) if fb else left
            bound += work.bound_s(*work.k4_work(run.widths, rows))
            left -= rows
    return 100.0 * bound / k4_s


def serve_idle_share(run):
    """The share of the traced requests' service time in which no
    operation ran on the card, in %."""
    t = run.trace
    if run.kind != "serve" or t is None or not t.marks:
        return None
    span = sum(b - a for a, b in t.marks)
    return 100.0 * (1.0 - sum(t.busy_in(a, b) for a, b in t.marks) / span)


def serve_mfu(run):
    """Model FLOPs of the segments of the requests answered outside the
    traced sub-window (encoders, latent inputs and the decode as K4's
    function counts them), over those requests' service time, as a share
    of the card's f32 peak (3xTF32, 165 TFLOP/s), in %."""
    rest = [r for r in run.requests if r.ok and not r.traced]
    if run.kind != "serve" or not rest:
        return None
    seconds = sum(r.t1 - r.t0 for r in rest)
    flops = sum(r.segments for r in rest) * work.serve_segment_flops(
        run.widths)
    return 100.0 * flops / seconds / work.PEAK_F32_FLOPS
