"""Segments decoded by the requests answered in the window (an
interpolation's points included), over the window's wall time."""


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    return sum(r.segments for r in run.requests if r.ok) / run.window_s
