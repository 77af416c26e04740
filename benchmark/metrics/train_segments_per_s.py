"""Segments of every step in the window, over the wall time up to the
window's last host read of metrics (an epoch's end)."""


def read(run):
    if run.kind != "train" or not run.epochs:
        return None
    return sum(e.segments for e in run.epochs) / run.window_s
