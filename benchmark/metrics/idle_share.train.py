"""Layer: the device. The share of the traced steps' window in which no
operation ran on the card, in %."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
