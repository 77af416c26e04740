"""Layer: the torch ops of the step (encoders, time GRU, chord decoder,
losses, clip + Adam, copies): device ms a traced step of every device
operation that is not one of the port's own kernels."""


def read(run):
    t = run.trace
    steps = sum(e.steps for e in run.epochs if e.traced)
    if run.kind != "train" or t is None or not steps:
        return None
    s, n = t.device_time(library=False)
    return s * 1e3 / steps if n else None
