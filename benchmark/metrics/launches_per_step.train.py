"""Layer: the train step (``Trainer``). Kernels launched a traced step."""


def read(run):
    t = run.trace
    steps = sum(e.steps for e in run.epochs if e.traced)
    if run.kind != "train" or t is None or not steps:
        return None
    n = t.kernel_launches()
    return n / steps if n else None
