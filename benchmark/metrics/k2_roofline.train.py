"""Layer: the training frame backward, K2a (``train_bwd_*_kernel``) and
K2b (``wgrad_kernel``, ``wgrad_reduce_kernel``) together, as the one
Pallas backward they replace. The least time of the reverse chain and
the weight gradients on the traced steps over their device time, in %."""
from benchmark import work


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    k2_s, n = t.device_time(r"(train_bwd_\w+|wgrad(_reduce)?)_kernel")
    steps = sum(e.steps for e in run.epochs if e.traced)
    if not n or not steps:
        return None
    _, (f2a, b2a) = work.k12_work(run.widths, run.batch_size)
    f2b, b2b = work.k2b_work(run.widths, run.batch_size)
    bound = work.bound_s(f2a + f2b, b2a + b2b)
    return 100.0 * steps * run.widths.T * bound / k2_s
