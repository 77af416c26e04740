"""Layer: the training frame forward K1 (``train_fwd_group_kernel`` or
``train_fwd_kernel``). The least time of K1's work on the traced steps
(T frames a step, the batch's rows, CE fused in) over K1's device time,
in %."""
from benchmark import work


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    k1_s, n = t.device_time(r"train_fwd(_group)?_kernel")
    steps = sum(e.steps for e in run.epochs if e.traced)
    if not n or not steps:
        return None
    (flops, nbytes), _ = work.k12_work(run.widths, run.batch_size)
    return 100.0 * steps * run.widths.T * work.bound_s(flops, nbytes) / k1_s
