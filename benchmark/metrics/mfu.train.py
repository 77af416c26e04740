"""The whole step. Model FLOPs of the segments of the steps outside the
traced sub-window (3x the forward: the backward twice it, nothing
recomputed), over those steps' wall time, as a share of the card's f32
peak (3xTF32, 165 TFLOP/s), in %."""
from benchmark import work


def read(run):
    rest = [e for e in run.epochs if not e.traced]
    if run.kind != "train" or not rest:
        return None
    seconds = rest[-1].t1 - rest[0].t0
    flops = sum(e.segments for e in rest) * work.train_segment_flops(
        run.widths)
    return 100.0 * flops / seconds / work.PEAK_F32_FLOPS
