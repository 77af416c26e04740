"""The 95th percentile of the latency of every request answered in the
window, from its arrival (when it was due) to its grid in hand, so the
wait behind earlier requests counts; a failed request counts as never
answered. Linear between order statistics."""
import math


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    lat = sorted((r.t1 - r.arrival) * 1e3 if r.ok else math.inf
                 for r in run.requests)
    pos = 0.95 * (len(lat) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(lat[hi]):
        return math.inf
    return lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)
