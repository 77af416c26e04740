"""Layer: the request (``Sampler``). A traced request's service time less
the time the card was busy inside it, as a mean over the traced
requests, in ms."""


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or not t.marks:
        return None
    return sum((b - a) - t.busy_in(a, b) for a, b in t.marks) \
        / len(t.marks) * 1e-3
