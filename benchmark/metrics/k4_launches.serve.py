"""Layer: the request (``Sampler``): K4 (``full_group_kernel``) launches
a traced request, from the device trace (moves ``serve_segments_per_s``).
An unchunked ``Sampler()`` launches K4 once a request."""


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or not t.marks:
        return None
    n = t.device_time(r"full_group_kernel")[1]
    return n / len(t.marks) if n else None
