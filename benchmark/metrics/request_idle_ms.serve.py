"""Layer: the request (``Sampler``). ms a traced request in which
the card sat idle inside the Sampler's workflow spans
(``pctd.sampler.<workflow>``): the in-program counterpart of
``serve_host_ms``."""
from benchmark import spans


def read(run):
    return spans.request_idle_ms(run, spans.WORKFLOWS)
