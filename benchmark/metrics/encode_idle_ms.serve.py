"""Layer: the request's copy to the card and the encoders
(``Sampler.encode``). ms a traced request in which the card sat idle
inside ``pctd.sampler.encode``."""
from benchmark import spans


def read(run):
    return spans.request_idle_ms(run, ["pctd.sampler.encode"])
