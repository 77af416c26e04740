"""Layer: the decode's host side and the grid's copy back
(``Sampler.decode``). ms a traced request in which the card sat idle
inside ``pctd.sampler.decode``."""
from benchmark import spans


def read(run):
    return spans.request_idle_ms(run, ["pctd.sampler.decode"])
