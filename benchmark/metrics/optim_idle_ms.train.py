"""Layer: the optimizer: clip + Adam (``train/optim.py``
``Adam.step``). ms a traced step in which the card sat idle
inside ``pctd.train.optim``."""
from benchmark import spans


def read(run):
    return spans.step_idle_ms(run, ["pctd.train.optim"])
