"""Layer: the train step (``Trainer``). ms a traced step in which the card
sat idle inside the step: ``pctd.train.step``, the step graph's replay
where the card replays one (``Trainer._graph_step``), or
``pctd.train.forward``, ``.backward`` and ``.optim``, which run where the
step is eager (the CPU, a mesh, a batch shape's first two steps)."""
from benchmark import spans

STEP = ("pctd.train.step", "pctd.train.forward", "pctd.train.backward",
        "pctd.train.optim")


def read(run):
    return spans.step_idle_ms(run, STEP)
