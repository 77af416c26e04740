"""Layer: the data path: a step's wait for its host batch and the
batch's copy to the card (``Trainer.train_epoch``,
``Trainer._to_device``). ms a traced step in which the card sat idle
inside ``pctd.train.data``."""
from benchmark import spans


def read(run):
    return spans.step_idle_ms(run, ["pctd.train.data"])
