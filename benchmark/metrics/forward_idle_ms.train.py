"""Layer: the forward: the batch's features and each microbatch's
noise and loss (``Trainer._step``, ``trainer.loss_and_grads``). ms a
traced step in which the card sat idle inside ``pctd.train.forward``."""
from benchmark import spans


def read(run):
    return spans.step_idle_ms(run, ["pctd.train.forward"])
