"""Layer: the backward: each microbatch's ``torch.autograd.grad``
(``trainer.loss_and_grads``). ms a traced step in which the card sat idle
inside ``pctd.train.backward``."""
from benchmark import spans


def read(run):
    return spans.step_idle_ms(run, ["pctd.train.backward"])
