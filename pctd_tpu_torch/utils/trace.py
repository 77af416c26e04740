"""Spans at the layer boundaries of the serving and training paths, recorded
by ``torch.profiler`` on the clock of the device operations it records.

A span exists only while a ``torch.profiler`` records (``cli.train
--profile``, or any profiler the caller starts): there is no switch, no
buffer and no exporter here, the profiler is all of these. With no
profiler running a span costs about half a microsecond. A span is a CPU
range that is not a user annotation, so the profiler gives it no mirror on
the device timeline: it adds no device event and launches nothing.

The spans, one range a call (none inside a per-frame or per-chunk loop):

- ``pctd.sampler.swap``, ``.posterior_sample``, ``.prior_sample``,
  ``.interp``, ``.reconstruct``: a workflow call of
  :class:`~pctd_tpu_torch.models.sampler.Sampler`, its grid as numpy
  included;
- ``pctd.sampler.encode``: the request's copy to the device, its padding
  and chunks, the encoders;
- ``pctd.sampler.decode``: the latents' padding, the decode (K4's or K3's
  inputs, plan and launches), the grid's copy back;
- ``pctd.train.data``: a step's wait for its host batch, and the batch's
  copy to the device (two ranges a step);
- ``pctd.train.forward``: the batch's features, and each microbatch's noise
  and loss;
- ``pctd.train.backward``: each microbatch's ``torch.autograd.grad``;
- ``pctd.train.optim``: clip + Adam;
- ``pctd.train.step``: on the card, the replay of a captured train step
  (``train.trainer.StepGraph``) and the copies of its two outputs. The
  three spans above are then recorded only by the steps that run eagerly
  or are captured: a shape's first two.
"""
from torch._C._profiler import _RecordFunctionFast


def span(name: str) -> _RecordFunctionFast:
    """A context manager that records the range ``pctd.<name>`` while a
    profiler records."""
    return _RecordFunctionFast("pctd." + name)
