"""The port's spans (``pctd_tpu_torch.utils.trace``) on the CPU at tiny
width: under a profiler, each Sampler workflow gives one span with its
encode and decode inside it, and ``Trainer.train_epoch`` gives its data,
forward, backward and optim spans in a step's order (forward and backward
once a microbatch); no span is a user annotation (which the profiler would
mirror on the device timeline); and without a profiler the spans change no
grid, loss or parameter, bit for bit."""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pctd_tpu_torch.config import TrainConfig, tiny_model_config
from pctd_tpu_torch.data.corpus import SegmentCorpus
from pctd_tpu_torch.data.loaders import SegmentBatches
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.train.trainer import Trainer
from pctd_tpu_torch.utils import trace

CFG = tiny_model_config()


def _requests(B, seed):
    rng = np.random.RandomState(seed)
    pr = np.zeros((B, 32, 128), np.float32)
    on = rng.rand(B, 32, 128) < 0.02
    pr[on] = rng.randint(1, 9, on.sum())
    c = np.zeros((B, 8, 36), np.float32)
    c[:, :, 0] = c[:, :, 24] = 1.0
    c[..., 12:24] = rng.randint(0, 2, (B, 8, 12))
    return pr, c


def _corpus(n, seed):
    rng = np.random.RandomState(seed)
    pr = np.zeros((n, 32, 128), np.uint8)
    pr[rng.rand(n, 32, 128) < 0.03] = 2
    chord = np.zeros((n, 8, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (n, 8))
    chord[..., 1:13] = rng.randint(0, 2, (n, 8, 12))
    chord[..., 13] = rng.randint(0, 12, (n, 8))
    return SegmentCorpus(pr, chord)


def _sampler():
    params = dv.init_params(CFG, seed=3, device="cpu")
    return Sampler(params, CFG, device="cpu")


def _workflow(sampler, kind):
    pr1, c1 = _requests(2, 1)
    pr2, c2 = _requests(2, 2)
    if kind == "swap":
        return sampler.swap(pr1, pr2, c1, c2, fix_rhy=True, fix_chd=False)
    if kind == "posterior_sample":
        return sampler.posterior_sample(torch.Generator().manual_seed(4),
                                        pr1, c1, scale=0.5)
    return sampler.interp(pr1, c1, pr2, c2, interp_chd=True,
                          interp_rhy=True, int_count=2)


def _trainer(accum, steps=2):
    batches = SegmentBatches(_corpus(2 * steps, 5), 2, 0, 0, seed=0)
    return Trainer(CFG, TrainConfig(batch_size=2, accum_steps=accum, seed=6),
                   batches, device="cpu",
                   params=dv.init_params(CFG, seed=7, device="cpu"))


def _spans(fn):
    """fn's result and its ``pctd.`` events (name, start, end), in order of
    their start. The profiler's raw events are read: a train step's plain
    CPU path records ~0.8 M events, which ``prof.events()`` takes about a
    minute to parse."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("pctd.")]
    assert raw and not any(e.is_user_annotation() for e in raw)
    return out, sorted(((e.name(), e.start_ns(), e.end_ns()) for e in raw),
                       key=lambda e: e[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("kind", ["swap", "posterior_sample", "interp"])
def test_workflow_span_holds_its_encode_and_decode(kind):
    sampler = _sampler()
    _, events = _spans(lambda: _workflow(sampler, kind))
    names = [e[0] for e in events]
    outer = [e for e in events if e[0] == f"pctd.sampler.{kind}"]
    assert len(outer) == 1 and events[0] == outer[0]
    encodes = 2 if kind == "interp" else 1
    assert sorted(names[1:]) == sorted(["pctd.sampler.decode"]
                                       + ["pctd.sampler.encode"] * encodes)
    assert names[-1] == "pctd.sampler.decode"
    assert all(_inside(e, outer[0]) for e in events[1:])


@pytest.mark.parametrize("accum", [1, 2])
def test_train_epoch_spans_follow_a_step(accum):
    """Each step: the batch's fetch and its copy to the device (data), its
    features, then a forward and a backward a microbatch, then optim; the
    fetch that finds the loader empty ends the epoch."""
    steps = 3 - accum
    run = _trainer(accum, steps)
    _, events = _spans(run.train_epoch)
    names = [e[0][len("pctd.train."):] for e in events]
    step = (["data", "data", "forward"] + ["forward", "backward"] * accum
            + ["optim"])
    assert names == step * steps + ["data"]
    for a, b in zip(events, events[1:]):
        assert a[2] <= b[1]


def _null_spans(monkeypatch):
    monkeypatch.setattr(trace, "span", lambda name: contextlib.nullcontext())


def test_spans_change_no_grid(monkeypatch):
    sampler = _sampler()
    kinds = ("swap", "posterior_sample", "interp")
    got = [_workflow(sampler, k) for k in kinds]
    _null_spans(monkeypatch)
    for kind, grid in zip(kinds, got):
        np.testing.assert_array_equal(grid, _workflow(sampler, kind))


def test_spans_change_no_loss_or_parameter(monkeypatch):
    def epoch():
        run = _trainer(1)
        losses = run.train_epoch()
        return losses, [t.detach().clone() for t in run.leaves]

    losses, leaves = epoch()
    _null_spans(monkeypatch)
    losses0, leaves0 = epoch()
    assert losses == losses0
    assert all(torch.equal(a, b) for a, b in zip(leaves, leaves0))
