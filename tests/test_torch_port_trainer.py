"""The port's Trainer on the CPU at tiny width: a step runs and moves every
parameter, the updated tree carries back to the JAX layouts bit-exactly,
gradient accumulation averages its microbatches, an empty epoch reports
zeros and eval draws its noise apart from the train stream."""
import numpy as np
import torch

from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.data.loaders import SegmentBatches, SegmentCorpus, \
    make_loaders
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.train import trainer
from pctd_tpu_torch.utils.weights import export_params, params_from_jax
from tests.test_torch_port_training import _case, _named
from tests.torch_port_helpers import TINY, jax_params, raw_segments


def _loaders(n_train=4, n_val=2):
    tr = SegmentCorpus(*raw_segments(n_train, seed=5))
    va = SegmentCorpus(*raw_segments(n_val, seed=6))
    return make_loaders(tr, va, batch_size=2, seed=0)


def test_trainer_step_changes_params_and_round_trips():
    train_b, val_b = _loaders()
    jp = jax_params(seed=2)
    run = trainer.Trainer(TINY, tcfg.TrainConfig(batch_size=2), train_b,
                          val_b, device="cpu", params=params_from_jax(
                              jp, "cpu"))
    before = [t.detach().clone() for t in run.leaves]
    rows = run.train_steps(1)
    assert len(rows) == 1 and list(rows[0]) == list(tdv.METRIC_NAMES)
    assert all(np.isfinite(v) for v in rows[0].values())
    assert np.isfinite(run.grad_norms[0]) and run.grad_norms[0] > 0
    assert run.step_count == 1 and run.opt.count == 1
    moved = [not torch.equal(a, b.detach()) for a, b in zip(before,
                                                            run.leaves)]
    assert all(moved)
    # the updated tree carries back to the JAX layouts, bit-exactly
    out = export_params(run.params)
    assert sorted(_named(out)) == sorted(_named(jp))
    for name, arr in _named(out).items():
        ref = _named(jp)[name]
        assert arr.shape == ref.shape and arr.dtype == ref.dtype, name
    again = params_from_jax(out, "cpu")
    for a, b in zip(_named(again).values(), _named(run.params).values()):
        assert torch.equal(a, b.detach())
    val = run.eval_epoch()
    assert all(np.isfinite(v) for v in val.values())


def test_accumulation_averages_microbatches():
    """accum_steps=2 gives the mean of the two microbatches' metrics and
    gradients, each drawn with its own noise."""
    params = tdv.init_params(TINY, seed=4, device="cpu")
    x, c, pr_mat = (torch.from_numpy(a) for a in _case(seed=1))
    x, c, pr_mat = x[:2], c[:2], pr_mat[:2]
    for v in trainer.param_list(params):
        v.requires_grad_(True)
    cfg = tcfg.TrainConfig(batch_size=2)
    m2, g2 = trainer.loss_and_grads(params, TINY, cfg, 0,
                                    torch.Generator().manual_seed(0), x, c,
                                    pr_mat, accum=2)
    gen = torch.Generator().manual_seed(0)
    parts = [trainer.loss_and_grads(params, TINY, cfg, 0, gen, x[i:i + 1],
                                    c[i:i + 1], pr_mat[i:i + 1])
             for i in range(2)]
    for name in tdv.METRIC_NAMES:
        np.testing.assert_allclose(
            m2[name].item(), (parts[0][0][name] + parts[1][0][name]).item()
            / 2, rtol=1e-6)
    for a, b, c_ in zip(g2, parts[0][1], parts[1][1]):
        torch.testing.assert_close(a, (b + c_) / 2, rtol=1e-5, atol=1e-7)


def test_empty_train_epoch_reports_zeros():
    """A loader that yields no batch gives 0.0 for every metric, as the JAX
    trainer's train_epoch does, and takes no step."""
    empty = SegmentBatches(SegmentCorpus(*raw_segments(1, seed=5)),
                           batch_size=16)
    assert len(empty) == 0
    run = trainer.Trainer(TINY, tcfg.TrainConfig(batch_size=16), empty,
                          device="cpu", params=params_from_jax(
                              jax_params(seed=2), "cpu"))
    assert run.train_epoch() == {k: 0.0 for k in tdv.METRIC_NAMES}
    assert run.step_count == 0 and run.history == []


def test_eval_noise_is_apart_from_the_train_stream():
    """At step 0 the eval generator draws other latent noise and coins than
    the train step would; and an eval at a later step draws others again."""
    run = trainer.Trainer(TINY, tcfg.TrainConfig(batch_size=2), None,
                          device="cpu", params=tdv.init_params(
                              TINY, seed=4, device="cpu"))
    draw = lambda gen: tdv.draw_noise(gen, TINY, 2, 0.5, 0.5, 0.5)
    train = draw(torch.Generator().set_state(run.gen.get_state()))
    eval0 = draw(run.eval_generator())
    assert torch.equal(draw(run.eval_generator()).eps_chd, eval0.eps_chd)
    for a, b in ((train.eps_chd, eval0.eps_chd),
                 (train.eps_rhy, eval0.eps_rhy)):
        assert not torch.equal(a, b)
    coins = lambda n: torch.cat([n.coins1, n.coins2.flatten(), n.coins3])
    assert not torch.equal(coins(train), coins(eval0))
    run.step_count = 1
    assert not torch.equal(draw(run.eval_generator()).eps_chd, eval0.eps_chd)
