"""The port's Trainer on the CPU at tiny width: a step runs and moves every
parameter, the updated tree carries back to the JAX layouts bit-exactly,
gradient accumulation averages its microbatches, an empty epoch reports
zeros, eval draws its noise apart from the train stream, two bf16 steps
match two JAX bf16 steps, a CPU Trainer steps eagerly, and the step
graph's bookkeeping (with a CPU stand-in for the CUDA graph) gives the
eager steps' bits, an eval between steps included."""
import numpy as np
import torch

from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.data.loaders import SegmentBatches, SegmentCorpus, \
    make_loaders
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.train import schedules
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
    sched = schedules.train_params_at(0, cfg)
    m2, g2 = trainer.loss_and_grads(params, TINY, cfg, sched,
                                    torch.Generator().manual_seed(0), x, c,
                                    pr_mat, accum=2)
    gen = torch.Generator().manual_seed(0)
    parts = [trainer.loss_and_grads(params, TINY, cfg, sched, gen,
                                    x[i:i + 1], c[i:i + 1], pr_mat[i:i + 1])
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
    the train step would; and an eval at a later step draws the same ones
    again (the JAX trainer's eval key never changes)."""
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
    assert torch.equal(draw(run.eval_generator()).eps_chd, eval0.eps_chd)


def test_eval_metrics_do_not_depend_on_the_step():
    """Two evals of the same params at different step counts give equal
    metrics: the eval noise is drawn from the same seed each time (the
    schedules held at their end values, so only the noise could differ)."""
    _, val_b = _loaders()
    run = trainer.Trainer(
        TINY, tcfg.TrainConfig(batch_size=2, eval_fixed_schedule=True),
        None, val_b, device="cpu",
        params=tdv.init_params(TINY, seed=4, device="cpu"))
    first = run.eval_epoch()
    run.step_count = 7
    assert run.eval_epoch() == first
    assert all(np.isfinite(v) for v in first.values())


#: bf16 step metrics vs JAX: step 1 at the bf16 loss parity's 1.4e-4; step
#: 2 at 4.4e-3, the JAX package's own distance between its two bf16 paths
#: (Pallas interpret vs XLA) after these two steps. Adam's first update is
#: lr * g / |g|, so a near-zero gradient entry whose bf16 sign differs
#: between two implementations moves its weight by 2 lr.
STEP_RTOL = (1.4e-4, 4.4e-3)


def test_two_bf16_train_steps_match_jax(monkeypatch):
    """Two Trainer steps with compute_dtype="bfloat16" against two JAX bf16
    train steps (its Pallas frame kernels in interpret mode), from the same
    weights and with the JAX step keys' noise: the master params, their
    gradients and the Adam moments stay f32, and each step's 11 metrics
    match the JAX step's within :data:`STEP_RTOL` (measured 7.7e-5 and
    2.2e-3). Building the bf16 Trainer turns PyTorch's bf16 reduced-precision
    cuBLAS reductions off."""
    import dataclasses

    import jax

    from tests.test_torch_port_multistep import TRAIN, _batches, _jax_steps
    from tests.torch_port_helpers import JAX_TINY, jax_noise

    jp = jax_params(seed=6)
    batches = _batches()[:2]
    base_key = jax.random.PRNGKey(11)
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    jrows, _ = _jax_steps(
        jp, dataclasses.replace(JAX_TINY, compute_dtype="bfloat16",
                                train_frame_kernel=True), batches, base_key)
    run = trainer.Trainer(dataclasses.replace(TINY, compute_dtype="bfloat16"),
                          tcfg.TrainConfig(**TRAIN), None, device="cpu",
                          params=params_from_jax(jp, "cpu"))
    assert not matmul.allow_bf16_reduced_precision_reduction

    def jax_step_noise(gen, cfg, batch, tfr1, tfr2, tfr3):
        # the Trainer's scheduled rates are 0-d tensors of the step's
        # scalars
        key = jax.random.fold_in(base_key, run.step_count)
        return tdv.Noise(*(torch.from_numpy(a) for a in jax_noise(
            key, JAX_TINY, batch, *(float(t) for t in (tfr1, tfr2,
                                                      tfr3)))))

    monkeypatch.setattr(trainer.dv, "draw_noise", jax_step_noise)
    for step, (batch, want, rtol) in enumerate(zip(batches, jrows,
                                                   STEP_RTOL)):
        got = run.train_step(batch)
        assert all(np.isfinite(v) for v in got.values())
        for name in tdv.METRIC_NAMES:
            np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                       err_msg=f"step {step + 1} {name}")
    assert all(t.dtype == torch.float32 for t in run.leaves)
    assert all(t.dtype == torch.float32 for t in run.opt.mu + run.opt.nu)
    assert np.isfinite(run.grad_norms).all()


def _host_batches(B, n, seed=30):
    return [dict(pr=pr, chord=chord, shift=(np.arange(B) % 12 - 6).astype(
        np.int32)) for pr, chord in (raw_segments(B, seed=seed + i)
                                      for i in range(n))]


def _cpu_trainer():
    return trainer.Trainer(TINY, tcfg.TrainConfig(batch_size=2), None,
                           device="cpu",
                           params=tdv.init_params(TINY, seed=4, device="cpu"))


def test_cpu_trainer_steps_eagerly():
    """A CPU Trainer runs every step eagerly: no step graph is made,
    captured or replayed, and both counters stay 0."""
    run = _cpu_trainer()
    for batch in _host_batches(2, 2):
        run._step(batch)
    assert (run.step_captures, run.step_replays) == (0, 0)
    assert run._graphs == {}
    assert run.step_count == run.opt.count == 2


class _EagerStepGraph:
    """``StepGraph`` as the CPU can run it: ``warm`` runs the step,
    ``capture`` keeps its inputs and runs nothing, ``replay`` overwrites
    static outputs (NaN until the first replay) with the step over what
    the inputs hold now, and leaves Adam's ``count`` as it found it, as a
    replay, which runs no Python, does."""

    def __init__(self, gen, device):
        self.inputs = self.outputs = None

    def warm(self, run, inputs):
        return run(*inputs)

    def capture(self, run, inputs):
        self._run = run
        self.inputs = inputs
        self.outputs = (torch.full((len(tdv.METRIC_NAMES),), float("nan")),
                        torch.full((), float("nan")))

    def replay(self):
        opt = self._run.__self__.opt
        count = opt.count
        for static, new in zip(self.outputs, self._run(*self.inputs)):
            static.copy_(new)
        opt.count = count

    def release(self):
        self.inputs = self.outputs = None


def test_step_graph_bookkeeping_gives_the_eager_steps(monkeypatch):
    """The graph path's bookkeeping (``_replays`` and ``StepGraph`` swapped
    for a CPU stand-in): three steps of one shape and two of another warm
    each shape's graph once, capture it once and replay from then on,
    copying each batch and the step's scalars into the graph's inputs;
    metrics, norms, params, Adam's state and the generator's state are the
    bits of five eager steps, and a step's outputs outlive the next
    replay."""
    batches = _host_batches(2, 3) + _host_batches(4, 2, seed=40)
    eager = _cpu_trainer()
    want = [eager._step(b) for b in batches]
    monkeypatch.setattr(trainer, "_replays", lambda device: True)
    monkeypatch.setattr(trainer, "StepGraph", _EagerStepGraph)
    run = _cpu_trainer()
    got = [run._step(b) for b in batches]
    assert (run.step_captures, run.step_replays) == (2, 3)
    assert len(run._graphs) == 2
    for (m, norm), (m_e, norm_e) in zip(got, want):
        assert torch.equal(m, m_e) and torch.equal(norm, norm_e)
    for a, b in zip(run.leaves + run.opt.mu + run.opt.nu,
                    eager.leaves + eager.opt.mu + eager.opt.nu):
        assert torch.equal(a, b)
    assert torch.equal(run.gen.get_state(), eager.gen.get_state())
    assert run.step_count == run.opt.count == 5


def test_eval_lets_the_step_graphs_go(monkeypatch):
    """On the graph path (the CPU stand-in) an eval lets the captured step
    graph go, and the next train step captures it again, with no second
    warm-up: two steps, an eval, two steps give two captures and three
    replays, and the bits of the same sequence of eager steps."""
    batches = _host_batches(2, 4)

    def steps(t):
        out = [t._step(b) for b in batches[:2]]
        t.eval_epoch()
        return out + [t._step(b) for b in batches[2:]]

    eager = _cpu_trainer()
    want = steps(eager)
    monkeypatch.setattr(trainer, "_replays", lambda device: True)
    monkeypatch.setattr(trainer, "StepGraph", _EagerStepGraph)
    run = _cpu_trainer()
    got = steps(run)
    assert (run.step_captures, run.step_replays) == (2, 3)
    assert len(run._graphs) == 1
    for (m, norm), (m_e, norm_e) in zip(got, want):
        assert torch.equal(m, m_e) and torch.equal(norm, norm_e)
    for a, b in zip(run.leaves + run.opt.mu + run.opt.nu,
                    eager.leaves + eager.opt.mu + eager.opt.nu):
        assert torch.equal(a, b)
    assert torch.equal(run.gen.get_state(), eager.gen.get_state())
