"""The port's training run on the CPU at tiny width: ``Trainer.run``'s
checkpoints, the epoch loop's on-device means and its host reads, the
metric writers against the JAX package's, a resumed run against an
uninterrupted one, and the automatic accumulation against the JAX
package's arithmetic."""
import os

import numpy as np
import pytest
import torch

from pctd_tpu import config as jcfg
from pctd_tpu.train import logging as jlogging
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.data.loaders import SegmentCorpus, make_loaders
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.train import logging as tlogging
from pctd_tpu_torch.train import trainer
from pctd_tpu_torch.utils import device_mem
from tests.torch_port_helpers import TINY, raw_segments

B = 8


def _loaders(n_train=1, n_val=2, seed=0):
    """n_train segments x 12 shifts: 12 // B = 1 step an epoch each."""
    tr = SegmentCorpus(*raw_segments(n_train, seed=5))
    va = SegmentCorpus(*raw_segments(n_val, seed=6))
    return make_loaders(tr, va, batch_size=B, seed=seed)


def _trainer(tmp_path=None, n_train=1, **kw):
    train_b, val_b = _loaders(n_train)
    paths = (None if tmp_path is None else
             tlogging.RunPaths(root="run", with_date=False,
                               base_dir=str(tmp_path)))
    return trainer.Trainer(TINY, tcfg.TrainConfig(batch_size=B), train_b,
                           val_b, device="cpu", run_paths=paths,
                           params=tdv.init_params(TINY, seed=3,
                                                  device="cpu"), **kw)


def test_run_saves_epoch_valid_and_final(tmp_path, monkeypatch, capsys):
    """``run`` saves ``epoch`` after every epoch, ``valid`` only when the
    val loss improves, ``final`` at the end, and prints the epoch lines."""
    run = _trainer(tmp_path)
    val_losses = iter([3.0, 4.0, 2.0])
    monkeypatch.setattr(run, "eval_epoch", lambda: {
        k: next(val_losses) if k == "loss" else 0.0
        for k in tdv.METRIC_NAMES})
    saved = []
    save = run.save_checkpoint
    monkeypatch.setattr(run, "save_checkpoint",
                        lambda tag: (saved.append(tag), save(tag)))
    result = run.run(3)
    assert saved == ["epoch", "valid", "epoch", "epoch", "valid", "final"]
    for tag in ("epoch", "valid", "final"):
        assert os.path.isfile(run.run_paths.model_path("disvae", tag))
    assert result["val"]["loss"] == 2.0 and result["train_steps"] == 1
    assert set(result) == {"train", "val", "epoch_seconds", "train_seconds",
                           "train_steps"}
    out = capsys.readouterr().out
    for e in (1, 2, 3):
        assert f"Epoch: {e:02} | Time:" in out
    assert "\t Valid. Loss: 4.000" in out


class _HostReads:
    """Counts the tensor methods that read a value to the host."""

    NAMES = ("item", "tolist", "numpy", "__float__", "__int__", "__bool__")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, _name=name, **kw):
                self.calls.append(_name)
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)


def test_epoch_loop_reads_the_host_every_log_every_steps(tmp_path,
                                                         monkeypatch):
    """3 steps with writes every 2: two ``tolist`` for the written steps
    and one at the epoch's end, and no other host read; the written rows
    are those steps'."""
    writers = tlogging.MetricWriters(tdv.METRIC_NAMES, str(tmp_path),
                                     use_tensorboard=False)
    run = _trainer(n_train=2, writers=writers, log_every=2)
    assert len(run.train_batches) == 3
    reads = _HostReads(monkeypatch)
    means = run.train_epoch()
    assert reads.calls == ["tolist"] * 3
    monkeypatch.undo()
    writers.close()
    with open(tmp_path / "metrics.csv") as f:
        rows = [ln.split(",")[:2] for ln in f.read().splitlines()[1:]]
    assert rows == [["train", "0"], ["train", "2"]]
    assert run.step_count == 3 and run.history == []
    assert all(np.isfinite(v) for v in means.values())


def test_epoch_means_are_the_mean_of_the_steps():
    """The epoch loop's on-device means equal the mean of the same steps'
    host metrics (train_step on a twin trainer) within 1e-6; the eval
    epoch's, the mean of its batches' eval metrics."""
    loop, steps = _trainer(n_train=2), _trainer(n_train=2)
    means = loop.train_epoch()
    for batch in steps.train_batches.epoch():
        steps.train_step(batch)
    assert len(steps.history) == 3
    for k in tdv.METRIC_NAMES:
        want = np.mean([h[k] for h in steps.history])
        np.testing.assert_allclose(means[k], want, rtol=1e-6, err_msg=k)
    gen = steps.eval_generator()
    rows = [trainer.eval_metrics(steps.params, TINY, steps.tcfg,
                                 steps.step_count, gen,
                                 *steps._to_device(b))
            for b in steps.val_batches.epoch()]
    val = loop.eval_epoch()
    for k in tdv.METRIC_NAMES:
        want = np.mean([r[k].item() for r in rows])
        np.testing.assert_allclose(val[k], want, rtol=1e-6, err_msg=k)


def test_metrics_csv_equals_the_jax_writers(tmp_path):
    """The same values through the port's and the JAX package's writers
    (TensorBoard off) give the same metrics.csv, byte for byte."""
    rng = np.random.RandomState(0)
    files = []
    for mod in (tlogging, jlogging):
        d = tmp_path / mod.__name__.split(".")[0]
        w = mod.MetricWriters(tdv.METRIC_NAMES, str(d), use_tensorboard=False)
        rng.seed(0)
        for step in range(5):
            vals = dict(zip(tdv.METRIC_NAMES,
                            map(float, rng.randn(11).astype(np.float32))))
            w.write_task("train" if step % 2 else "val", vals, step)
        w.write_task("val", {"loss": 1.5}, 9)
        w.close()
        files.append((d / "metrics.csv").read_bytes())
    assert files[0] == files[1]
    paths = tlogging.RunPaths(root="r", base_dir=str(tmp_path))
    want = jlogging.RunPaths(root="r", base_dir=str(tmp_path / "j"))
    assert os.path.relpath(paths.model_path("n", "final"), str(tmp_path)) \
        == os.path.relpath(want.model_path("n", "final"),
                           str(tmp_path / "j"))


def test_restored_run_continues_bit_for_bit(tmp_path):
    """2 steps, a checkpoint, a fresh Trainer restored from it and 2 more
    steps equal 4 uninterrupted steps bit for bit: params, Adam moments
    and count, step count, the generator's stream and the step-4
    metrics."""
    batches = list(_loaders(n_train=4)[0].epoch())[:4]
    whole = _trainer()
    for b in batches:
        whole.train_step(b)
    half = _trainer(tmp_path)
    for b in batches[:2]:
        half.train_step(b)
    half.save_checkpoint("half")
    resumed = _trainer()
    resumed.restore_checkpoint(half.run_paths.model_path("disvae", "half"))
    assert resumed.step_count == 2 and resumed.opt.count == 2
    for b in batches[2:]:
        resumed.train_step(b)
    assert resumed.history[-1] == whole.history[-1]
    assert resumed.grad_norms[-1] == whole.grad_norms[-1]
    assert resumed.step_count == whole.step_count == 4
    for a, b in zip(resumed.leaves + resumed.opt.mu + resumed.opt.nu,
                    whole.leaves + whole.opt.mu + whole.opt.nu):
        assert torch.equal(a, b)
    assert torch.equal(resumed.gen.get_state(), whole.gen.get_state())


def test_restore_refuses_another_model(tmp_path):
    half = _trainer(tmp_path)
    half.save_checkpoint("x")
    other = trainer.Trainer(
        tcfg.tiny_model_config(txt_encoder="pianotree"),
        tcfg.TrainConfig(batch_size=B), None, device="cpu")
    with pytest.raises(ValueError, match="not this model's"):
        other.restore_checkpoint(half.run_paths.model_path("disvae", "x"))


@pytest.mark.parametrize("batch", [128, 2048, 3000, 4096, 6144, 2053,
                                   100_000])
@pytest.mark.parametrize("hbm_gib", [16, 32])
def test_auto_accum_steps_follows_the_jax_arithmetic(monkeypatch, batch,
                                                     hbm_gib):
    """With the JAX package's envelope (2048 segments with the frame
    kernel, measured on 16 GiB) put in the port's place, auto_accum_steps
    gives the JAX function's microbatch count, or its error, for the same
    device memory."""
    monkeypatch.setenv("PCTD_HBM_BYTES", str(hbm_gib * 1024 ** 3))
    monkeypatch.setattr(device_mem, "MEASURED_HBM", 16 * 1024 ** 3)
    monkeypatch.setitem(trainer.STEP_ENVELOPE, ("conv", 32), 2048)
    jm = jcfg.tiny_model_config(train_frame_kernel=True)
    try:
        want = jtrainer.auto_accum_steps(
            jm, jcfg.TrainConfig(batch_size=batch))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            trainer.auto_accum_steps(TINY, tcfg.TrainConfig(batch_size=batch))
        assert str(got.value) == str(e)
    else:
        assert trainer.auto_accum_steps(
            TINY, tcfg.TrainConfig(batch_size=batch)) == want


def test_auto_accum_steps_on_the_cpu_and_when_given(monkeypatch):
    """Unknown memory (the CPU) keeps the envelope as measured; an explicit
    accum_steps wins; the Trainer takes the automatic count."""
    monkeypatch.delenv("PCTD_HBM_BYTES", raising=False)
    env = trainer.STEP_ENVELOPE[("conv", 32)]
    assert device_mem.hbm_bytes("cpu") is None
    assert device_mem.scale_by_hbm(env, "cpu") == env
    auto = lambda b, **kw: trainer.auto_accum_steps(
        TINY, tcfg.TrainConfig(batch_size=b, **kw), "cpu")
    assert auto(env) == 1 and auto(env + 128) == 2
    assert auto(2 * env) == 2 and auto(3 * env) == 3
    assert auto(env, accum_steps=4) == 4
    run = trainer.Trainer(TINY, tcfg.TrainConfig(batch_size=2 * env), None,
                          device="cpu")
    assert run.accum == 2
