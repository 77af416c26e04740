"""The port's command-line entry points on the CPU at tiny width: the train
CLI runs an epoch on a synthetic corpus and writes its run directory, and
the evaluate CLI's deterministic ``evaluate`` on JAX-bridged weights equals
the JAX loss with posterior means and teacher-forcing rate 0 over the same
val batches."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pctd_tpu import config as jcfg
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.train import trainer as jtrainer
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.cli import evaluate, train
from pctd_tpu_torch.data.loaders import make_loaders
from pctd_tpu_torch.data.synthetic import synthetic_corpora
from pctd_tpu_torch.models import disentangle_vae as tdv
from tests.torch_port_helpers import jax_params, port_params


def test_train_cli_writes_its_run(tmp_path, capsys):
    argv = ["--device", "cpu", "--epochs", "1", "--batch-size", "64",
            "--synthetic-songs", "2", "--log-every", "1", "--result-dir",
            str(tmp_path)]
    result = train.main(argv, model_config=tcfg.tiny_model_config())
    out = capsys.readouterr().out
    assert "corpus: 15 train / 15 val segments (synthetic, 2 songs)" in out
    assert "Epoch: 01 | Time:" in out and "Model saved." in out
    run, = glob.glob(str(tmp_path / "result_*"))
    with open(os.path.join(run, "final_metrics.json")) as f:
        saved = json.load(f)
    assert saved["val"] == result["val"] and saved["train_steps"] == 2
    assert list(saved["train"]) == list(tdv.METRIC_NAMES)
    assert np.isfinite(saved["val"]["loss"]) and saved["val"]["loss"] > 0
    for tag in ("epoch", "valid", "final"):
        assert os.path.isfile(os.path.join(run, "models", f"disvae_{tag}"))
    with open(os.path.join(run, "writers", "metrics.csv")) as f:
        tasks = [ln.split(",")[:2] for ln in f.read().splitlines()[1:]]
    assert tasks == [["train", "0"], ["train", "1"], ["val", "0"]]
    assert os.path.isfile(os.path.join(run, "readme.txt"))
    # the evaluate CLI reads the checkpoint back with its configuration
    ev = evaluate.main(["--device", "cpu", "--checkpoint",
                        os.path.join(run, "models", "disvae_final"),
                        "--deterministic", "--synthetic-songs", "2",
                        "--batch-size", "64"])
    assert ev["num_batches"] == 1 and np.isfinite(ev["loss"])


@pytest.mark.parametrize("variant", ["conv", "pianotree"])
def test_deterministic_evaluate_equals_jax(variant):
    """Posterior means and every coin 0: the port's evaluate and the JAX
    ``loss(sample=False, tfr=0)`` averaged over the same val batches agree
    within 1e-5 relative."""
    jc = jcfg.tiny_model_config(txt_encoder=variant)
    cfg = tcfg.tiny_model_config(txt_encoder=variant)
    jp = jax_params(jc, seed=3)
    _, val = synthetic_corpora(n_songs=2, seed=5)
    _, vl = make_loaders(val, val, 5, seed=0)
    got = evaluate.evaluate(port_params(jp), cfg, vl, deterministic=True)
    assert got["num_batches"] == len(vl) == 3
    jloss = jax.jit(lambda p, pr, chord, shift: jdv.loss(
        p, jc, jax.random.PRNGKey(0),
        *jtrainer.batch_features(pr, chord, shift, jc), tfr1=0.0, tfr2=0.0,
        tfr3=0.0, beta=0.1, sample=False)[1])
    rows = [jloss(jp, *(jnp.asarray(b[k]) for k in ("pr", "chord", "shift")))
            for b in vl.epoch()]
    for k in tdv.METRIC_NAMES:
        want = np.mean([float(r[k]) for r in rows])
        np.testing.assert_allclose(got[k], want, rtol=1e-5, err_msg=k)


def test_evaluate_draws_noise_unless_deterministic():
    """Without --deterministic the latent noise comes from the generator:
    the KL terms are the same, the reconstruction is not."""
    import torch

    cfg = tcfg.tiny_model_config()
    params = tdv.init_params(cfg, seed=1, device="cpu")
    _, val = synthetic_corpora(n_songs=2, seed=5)
    _, vl = make_loaders(val, val, 5, seed=0)
    det = evaluate.evaluate(params, cfg, vl, deterministic=True)
    drawn = evaluate.evaluate(params, cfg, vl,
                              generator=torch.Generator().manual_seed(1))
    assert drawn["kl_loss"] == pytest.approx(det["kl_loss"], rel=1e-6)
    assert drawn["recon_loss"] != det["recon_loss"]


def test_train_cli_flags_reach_the_configs(monkeypatch, tmp_path):
    """--variant, --compute-dtype, --no-fused-loss and the train flags
    reach the Trainer's configurations."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_trainer(mcfg, tcfg_, *a, **kw):
        seen.update(mcfg=mcfg, tcfg=tcfg_, kw=kw)
        raise Stop

    monkeypatch.setattr(train, "Trainer", fake_trainer)
    with pytest.raises(Stop):
        train.main(["--device", "cpu", "--variant", "pianotree",
                    "--compute-dtype", "bfloat16", "--no-fused-loss",
                    "--accum-steps", "2", "--lr", "0.01", "--clip", "0.5",
                    "--sched-horizon", "3", "--eval-fixed-schedule",
                    "--profile", "2", "--log-every", "5",
                    "--synthetic-songs", "2", "--result-dir", str(tmp_path)],
                   model_config=tcfg.tiny_model_config())
    m, t = seen["mcfg"], seen["tcfg"]
    assert (m.txt_encoder, m.compute_dtype, m.fused_loss) == (
        "pianotree", "bfloat16", False)
    assert m.chd_z_dim == tcfg.tiny_model_config().chd_z_dim
    assert (t.accum_steps, t.lr, t.clip_norm, t.sched_horizon,
            t.eval_fixed_schedule) == (2, 0.01, 0.5, 3.0, True)
    assert seen["kw"]["profile_steps"] == (2, 4)
    assert seen["kw"]["log_every"] == 5


def test_evaluate_on_a_midi_directory_equals_jax(tmp_path, capsys):
    """``--midi-dir`` evaluates on the corpus ingested from MIDI written
    here: the ``--deterministic`` metrics of a checkpoint equal the JAX
    evaluation (``loss(sample=False, tfr=0)``) of the same weights over the
    val batches of the JAX package's ingest of the same files."""
    from pctd_tpu.config import DataConfig as JDataConfig
    from pctd_tpu.data.ingest import ingest_directory as jingest_directory
    from pctd_tpu.data.loaders import make_loaders as jmake_loaders
    from pctd_tpu_torch.train import checkpoint
    from tests.test_torch_port_serve import write_song

    midi = tmp_path / "midi"
    os.makedirs(midi)
    for i in range(4):
        write_song(str(midi / f"s{i}.mid"), 30 + i, 12 + 2 * i,
                   names=("a", "b", "c"))
    jc, cfg = jcfg.tiny_model_config(), tcfg.tiny_model_config()
    jp = jax_params(jc, seed=4)
    ck = str(tmp_path / "ck")
    checkpoint.save_params(ck, port_params(jp), cfg)
    got = evaluate.main(["--device", "cpu", "--checkpoint", ck,
                         "--midi-dir", str(midi), "--deterministic",
                         "--batch-size", "8", "--seed", "3345"])
    _, val = jingest_directory(str(midi), JDataConfig(seed=3345))
    _, vl = jmake_loaders(val, val, 8, seed=3345)
    jloss = jax.jit(lambda p, pr, chord, shift: jdv.loss(
        p, jc, jax.random.PRNGKey(0),
        *jtrainer.batch_features(pr, chord, shift, jc), tfr1=0.0, tfr2=0.0,
        tfr3=0.0, beta=0.1, sample=False)[1])
    rows = [jloss(jp, *(jnp.asarray(b[k]) for k in ("pr", "chord", "shift")))
            for b in vl.epoch()]
    assert got["num_batches"] == len(rows) >= 1
    for k in tdv.METRIC_NAMES:
        want = np.mean([float(r[k]) for r in rows])
        np.testing.assert_allclose(got[k], want, rtol=1e-5, err_msg=k)


def test_train_cli_accepts_the_jax_decode_flags(monkeypatch, tmp_path):
    """``--remat`` and ``--frame-kernel`` are accepted and change nothing:
    the port always decodes through its frame kernels."""
    seen = []

    class Stop(Exception):
        pass

    def fake_trainer(mcfg, tcfg_, *a, **kw):
        seen.append((mcfg, tcfg_))
        raise Stop

    monkeypatch.setattr(train, "Trainer", fake_trainer)
    for flags in ([], ["--remat", "--frame-kernel"]):
        with pytest.raises(Stop):
            train.main(["--device", "cpu", "--synthetic-songs", "2",
                        "--result-dir", str(tmp_path), *flags],
                       model_config=tcfg.tiny_model_config())
    assert seen[0] == seen[1]
    assert "--remat" in train.parser().format_help()


def test_parallel_train_cli_at_world_size_one_equals_the_plain_run(
        tmp_path, capsys):
    """``--device cpu --parallel --dist-backend gloo`` runs an epoch as a
    process group of one rank; its metrics and final params equal the run
    without ``--parallel`` bit for bit, and the group is gone after."""
    import torch
    import torch.distributed as dist

    from pctd_tpu_torch.train import checkpoint

    runs = []
    for flags in ([], ["--parallel", "--dist-backend", "gloo"]):
        base = tmp_path / ("dp" if flags else "plain")
        result = train.main(["--device", "cpu", "--epochs", "1",
                             "--batch-size", "64", "--synthetic-songs", "2",
                             "--result-dir", str(base), *flags],
                            model_config=tcfg.tiny_model_config())
        run, = glob.glob(str(base / "result_*"))
        runs.append((result, checkpoint.load_state(
            os.path.join(run, "models", "disvae_final"))))
    out = capsys.readouterr().out
    assert "data-parallel over 1 rank(s), 64 rows each, gloo" in out
    assert not dist.is_initialized()
    (plain, ck_plain), (dp, ck_dp) = runs
    assert dp["train"] == plain["train"] and dp["val"] == plain["val"]
    assert dp["train_steps"] == plain["train_steps"] == 2
    for name, t in ck_plain["params"].items():
        assert torch.equal(t, ck_dp["params"][name]), name
    assert torch.equal(ck_dp["generators"][0], ck_plain["generator"])
