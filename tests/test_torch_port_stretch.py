"""The 32-bar stretch configuration (``PianoTreeSpec(num_step=128)``,
``ChordSpec(num_step=32)``, the corpus of ``DataConfig(num_bar=8)``) of
the port against the JAX package on the CPU, at the stretch widths of the
JAX package's own stretch tests: the loss and its 11 metrics in both loss
modes and the parameter gradients, the argmax decode through K4's and the
K3 route's plain versions, the 8-bar corpus and a train step, song
batching at 8 bars, and the step envelope at num_step=128."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu import config as jcfg
from pctd_tpu.data import songs as jsongs
from pctd_tpu.data.corpus import build_corpora as jbuild_corpora
from pctd_tpu.data.synthetic import synthetic_corpora as jsynthetic_corpora
from pctd_tpu.data.synthetic import synthetic_song as jsynthetic_song
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu_torch import config as tcfg
from pctd_tpu_torch.data import songs as tsongs
from pctd_tpu_torch.data.corpus import build_corpora, valid_song_runs
from pctd_tpu_torch.data.loaders import make_loaders
from pctd_tpu_torch.data.synthetic import synthetic_corpora, synthetic_song
from pctd_tpu_torch.models import disentangle_vae as tdv
from pctd_tpu_torch.models import texture_encoder as ttxt
from pctd_tpu_torch.train import trainer
from tests.test_models_parity import random_batch
from tests.test_torch_port_training import _named
from tests.torch_port_helpers import jax_noise, jax_params, port_params

# the widths of tests/test_aux_and_stretch.py::_stretch_cfg
WIDTHS = dict(chd_z_dim=16, txt_z_dim=16, chd_enc_hidden=24,
              txt_emb_size=24, txt_enc_hidden=24, chd_dec_hidden=24,
              chd_dec_z_in=16, note_emb_size=24, dec_emb_hidden=12,
              dec_time_hidden=32, dec_notes_hidden=16, dec_z_in=16,
              dec_dur_hidden=8)
JCFG = dataclasses.replace(jcfg.ModelConfig(),
                           pianotree=jcfg.PianoTreeSpec(num_step=128),
                           chord=jcfg.ChordSpec(num_step=32), **WIDTHS)
CFG = dataclasses.replace(tcfg.ModelConfig(),
                          pianotree=tcfg.PianoTreeSpec(num_step=128),
                          chord=tcfg.ChordSpec(num_step=32), **WIDTHS)
B = 2
TFR = (0.5, 0.5, 0.5)
BETA = 0.1


@pytest.fixture(scope="module")
def case():
    """JAX-initialised weights and a 128-step batch of tiled 2-bar rolls
    (as the JAX stretch tests build it), the key and its noise."""
    jp = jax_params(JCFG, seed=2)
    x, c, pr_mat = random_batch(B, seed=33)
    batch = (np.tile(x, (1, 4, 1, 1)).astype(np.int32),
             np.tile(c, (1, 4, 1)), np.tile(pr_mat, (1, 4, 1)))
    key = jax.random.PRNGKey(4)
    return jp, batch, key, jax_noise(key, JCFG, B, *TFR)


def _port_loss(params, cfg, batch, noise_np):
    noise = tdv.Noise(*(torch.from_numpy(a) for a in noise_np))
    return tdv.loss(params, cfg, *(torch.from_numpy(a) for a in batch),
                    noise, beta=BETA)


def test_conv_encoder_regroups_by_num_step():
    """H = 32 conv rows, so 8 GRU steps of 1,160 features (JAX
    texture_encoder.py:35-38)."""
    assert ttxt._conv_dims(dataclasses.replace(tcfg.ModelConfig(),
                                               pianotree=CFG.pianotree)) \
        == (32, 29, 1160)


def test_loss_metrics_and_grads_match_jax(case):
    """Both loss modes' 11 metrics against the JAX loss on the XLA path
    (rtol 2e-5, the JAX stretch kernel test's bar), the gradients of the
    fused mode within atol 2e-4: the frame-by-frame decode over 128
    frames, its CE partials summed over every frame."""
    jp, batch, key, noise = case
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jdv.loss(p, JCFG, key, *batch, tfr1=TFR[0], tfr2=TFR[1],
                           tfr3=TFR[2], beta=BETA), has_aux=True))(jp)
    params = port_params(jp)
    leaves = _named(params)
    for v in leaves.values():
        v.requires_grad_(True)
    for fused in (True, False):
        total, metrics = _port_loss(
            params, dataclasses.replace(CFG, fused_loss=fused), batch, noise)
        for name in tdv.METRIC_NAMES:
            np.testing.assert_allclose(metrics[name].item(),
                                       float(jmetrics[name]), rtol=2e-5,
                                       err_msg=f"{name} fused={fused}")
        if fused:
            total.backward()
    want = _named(jgrads)
    assert sorted(want) == sorted(leaves)
    for name, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[name]),
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("frame_decoder", ["full", "frame"])
def test_decode_matches_jax(case, frame_decoder):
    """The argmax decode over 128 frames through K4's plain version and
    the K3 route's against the JAX decode: grids exact."""
    jp = case[0]
    rng = np.random.RandomState(5)
    zc = rng.randn(3, CFG.chd_z_dim).astype(np.float32)
    zr = rng.randn(3, CFG.txt_z_dim).astype(np.float32)
    want = np.asarray(jdv.decode_z(jp, JCFG, jnp.asarray(zc),
                                   jnp.asarray(zr)))
    got = tdv.decode_z(port_params(jp), CFG, torch.from_numpy(zc),
                       torch.from_numpy(zr), frame_decoder).numpy()
    assert got.shape == (3, 128, 15, 6)
    np.testing.assert_array_equal(got, want)


def test_8bar_corpus_and_a_train_step():
    """The 8-bar corpus equals the JAX package's (tests/
    test_stretch_corpus.py:21-46), and a Trainer step at the stretch takes
    it."""
    dcfg = dataclasses.replace(tcfg.DataConfig(), num_bar=8, portion=3)
    train_c, val_c = synthetic_corpora(n_songs=6, seed=9, n_bars=16,
                                       cfg=dcfg)
    want, _ = jsynthetic_corpora(n_songs=6, seed=9, n_bars=16,
                                 cfg=dataclasses.replace(jcfg.DataConfig(),
                                                         num_bar=8, portion=3))
    assert train_c.pr.shape[1:] == (128, 128)
    assert train_c.chord.shape[1:] == (32, 14)
    assert train_c.mel.shape[1:] == (128, 130)
    assert train_c.pr[:, 96:].any()
    for f in ("pr", "mel", "chord", "song_id", "bar_pos"):
        np.testing.assert_array_equal(getattr(train_c, f), getattr(want, f),
                                      err_msg=f)
    mcfg = dataclasses.replace(tcfg.tiny_model_config(),
                               pianotree=CFG.pianotree, chord=CFG.chord)
    tl, _ = make_loaders(train_c, val_c, batch_size=4, seed=0)
    run = trainer.Trainer(mcfg, tcfg.TrainConfig(batch_size=4), tl,
                          device="cpu")
    assert run.accum == 1
    (m,) = run.train_steps(1)
    assert np.isfinite(m["loss"]) and all(np.isfinite(v) for v in m.values())


def test_song_batching_at_8_bars_equals_jax():
    """SongDataset(num_bar=8) on 40-bar songs: the runs (length + 9 >=
    min_bars) and every batch equal the JAX package's."""
    rng, jrng = np.random.RandomState(7), np.random.RandomState(7)
    musics = [synthetic_song(rng, n_bars=40) for _ in range(3)]
    jmusics = [jsynthetic_song(jrng, n_bars=40) for _ in range(3)]
    train, _ = build_corpora(musics, dataclasses.replace(
        tcfg.DataConfig(), portion=2, num_bar=8))
    jtrain, _ = jbuild_corpora(jmusics, dataclasses.replace(
        jcfg.DataConfig(), portion=2, num_bar=8))
    assert valid_song_runs(train, min_bars=40, num_bar=8)
    assert not valid_song_runs(train, min_bars=40, num_bar=2)
    sd = tsongs.SongDataset(train, min_bars=40, num_bar=8)
    jsd = jsongs.SongDataset(jtrain, min_bars=40, num_bar=8)
    assert (sd.song_ind, sd.song_len) == (jsd.song_ind, jsd.song_len)
    assert len(sd) >= 1
    for i in range(len(sd)):
        got, want = sd.get_song_batch(i), jsd.get_song_batch(i)
        assert got["pr"].shape[1:] == (128, 128)
        assert got["pr"].shape[0] == -(-sd.song_len[i] // 8)
        for k in ("pr", "mel", "chord", "shift"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_step_envelope_at_the_stretch(monkeypatch):
    """auto_accum_steps reads the (conv, 128) envelope; a configuration
    whose envelope was not measured raises."""
    monkeypatch.delenv("PCTD_HBM_BYTES", raising=False)
    env = trainer.STEP_ENVELOPE[("conv", 128)]
    assert env < trainer.STEP_ENVELOPE[("conv", 32)]
    assert trainer.step_envelope(CFG) == env
    auto = lambda b: trainer.auto_accum_steps(
        CFG, tcfg.TrainConfig(batch_size=b), "cpu")
    assert auto(env) == 1 and auto(env + 128) == 2 and auto(4 * env) == 4
    other = dataclasses.replace(CFG, pianotree=tcfg.PianoTreeSpec(
        num_step=64))
    with pytest.raises(ValueError, match="no step envelope measured"):
        trainer.auto_accum_steps(other, tcfg.TrainConfig(batch_size=128),
                                 "cpu")
    assert trainer.auto_accum_steps(
        other, tcfg.TrainConfig(batch_size=128, accum_steps=2), "cpu") == 2
