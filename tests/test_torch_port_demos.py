"""The port's demo tree (``cli/make_demos.py``) against the JAX package on
the CPU at tiny width. The weights are the JAX init, eos-biased so frames
end at varied lengths, carried over by ``params_from_jax`` and saved as the
port checkpoint ``--checkpoint`` reads; the corpus is the synthetic one,
bit-equal in both packages. The steps of ``scripts/make_demos.py`` are
reproduced here with the JAX package's own Sampler (XLA route, the same
fixed batch), and every file of the tree that draws no noise is held
byte-equal to it: the swap grids, the 16-bar transfers, the posterior
originals, the named prior progressions (on the port's draws of the
texture), the arrangements, the iterative long generation and the
interpolations. The tree also has the structure the JAX package's own test
holds its script to, and every file parses with the port's reader."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu.config import DataConfig as JDataConfig
from pctd_tpu.data import demo as jdm
from pctd_tpu.data import tensorize as jtz
from pctd_tpu.data.chords import progression_to_chord_table, split_progression
from pctd_tpu.data.converter import batch_expand_chord
from pctd_tpu.data.songs import SongDataset
from pctd_tpu.data.synthetic import synthetic_corpora
from pctd_tpu.models import disentangle_vae as jdv
from pctd_tpu.models.sampler import Sampler as JSampler
from pctd_tpu_torch.cli import make_demos
from pctd_tpu_torch.data.midi_io import MidiFile
from pctd_tpu_torch.train import checkpoint
from tests.test_scripts import assert_demo_tree_structure
from tests.torch_port_helpers import (JAX_TINY, TINY, jax_params,
                                      port_params, with_eos_bias)

K = 2
SEED = 0
EOS_BIAS = 0.6
BPM = 90.0
# the files whose decode draws noise: the port draws it from torch
# generators, the JAX script from its PRNG keys
SAMPLED = ("post_sample_", "prior_sample_")


def jax_demo_tree(jp, out, k=K, seed=SEED):
    """The noise-free steps of ``scripts/make_demos.py`` on params ``jp``,
    with the prior progressions' textures drawn as the port draws them;
    returns {workflow: [paths relative to ``out``]}."""
    cfg, spec = JAX_TINY, JAX_TINY.pianotree
    train_c, _ = synthetic_corpora(
        n_songs=max(8, k * 2), seed=seed,
        cfg=dataclasses.replace(JDataConfig(), portion=4))
    sampler = JSampler(jp, cfg, frame_decoder="xla",
                       fixed_batch=make_demos.FIXED_BATCH)
    groups = {}

    def pick_segments(n):
        sids = np.unique(train_c.song_id)
        if len(sids) >= n:
            return np.array([int(np.nonzero(train_c.song_id == s)[0][0])
                             for s in sids[:n]])
        return np.linspace(0, len(train_c) - 1, n).astype(int)

    def feats(pr, chord):
        f = jtz.tensorize_batch(jnp.asarray(pr), jnp.asarray(chord),
                                jnp.zeros(len(pr), jnp.int32), spec=spec,
                                with_detrend=False)
        return f["pr_mat"], f["c"]

    def grid_notes(grid):
        return jdm.grid_to_pr_and_notes(np.asarray(grid), bpm=BPM,
                                        spec=spec)[1]

    def write(group, rel, tracks, names):
        path = os.path.join(out, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jdm.write_demo(path, tracks, names, bpm=BPM, shift_beat=8)
        groups.setdefault(group, []).append(rel)

    def chord_latent(prog):
        symbols = split_progression(prog)
        table = progression_to_chord_table(
            symbols, cfg.chord.num_step,
            max(1, cfg.chord.num_step // len(symbols)))
        cp = jnp.asarray(batch_expand_chord(table[None], np.zeros(1)))
        return jdv.encode_chord(jp, cfg, cp).mean

    def swap_grid(zc, zr, n):
        return sampler.decode(jnp.repeat(zc, n, axis=0),
                              jnp.tile(zr, (n, 1)))

    d1 = "1_compositional_style_transfer"
    idx = pick_segments(k)
    pr_mat, c = feats(train_c.pr[idx], train_c.chord[idx])
    d_chd, d_rhy = sampler.encode(pr_mat, c)
    z_chd, z_rhy = d_chd.mean, d_rhy.mean
    grids = swap_grid(z_chd, z_rhy, k)
    for i in range(k):
        for j in range(k):
            write("swap_grid", f"{d1}/swap_{i}_{j}.mid",
                  [[grid_notes(grids[i * k + j])]], [f"chd{i}_txt{j}"])
    write("swap_grid", f"{d1}/swap_all.mid",
          [[grid_notes(g)] for g in grids],
          [f"swap_{i}_{j}" for i in range(k) for j in range(k)])
    k2 = min(2 * k, len(np.unique(train_c.song_id)), 8)
    idx2 = pick_segments(k2)
    dc2, dr2 = sampler.encode(*feats(train_c.pr[idx2], train_c.chord[idx2]))
    write("swap_grid", f"{d1}/more_examples/swap_{k2}by{k2}.mid",
          [[grid_notes(g)] for g in swap_grid(dc2.mean, dr2.mean, k2)],
          [f"swap_{i}_{j}" for i in range(k2) for j in range(k2)])

    songs = SongDataset(train_c, min_bars=12)

    def song_latents(song_i, length):
        b = songs.get_song_batch(song_i, length=length)
        pm, cc = feats(b["pr"], b["chord"])
        dc, dr = sampler.encode(pm, cc)
        return b, cc, dc.mean, dr.mean

    fig_names = ["A_original", "B_original", "Achd_Btxt", "Bchd_Atxt"]
    pairs = [(2 * p, 2 * p + 1) for p in range(len(songs) // 2)][:3]
    for p, (sa, sb) in enumerate(pairs):
        base = f"{d1}/16bar_style_transfer"
        base = base if p == 0 else f"{base}/more_examples/sample{p}"
        length = min(16, songs.song_len[sa], songs.song_len[sb])
        _, _, a_chd, a_rhy = song_latents(sa, length)
        _, _, b_chd, b_rhy = song_latents(sb, length)
        tracks = []
        for name, (zc, zr) in zip(fig_names, [
                (a_chd, a_rhy), (b_chd, b_rhy), (a_chd, b_rhy),
                (b_chd, a_rhy)]):
            seg_notes = [grid_notes(g) for g in sampler.decode(zc, zr)]
            write("16bar", f"{base}/{name}.mid", [seg_notes], [name])
            tracks.append(seg_notes)
        write("16bar", f"{base}/all.mid", tracks, fig_names)

    d2p = "2_texture_variation/posterior_sampling"
    d2q = "2_texture_variation/prior_sampling"
    for n in range(min(4, k)):
        rel = d2p if n == 0 else f"{d2p}/more_examples/sample{n}"
        one = slice(n, n + 1)
        write("posterior_original", f"{rel}/original.mid",
              [[grid_notes(sampler.decode(z_chd[one], z_rhy[one])[0])]],
              ["original"])
    for n, prog in enumerate(make_demos.PRIOR_PROGRESSIONS):
        zr = torch.randn((1, cfg.txt_z_dim),
                         generator=torch.Generator().manual_seed(200 + n))
        est = sampler.decode(chord_latent(prog), jnp.asarray(zr.numpy()))
        rel = d2q if n == 0 else f"{d2q}/more_examples"
        write("prior_progression", f"{rel}/{prog}.mid",
              [[grid_notes(est[0])]], [prog])

    d3 = "3_acc_arrangement"

    def melody_tracks(mel, segs):
        mel_segs = [jdm.mel_pr_to_notes(m, bpm=BPM) for m in mel]
        if any(len(s) for s in mel_segs):
            return [mel_segs, segs], ["melody", "arranged_acc"]
        return [segs], ["arranged_acc"]

    def arrange(song_i, given):
        b, _, zc, zr = song_latents(song_i, min(8, songs.song_len[song_i]))
        n = zc.shape[0]
        g = min(given, n)
        zr = jnp.tile(zr[:g], (-(-n // g), 1))[:n]
        return melody_tracks(b["mel"], [grid_notes(e)
                                        for e in sampler.decode(zc, zr)])

    write("arrangement", f"{d3}/fig_generation_given2bar.mid",
          *arrange(0, 1))
    for n_s in range(min(3, len(songs))):
        for g, tag in ((1, "given2bar"), (2, "given4bar")):
            write("arrangement",
                  f"{d3}/more_examples/sample{n_s + 1}_{tag}.mid",
                  *arrange(n_s, g))
    write("arrangement", f"{d3}/arrangement_given_texture.mid",
          *melody_tracks(train_c.mel[idx], [
              grid_notes(g) for g in sampler.decode(
                  z_chd, jnp.repeat(z_rhy[:1], k, axis=0))]))

    _, cc, zc, zr = song_latents(0, songs.song_len[0])
    n = zc.shape[0]
    given = min(2, n)
    zr_t = zr[given - 1:given]
    segs = [grid_notes(sampler.decode(zc[t:t + 1], zr[t:t + 1])[0])
            for t in range(given)]
    for t in range(given, n):
        est = sampler.decode(zc[t:t + 1], zr_t)[0]
        segs.append(grid_notes(est))
        pr_est, _ = jdm.grid_to_pr_and_notes(np.asarray(est), bpm=BPM,
                                             spec=spec)
        pm_est = jtz.pr_to_dur_matrix(
            jnp.asarray(pr_est[None].astype(np.int32)))
        zr_t = sampler.encode(pm_est, cc[t:t + 1])[1].mean
    write("long_generation",
          f"{d3}/more_examples/long_generation/sample1_given4bar.mid",
          [segs], ["arranged_acc"])

    d4 = "chord_prog_interpolation"
    est = sampler.interp(pr_mat[:1], c[:1], pr_mat[1:2], c[1:2],
                         interp_chd=True, int_count=6)
    write("interpolation", f"{d4}/interp_chd.mid",
          [[grid_notes(est[0, i]) for i in range(6)]], ["chord_interp"])
    for pa, pb in make_demos.INTERP_PAIRS:
        za, zb = chord_latent(pa), chord_latent(pb)
        for name, (z1, z2) in ((f"{pa}_to_{pb}", (za, zb)),
                               (f"{pb}_to_{pa}", (zb, za))):
            path = jdv.interp_path(np.asarray(z1[0]), np.asarray(z2[0]),
                                   int_count=6)
            grids4 = sampler.decode(jnp.asarray(path),
                                    jnp.repeat(z_rhy[:1], 6, axis=0))
            write("interpolation", f"{d4}/{name}.mid",
                  [[grid_notes(g) for g in grids4]], [name])
    return groups


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    d = tmp_path_factory.mktemp("demos")
    jp = with_eos_bias(jax_params(JAX_TINY, seed=SEED), EOS_BIAS)
    ck = str(d / "ck")
    checkpoint.save_params(ck, port_params(jp), TINY)
    out = str(d / "demo_out")
    assert make_demos.main(["--tiny", "--k", str(K), "--device", "cpu",
                            "--seed", str(SEED), "--out", out,
                            "--checkpoint", ck]) == out
    want = str(d / "jax_out")
    return out, want, jax_demo_tree(jp, want)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_tree_has_the_reference_structure(trees):
    out = trees[0]
    mids = _files(out)
    assert len(mids) >= 10 and all(m.endswith(".mid") for m in mids)
    for rel in mids:
        MidiFile.read(os.path.join(out, rel))
    assert_demo_tree_structure(out, k=K)


@pytest.mark.parametrize("group", [
    "swap_grid", "16bar", "posterior_original", "prior_progression",
    "arrangement", "long_generation", "interpolation"])
def test_noise_free_files_hold_the_jax_bytes(trees, group):
    out, want, groups = trees
    assert groups[group]
    for rel in groups[group]:
        assert _bytes(os.path.join(out, rel)) == \
            _bytes(os.path.join(want, rel)), rel


def test_every_file_is_held_to_jax_but_the_sampled_ones(trees):
    out, _, groups = trees
    held = sorted(rel for rels in groups.values() for rel in rels)
    rest = [rel for rel in _files(out) if rel not in held]
    assert rest and all(os.path.basename(rel).startswith(SAMPLED)
                        for rel in rest), rest
    assert set(held) <= set(_files(out))


def test_swap_files_hold_the_sampler_swap_grids(trees, tmp_path):
    """swap_{i}_{j}.mid is segment i's chords under segment j's texture:
    the bytes of the JAX ``Sampler.swap`` on the same weights."""
    out = trees[0]
    jp = with_eos_bias(jax_params(JAX_TINY, seed=SEED), EOS_BIAS)
    spec = JAX_TINY.pianotree
    train_c, _ = synthetic_corpora(
        n_songs=max(8, 2 * K), seed=SEED,
        cfg=dataclasses.replace(JDataConfig(), portion=4))
    idx = [int(np.nonzero(train_c.song_id == s)[0][0])
           for s in np.unique(train_c.song_id)[:K]]
    f = jtz.tensorize_batch(jnp.asarray(train_c.pr[idx]),
                            jnp.asarray(train_c.chord[idx]),
                            jnp.zeros(K, jnp.int32), spec=spec,
                            with_detrend=False)
    pr_mat, c = f["pr_mat"], f["c"]
    sampler = JSampler(jp, JAX_TINY, frame_decoder="xla",
                       fixed_batch=make_demos.FIXED_BATCH)
    d1 = os.path.join(out, "1_compositional_style_transfer")
    for i in range(K):
        for j in range(K):
            grid = sampler.swap(pr_mat[j:j + 1], pr_mat[i:i + 1],
                                c[j:j + 1], c[i:i + 1], fix_rhy=True,
                                fix_chd=False)[0]
            notes = jdm.grid_to_pr_and_notes(grid, bpm=BPM, spec=spec)[1]
            want = str(tmp_path / f"want_{i}_{j}.mid")
            jdm.write_demo(want, [[notes]], [f"chd{i}_txt{j}"], bpm=BPM,
                           shift_beat=8)
            assert _bytes(want) == \
                _bytes(os.path.join(d1, f"swap_{i}_{j}.mid")), (i, j)


def test_k3_route_writes_the_default_routes_files(trees, tmp_path):
    """``--frame-decoder pallas`` decodes every grid through the per-frame
    route (K3 on the card): the same files, byte for byte, as the default
    whole-sequence route (K4); ``xla`` is refused."""
    out = trees[0]
    ck = os.path.join(os.path.dirname(out), "ck")
    k3 = str(tmp_path / "k3_out")
    make_demos.main(["--tiny", "--k", str(K), "--device", "cpu", "--seed",
                     str(SEED), "--out", k3, "--checkpoint", ck,
                     "--frame-decoder", "pallas"])
    assert _files(k3) == _files(out)
    for rel in _files(out):
        assert _bytes(os.path.join(k3, rel)) == \
            _bytes(os.path.join(out, rel)), rel
    with pytest.raises(SystemExit, match="not a decode route"):
        make_demos.main(["--tiny", "--device", "cpu", "--out",
                         str(tmp_path / "x"), "--frame-decoder", "xla"])
