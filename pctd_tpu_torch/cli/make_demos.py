"""The four controllable-generation demo workflows as MIDI files (the port's
counterpart of the JAX package's ``scripts/make_demos.py``), in the
structure and breadth of the reference's demo/ tree:

1_compositional_style_transfer/
    swap_{i}_{j}.mid (k x k latent recombination) + swap_all.mid
    more_examples/swap_{2k}by{2k}.mid       (larger grid, one multi-track file)
    16bar_style_transfer/{A_original,B_original,Achd_Btxt,Bchd_Atxt,all}.mid
    16bar_style_transfer/more_examples/sampleN/... (additional song pairs)
2_texture_variation/
    posterior_sampling/original.mid + post_sample_{0..2}.mid
    posterior_sampling/more_examples/sampleN/...   (additional originals)
    prior_sampling/C-Am-F-G.mid + more_examples/{Am-D7-G,G-F-Eb,F-Bb-F}.mid
3_acc_arrangement/
    fig_generation_given2bar.mid, arrangement_given_texture.mid
    more_examples/sampleN_given{2,4}bar.mid
    more_examples/long_generation/sampleN_given4bar.mid (iterative, >=16 bars)
chord_prog_interpolation/
    interp_chd.mid + named progression pairs, BOTH directions

Every decode runs through one ``Sampler(fixed_batch=16)`` on the card:
through K4 with ``--frame-decoder`` auto or pallas_full (the default), K3
with pallas (the serving daemon's mapping); xla is refused. Random draws
come from ``torch.Generator``s seeded as the JAX script seeds its keys.
The JAX script's ``--aot-dir`` and ``--platform`` (here ``--device``) are
not ported.

Usage:
    python -m pctd_tpu_torch.cli.make_demos --checkpoint \\
        <run>/models/disvae_final [--out demo_out] [--k 4] [--midi-dir DIR]

Without --checkpoint an untrained model is used (a structure run).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from pctd_tpu_torch.config import DataConfig, ModelConfig, tiny_model_config
from pctd_tpu_torch.data import demo as dm
from pctd_tpu_torch.data import tensorize as tz
from pctd_tpu_torch.data.chords import (progression_to_chord_table,
                                        split_progression)
from pctd_tpu_torch.data.converter import batch_expand_chord
from pctd_tpu_torch.data.songs import SongDataset
from pctd_tpu_torch.data.synthetic import synthetic_corpora
from pctd_tpu_torch.data.tensorize import window_features
from pctd_tpu_torch.cli.serve import FRAME_DECODERS
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.train.checkpoint import load_model
from pctd_tpu_torch.utils.device import resolve_device

# the named progressions of the reference demo tree (the prior_sampling
# file names and the chord_prog_interpolation pairs)
PRIOR_PROGRESSIONS = ["C-Am-F-G", "Am-D7-G", "G-F-Eb", "F-Bb-F"]
INTERP_PAIRS = [("C-Am-F-G", "Eb-Cm-Ab-Bb"), ("Am-Dm-G-C", "C-F-G-C"),
                ("Db-G-Cm", "C-D-G")]
FIXED_BATCH = 16


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Write the demo tree as the flags say; returns its directory."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--k", type=int, default=4,
                    help="k x k style-transfer grid size")
    ap.add_argument("--bpm", type=float, default=90.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model dims (a smoke run, untrained)")
    ap.add_argument("--midi-dir", default=None,
                    help="source segments from a corpus ingested from raw "
                         "MIDI files instead of the synthetic corpus")
    ap.add_argument("--frame-decoder", default="auto",
                    choices=["auto", "xla", "pallas", "pallas_full"],
                    help="auto and pallas_full: K4; pallas: K3; xla is "
                         "refused (no plain decode route on the card)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.frame_decoder not in FRAME_DECODERS:
        raise SystemExit(f"--frame-decoder {args.frame_decoder}: the plain "
                         "versions are not a decode route on the card; use "
                         "auto, pallas_full (K4) or pallas (K3)")
    device = resolve_device(args.device)
    params, cfg = load_model(
        args.checkpoint, tiny_model_config() if args.tiny else ModelConfig(),
        args.seed, device)
    print(f"loaded {args.checkpoint}" if args.checkpoint
          else "WARNING: no checkpoint — untrained model (structure run)")
    spec = cfg.pianotree

    dcfg = dataclasses.replace(DataConfig(), portion=4)
    if args.midi_dir:
        from pctd_tpu_torch.data.ingest import ingest_directory
        train_c, _ = ingest_directory(args.midi_dir, dcfg)
    else:
        train_c, _ = synthetic_corpora(n_songs=max(8, args.k * 2),
                                       seed=args.seed, cfg=dcfg)
    k = args.k
    sampler = Sampler(params, cfg,
                      frame_decoder=FRAME_DECODERS[args.frame_decoder],
                      fixed_batch=FIXED_BATCH, device=device)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)

    def pick_segments(n):
        """n segments from n distinct songs where possible (the reference's
        k pieces are different songs)."""
        sids = np.unique(train_c.song_id)
        if len(sids) >= n:
            return np.array([int(np.nonzero(train_c.song_id == s)[0][0])
                             for s in sids[:n]])
        return np.linspace(0, len(train_c) - 1, n).astype(int)

    def feats_at(idx):
        return window_features(train_c.pr[idx], train_c.chord[idx], spec,
                               device)

    idx = pick_segments(k)
    pr_mat, c = feats_at(idx)
    os.makedirs(args.out, exist_ok=True)

    def grid_notes(grid):
        return dm.grid_to_pr_and_notes(np.asarray(grid), bpm=args.bpm,
                                       spec=spec)[1]

    def write(path, tracks, names):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        dm.write_demo(path, tracks, names, bpm=args.bpm, shift_beat=8)

    def progression_chord(prog: str):
        """Chord symbols -> one 2-bar expanded chord window (1, 8, 36)."""
        symbols = split_progression(prog)
        table = progression_to_chord_table(
            symbols, cfg.chord.num_step,
            max(1, cfg.chord.num_step // len(symbols)))
        return torch.as_tensor(batch_expand_chord(table[None], np.zeros(1)),
                               dtype=torch.float32, device=device)

    def chord_latent(prog: str):
        return dv.encode_chord(sampler.params, cfg,
                               progression_chord(prog)).mean

    # -- 1: compositional style transfer (k x k latent recombination) --------
    d1 = os.path.join(args.out, "1_compositional_style_transfer")
    dist_chd, dist_rhy = sampler.encode(pr_mat, c)
    z_chd, z_rhy = dist_chd.mean, dist_rhy.mean

    def swap_grid(zc_src, zr_src, n):
        # row-major (chord i, texture j)
        return sampler.decode(zc_src.repeat_interleave(n, 0),
                              zr_src.repeat(n, 1))

    grids = swap_grid(z_chd, z_rhy, k)
    all_tracks = []
    for i in range(k):
        for j in range(k):
            notes = grid_notes(grids[i * k + j])
            write(os.path.join(d1, f"swap_{i}_{j}.mid"), [[notes]],
                  [f"chd{i}_txt{j}"])
            all_tracks.append([notes])
    write(os.path.join(d1, "swap_all.mid"), all_tracks,
          [f"swap_{i}_{j}" for i in range(k) for j in range(k)])

    # more_examples: a larger grid in one multi-track file (the reference
    # ships swap_31by31.mid)
    k2 = min(2 * k, len(np.unique(train_c.song_id)), 8)
    if k2 >= 2:
        dc2, dr2 = sampler.encode(*feats_at(pick_segments(k2)))
        grids2 = swap_grid(dc2.mean, dr2.mean, k2)
        write(os.path.join(d1, "more_examples", f"swap_{k2}by{k2}.mid"),
              [[grid_notes(g)] for g in grids2],
              [f"swap_{i}_{j}" for i in range(k2) for j in range(k2)])

    # -- 1b: 16-bar whole-song style transfer: all.mid holds the four scores
    # A, B, A-chd+B-txt, B-chd+A-txt, beside one file a score;
    # more_examples holds further song pairs --------------------------------
    songs = SongDataset(train_c, min_bars=12)
    fig_names = ["A_original", "B_original", "Achd_Btxt", "Bchd_Atxt"]

    def song_latents(song_i, length):
        b = songs.get_song_batch(song_i, length=length)
        dchd, drhy = sampler.encode(*window_features(b["pr"], b["chord"],
                                                     spec, device))
        return b, dchd.mean, drhy.mean

    def transfer_16bar(out_dir, sa, sb):
        n_win = 8  # 8 windows x 2 bars = 16 bars
        length = min(2 * n_win, min(songs.song_len[sa], songs.song_len[sb]))
        _, a_chd, a_rhy = song_latents(sa, length)
        _, b_chd, b_rhy = song_latents(sb, length)
        versions = [(a_chd, a_rhy), (b_chd, b_rhy), (a_chd, b_rhy),
                    (b_chd, a_rhy)]
        tracks = []
        for name, (zc, zr) in zip(fig_names, versions):
            seg_notes = [grid_notes(g) for g in sampler.decode(zc, zr)]
            write(os.path.join(out_dir, f"{name}.mid"), [seg_notes], [name])
            tracks.append(seg_notes)
        write(os.path.join(out_dir, "all.mid"), tracks, fig_names)

    pairs = [(2 * p, 2 * p + 1) for p in range(len(songs) // 2)][:3]
    for p, (sa, sb) in enumerate(pairs):
        base = os.path.join(d1, "16bar_style_transfer")
        transfer_16bar(base if p == 0 else os.path.join(
            base, "more_examples", f"sample{p}"), sa, sb)

    # -- 2: texture variation (posterior + prior sampling) -------------------
    d2p = os.path.join(args.out, "2_texture_variation", "posterior_sampling")
    d2q = os.path.join(args.out, "2_texture_variation", "prior_sampling")

    def posterior_set(out_dir, seg_i, seed0):
        """The original and 3 posterior texture samples of one segment."""
        one = slice(seg_i, seg_i + 1)
        write(os.path.join(out_dir, "original.mid"),
              [[grid_notes(sampler.decode(z_chd[one], z_rhy[one])[0])]],
              ["original"])
        for s in range(3):
            est = sampler.posterior_sample(
                gen(seed0 + s), pr_mat[one], c[one], scale=1.0,
                sample_chd=False, sample_txt=True)
            write(os.path.join(out_dir, f"post_sample_{s}.mid"),
                  [[grid_notes(est[0])]], ["posterior"])

    posterior_set(d2p, 0, 100)
    for n in range(1, min(4, k)):
        posterior_set(os.path.join(d2p, "more_examples", f"sample{n}"),
                      n, 100 + 10 * n)

    # prior sampling on the reference's named progressions: z_chd from the
    # chord encoder over the symbol table, the texture ~ N(0, I)
    for n, prog in enumerate(PRIOR_PROGRESSIONS):
        zr = torch.randn((1, cfg.txt_z_dim), generator=gen(200 + n),
                         device=device)
        est = sampler.decode(chord_latent(prog), zr)
        out_dir = d2q if n == 0 else os.path.join(d2q, "more_examples")
        write(os.path.join(out_dir, f"{prog}.mid"), [[grid_notes(est[0])]],
              [prog])
    for s in range(2):
        est = sampler.prior_sample(gen(300 + s), pr_mat[:1], c[:1],
                                   sample_rhy=True)
        write(os.path.join(d2q, f"prior_sample_{s}.mid"),
              [[grid_notes(est[0])]], ["prior"])

    # -- 3: accompaniment arrangement (windowed texture re-use) --------------
    # the whole chord progression given, and the first 1 (given2bar) or 2
    # (given4bar) windows' textures; the rest is arranged
    d3 = os.path.join(args.out, "3_acc_arrangement")

    def melody_tracks(mel, segs):
        mel_segs = [dm.mel_pr_to_notes(m, bpm=args.bpm) for m in mel]
        if any(len(s) for s in mel_segs):
            return [mel_segs, segs], ["melody", "arranged_acc"]
        return [segs], ["arranged_acc"]

    def arrange(song_i, given_windows, n_win):
        length = min(2 * n_win, songs.song_len[song_i])
        b, zc, zr = song_latents(song_i, length)
        # donor textures: the given windows in turn over the remainder
        rows = np.arange(len(zc)) % min(given_windows, len(zc))
        est = sampler.decode(zc, zr[torch.as_tensor(rows, device=device)])
        return melody_tracks(b["mel"], [grid_notes(e) for e in est])

    if len(songs) >= 1:
        write(os.path.join(d3, "fig_generation_given2bar.mid"),
              *arrange(0, given_windows=1, n_win=4))
        for n_s in range(min(3, len(songs))):
            for g, tag in ((1, "given2bar"), (2, "given4bar")):
                write(os.path.join(d3, "more_examples",
                                   f"sample{n_s + 1}_{tag}.mid"),
                      *arrange(n_s, given_windows=g, n_win=4))
        # long generation: >= 16 bars, iterative: each new window's texture
        # is the posterior of the previously generated window
        b = songs.get_song_batch(0)
        pm, cc = window_features(b["pr"], b["chord"], spec, device)
        dchd, drhy = sampler.encode(pm, cc)
        n = dchd.mean.shape[0]
        given = min(2, n)
        zr_t = drhy.mean[given - 1:given]
        segs = [grid_notes(sampler.decode(dchd.mean[t:t + 1],
                                          drhy.mean[t:t + 1])[0])
                for t in range(given)]
        for t in range(given, n):
            est = sampler.decode(dchd.mean[t:t + 1], zr_t)[0]
            segs.append(grid_notes(est))
            pr_est, _ = dm.grid_to_pr_and_notes(est, bpm=args.bpm, spec=spec)
            pm_est = tz.pr_to_dur_matrix(torch.as_tensor(
                pr_est[None].astype(np.int32), device=device))
            zr_t = sampler.encode(pm_est, cc[t:t + 1])[1].mean
        write(os.path.join(d3, "more_examples", "long_generation",
                           "sample1_given4bar.mid"), [segs],
              ["arranged_acc"])

    # the whole-sequence donor-texture file
    grids3 = sampler.decode(z_chd, z_rhy[:1].repeat(k, 1))
    write(os.path.join(d3, "arrangement_given_texture.mid"),
          *melody_tracks(train_c.mel[idx], [grid_notes(g) for g in grids3]))

    # -- 4: chord progression interpolation -----------------------------------
    # a corpus pair's SLERP and the reference's named progression pairs, in
    # both directions
    d4 = os.path.join(args.out, "chord_prog_interpolation")
    est = sampler.interp(pr_mat[:1], c[:1], pr_mat[1:2], c[1:2],
                         interp_chd=True, int_count=6)
    write(os.path.join(d4, "interp_chd.mid"),
          [[grid_notes(est[0, i]) for i in range(6)]], ["chord_interp"])
    zr_donor = z_rhy[:1]
    for pa, pb in INTERP_PAIRS:
        za, zb = chord_latent(pa), chord_latent(pb)
        for name, (z1, z2) in ((f"{pa}_to_{pb}", (za, zb)),
                               (f"{pb}_to_{pa}", (zb, za))):
            path = dv.interp_path(z1[0].cpu().numpy(), z2[0].cpu().numpy(),
                                  int_count=6)
            grids4 = sampler.decode(
                torch.as_tensor(path, dtype=torch.float32, device=device),
                zr_donor.repeat(6, 1))
            write(os.path.join(d4, f"{name}.mid"),
                  [[grid_notes(g) for g in grids4]], [name])

    n_files = sum(len(fs) for _, _, fs in os.walk(args.out))
    print(f"wrote {n_files} MIDI files under {args.out}/")
    return args.out


if __name__ == "__main__":
    main()
