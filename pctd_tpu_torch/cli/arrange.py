"""Accompaniment arrangement (the port's counterpart of the JAX package's
``scripts/arrange.py``): given a piece's melody, chords and opening bars of
accompaniment, generate the rest of the accompaniment.

Per 2-bar window: the chord latent is the chord-encoder posterior mean of
that window's chords (estimated from the file, or ``--chords``); the
texture latent is the posterior mean of the given opening windows, held
(or, with ``--cycle-texture``, cycled) for the rest. The given windows keep
their original accompaniment, and the melody track is written beside the
arranged one. Decodes on the card (K4) unless ``--device cpu`` is given.

Usage:
    python -m pctd_tpu_torch.cli.arrange input.mid --checkpoint ckpt \\
        --out arranged.mid
    python -m pctd_tpu_torch.cli.arrange input.mid --given-bars 4 \\
        --chords "C-Am-F-G"
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.data import demo as dm
from pctd_tpu_torch.data.chords import (progression_to_chord_table,
                                        split_progression)
from pctd_tpu_torch.data.converter import (batch_expand_chord,
                                           piano_roll_to_target,
                                           pr_to_onehot_pr)
from pctd_tpu_torch.data.songs import midi_to_windows
from pctd_tpu_torch.data.tensorize import window_features
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.train.checkpoint import load_model
from pctd_tpu_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None,
         model_config: Optional[ModelConfig] = None) -> str:
    """Arrange as the flags say and write the MIDI file; returns its path.
    ``model_config`` replaces the canonical widths of a fresh model."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("input", help="source MIDI (melody track used if named "
                                  "'melody'; accompaniment = the rest)")
    ap.add_argument("--out", default="arranged.mid")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--given-bars", type=int, default=2,
                    help="opening accompaniment bars whose texture is kept")
    ap.add_argument("--cycle-texture", action="store_true",
                    help="cycle the given windows' textures instead of "
                         "holding the last one")
    ap.add_argument("--chords", default=None,
                    help="override the estimated chords with a progression")
    ap.add_argument("--bpm", type=float, default=0.0,
                    help="0 = keep the input file's tempo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params, cfg = load_model(args.checkpoint, model_config or ModelConfig(),
                             args.seed, device)
    print(f"loaded {args.checkpoint}" if args.checkpoint
          else "WARNING: no checkpoint — untrained model")
    sampler = Sampler(params, cfg, device=device)
    spec = cfg.pianotree

    try:
        pr, mel, chord, file_bpm = midi_to_windows(args.input)
    except ValueError as e:
        raise SystemExit(str(e))
    bpm = args.bpm or file_bpm
    n_win = len(pr)
    if args.chords:
        table = progression_to_chord_table(
            split_progression(args.chords), n_win * cfg.chord.num_step)
        chord = table.reshape(n_win, cfg.chord.num_step, 14)

    c = torch.as_tensor(batch_expand_chord(chord, np.zeros(n_win)),
                        dtype=torch.float32, device=device)
    z_chd = dv.encode_chord(sampler.params, cfg, c).mean

    # texture latents from the given opening windows
    n_given = max(1, args.given_bars // 2)
    _, dist_rhy = sampler.encode(*window_features(
        pr[:n_given], chord[:n_given], spec, device))
    if args.cycle_texture:
        idx = np.arange(n_win) % n_given
    else:
        idx = np.minimum(np.arange(n_win), n_given - 1)
    z_rhy = dist_rhy.mean[torch.as_tensor(idx, device=device)]

    grids = sampler.decode(z_chd, z_rhy)
    acc_segments = [dm.grid_to_pr_and_notes(g, bpm=bpm, spec=spec)[1]
                    for g in grids]
    # the given opening windows keep their original accompaniment
    for i in range(n_given):
        dur = piano_roll_to_target(pr_to_onehot_pr(pr[i].astype(int)))
        acc_segments[i] = dm.pr_matrix_to_notes(dur, bpm=bpm)

    mel_segments = [dm.mel_pr_to_notes(m, bpm=bpm) for m in mel]
    dm.write_demo(args.out, [mel_segments, acc_segments],
                  ["melody", "arranged_acc"], bpm=bpm, shift_beat=8)
    n_notes = sum(len(s) for s in acc_segments if s)
    print(f"wrote {args.out}: {n_win} windows ({n_given} given), "
          f"{n_notes} accompaniment notes, bpm {bpm:.0f}")
    return args.out


if __name__ == "__main__":
    main()
