"""Generate music from a chord progression (the port's counterpart of the
JAX package's ``scripts/generate.py``).

The progression drives the chord latent through the chord encoder; the
texture latent comes from the prior (``torch.randn`` on a generator seeded
from ``--seed``, times ``--scale``), or from a donor MIDI's accompaniment
(``--texture-from``: its texture posterior, the mean for one sample).
The latents are decoded on the card (K4) unless ``--device cpu`` is given.

Usage:
    python -m pctd_tpu_torch.cli.generate --chords "C-Am-F-G" --out cafg.mid \\
        --checkpoint <run>/models/disvae_final
    python -m pctd_tpu_torch.cli.generate --chords "Am D7 G" \\
        --texture-from donor.mid --bars 8 --samples 3 --out out.mid
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
from pctd_tpu_torch.data.converter import batch_expand_chord
from pctd_tpu_torch.data.tensorize import window_features
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.train.checkpoint import load_model
from pctd_tpu_torch.utils.device import resolve_device


def texture_windows(path: str, n_windows: int):
    """``n_windows`` raw windows (pr, chord) spread evenly over the valid
    2-bar segments of the MIDI file at ``path``."""
    from pctd_tpu_torch.data.corpus import song_to_segments
    from pctd_tpu_torch.data.ingest import midi_to_musics

    musics = midi_to_musics(path, split_tracks=False)
    seg = song_to_segments(musics[0], 0) if musics else None
    if seg is None or len(seg) == 0:
        raise SystemExit(f"{path}: no valid 2-bar segments to take "
                         "texture from")
    idx = np.linspace(0, len(seg) - 1, n_windows).astype(int)
    return seg.pr[idx], seg.chord[idx]


def main(argv: Optional[Sequence[str]] = None,
         model_config: Optional[ModelConfig] = None) -> str:
    """Generate as the flags say and write the MIDI file; returns its path.
    ``model_config`` replaces the canonical widths of a fresh model."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--chords", required=True,
                    help="progression, e.g. 'C-Am-F-G' or 'Am D7 G'")
    ap.add_argument("--out", default="generated.mid")
    ap.add_argument("--checkpoint", default=None,
                    help="train checkpoint (untrained model if omitted)")
    ap.add_argument("--texture-from", default=None, metavar="MIDI",
                    help="donor MIDI whose accompaniment texture is reused "
                         "(default: sample the texture prior)")
    ap.add_argument("--bars", type=int, default=2,
                    help="length in bars (2-bar windows, chords repeat)")
    ap.add_argument("--samples", type=int, default=1,
                    help="number of variations (stacked as MIDI tracks)")
    ap.add_argument("--beats-per-chord", type=int, default=0,
                    help="0 = spread the progression over the piece")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="texture prior std scale")
    ap.add_argument("--bpm", type=float, default=80.0)
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

    symbols = split_progression(args.chords)
    n_windows = max(1, args.bars // 2)
    beats_per_window = cfg.chord.num_step
    total_beats = n_windows * beats_per_window
    table = progression_to_chord_table(
        symbols, total_beats,
        args.beats_per_chord or max(1, total_beats // len(symbols)))
    windows = table.reshape(n_windows, beats_per_window, 14)
    c = torch.as_tensor(batch_expand_chord(windows, np.zeros(n_windows)),
                        dtype=torch.float32, device=device)
    dist_chd = dv.encode_chord(sampler.params, cfg, c)
    dist_rhy = None
    if args.texture_from:
        pm, tc = window_features(
            *texture_windows(args.texture_from, n_windows), spec, device)
        _, dist_rhy = sampler.encode(pm, tc)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    tracks, names = [], []
    for s in range(args.samples):
        if dist_rhy is not None:
            z_rhy = (dist_rhy.rsample(gen) if args.samples > 1
                     else dist_rhy.mean)
        else:
            z_rhy = torch.randn((n_windows, cfg.txt_z_dim), generator=gen,
                                device=device) * args.scale
        z_chd = (dist_chd.mean if args.texture_from or args.samples == 1
                 else dist_chd.rsample(gen))
        grids = sampler.decode(z_chd, z_rhy)
        tracks.append([dm.grid_to_pr_and_notes(g, bpm=args.bpm,
                                               spec=spec)[1] for g in grids])
        names.append(f"sample_{s}" if args.samples > 1 else "generated")

    dm.write_demo(args.out, tracks, names, bpm=args.bpm, shift_beat=8)
    total_notes = sum(len(n) for t in tracks for n in t)
    print(f"wrote {args.out}: {args.samples} track(s) x {args.bars} bars, "
          f"{total_notes} notes, progression {' '.join(symbols)}")
    return args.out


if __name__ == "__main__":
    main()
