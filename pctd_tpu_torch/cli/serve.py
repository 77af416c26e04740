"""Serving daemon (the port's counterpart of the JAX package's
``scripts/serve.py``): the four latent-control workflows as a long-running
JSON-lines service on the card.

A request enters as MIDI and leaves as MIDI:

    MIDI file -> ingest (quantize, beat table, chord estimation)
              -> 2-bar windows -> tensorize on the serving device
              -> Sampler workflow (K4, or K3 with --frame-decoder pallas)
              -> grids -> notes -> MIDI file

The process loads a checkpoint once, builds one
``Sampler(fixed_batch=N)`` (a request's rows go in N-row chunks, the last
padded with zero rows; on the card each chunk's encode is one CUDA-graph
replay, and through K4 a request's chunks share decode launches, as many a
launch as the card decodes at once) and answers requests on stdin, one
JSON object a line, on stdout:

    {"op": "ping"}
    {"op": "style_transfer", "content": "a.mid", "style": "b.mid",
     "out": "out.mid", "fix": "chord"}          # fix: chord | texture
    {"op": "variation", "input": "a.mid", "out": "v.mid", "scale": 0.5,
     "seed": 3}                                  # posterior sampling
    {"op": "prior", "input": "a.mid", "out": "p.mid",
     "sample": "texture", "seed": 0}             # texture | chord | both
    {"op": "interp", "a": "a.mid", "b": "b.mid", "out": "i_%02d.mid",
     "count": 5, "what": "chord"}                # chord | texture | both
    {"op": "reload", "checkpoint": "path"}       # new weights, same shapes
    {"op": "stats"}                              # per-op latency summary
    {"op": "quit"}

Replies: {"ok": true, "out": ..., "windows": N, "ms": T} or
{"ok": false, "error": "..."}. The loop survives malformed lines (bad JSON,
non-object payloads, missing files, a checkpoint of other widths): each
gets an ok:false reply. A request's ``seed`` seeds a ``torch.Generator`` on
the serving device.

Checkpoints are the port's own (``pctd_tpu_torch.cli.train``); the served
widths are the checkpoint's, decoded in float32. ``--frame-decoder``:
``auto`` and ``pallas_full`` serve through K4 (``Sampler`` route
``"full"``), ``pallas`` through K3 (``"frame"``); ``xla`` is refused, since
the plain versions are not a serving route on the card. A kernel that fails
raises: there is no chain that degrades to another decoder.
``--data-parallel`` splits each chunk's rows over every visible card
(``Sampler(mesh=make_mesh())``; ``--fixed-batch`` a multiple of the card
count), as the JAX daemon's flag does; the ``ready`` line names the device
count. The JAX daemon's ``--aot-dir``/``--export-aot`` (serialized XLA
executables; the port's kernels are built once from source) and
``--platform`` (here ``--device``) are not ported.

Usage:
    python -m pctd_tpu_torch.cli.serve --checkpoint <run>/models/disvae_final \\
        [--fixed-batch 16] [--max-windows 64] [--frame-decoder auto]
    python -m pctd_tpu_torch.cli.serve --tiny --device cpu   # plain, CPU
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import Optional, Sequence, TextIO

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig, tiny_model_config
from pctd_tpu_torch.data import demo as dm
from pctd_tpu_torch.data.songs import midi_to_windows
from pctd_tpu_torch.data.tensorize import window_features
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.parallel.mesh import make_mesh
from pctd_tpu_torch.train import checkpoint
from pctd_tpu_torch.utils.device import resolve_device

#: the JAX daemon's ``--frame-decoder`` choices -> the Sampler's route
FRAME_DECODERS = {"auto": "full", "pallas_full": "full", "pallas": "frame"}


def write_grids(path: str, grids, bpm: float, spec) -> int:
    """Decoded grids -> one-track MIDI at ``path``, a window every 8 beats;
    returns the number of notes."""
    segments = [dm.grid_to_pr_and_notes(np.asarray(g), bpm=bpm,
                                        spec=spec)[1] for g in grids]
    dm.write_demo(path, [segments], ["generated"], bpm=bpm, shift_beat=8)
    return sum(len(s) for s in segments if s)


def _percentile(sorted_ms, q):
    if not sorted_ms:
        return None
    i = min(len(sorted_ms) - 1, int(round(q * (len(sorted_ms) - 1))))
    return round(sorted_ms[i], 1)


class Server:
    def __init__(self, sampler: Sampler, spec, max_windows: int = 64,
                 cfg: Optional[ModelConfig] = None):
        self.s = sampler
        self.spec = spec
        self.max_windows = max_windows
        self.cfg = cfg
        self.latencies = {}          # op -> [ms, ...]

    def record(self, op: str, ms: float):
        self.latencies.setdefault(op or "?", []).append(ms)

    def stats(self) -> dict:
        out = {}
        for op, ms in self.latencies.items():
            s = sorted(ms)
            out[op] = {"count": len(s),
                       "p50_ms": _percentile(s, 0.50),
                       "p90_ms": _percentile(s, 0.90),
                       "p99_ms": _percentile(s, 0.99),
                       "max_ms": round(s[-1], 1)}
        return out

    def reload(self, path: str) -> None:
        """Serve the weights of the checkpoint at ``path``: every leaf's
        name, shape and dtype is checked against the served weights before
        anything is swapped, and the new weights are folded again
        (``Sampler.load_params``)."""
        saved = checkpoint.load_state(path)
        self.s.load_params(checkpoint.params_of(saved, self.s.device))

    def _load(self, path):
        pr, _, chord, bpm = midi_to_windows(path, self.max_windows)
        pr_mat, c = window_features(pr, chord, self.spec, self.s.device)
        return pr_mat, c, bpm

    def _generator(self, req: dict) -> torch.Generator:
        return torch.Generator(device=self.s.device).manual_seed(
            int(req.get("seed", 0)))

    def handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "stats":
            return {"ok": True, "stats": self.stats()}
        if op == "reload":
            self.reload(req["checkpoint"])
            return {"ok": True, "reloaded": req["checkpoint"]}
        if op == "style_transfer":
            pm1, c1, bpm = self._load(req["content"])
            pm2, c2, _ = self._load(req["style"])
            n = min(len(pm1), len(pm2))
            fix_chd = req.get("fix", "chord") == "chord"
            est = self.s.swap(pm1[:n], pm2[:n], c1[:n], c2[:n],
                              fix_rhy=not fix_chd, fix_chd=fix_chd)
            notes = write_grids(req["out"], est, bpm, self.spec)
            return {"ok": True, "out": req["out"], "windows": int(n),
                    "notes": int(notes)}
        if op == "variation":
            pm, c, bpm = self._load(req["input"])
            est = self.s.posterior_sample(self._generator(req), pm, c,
                                          scale=req.get("scale"))
            notes = write_grids(req["out"], est, bpm, self.spec)
            return {"ok": True, "out": req["out"], "windows": len(pm),
                    "notes": int(notes)}
        if op == "prior":
            pm, c, bpm = self._load(req["input"])
            what = req.get("sample", "texture")
            est = self.s.prior_sample(self._generator(req), pm, c,
                                      sample_chd=what in ("chord", "both"),
                                      sample_rhy=what in ("texture", "both"),
                                      scale=float(req.get("scale", 1.0)))
            notes = write_grids(req["out"], est, bpm, self.spec)
            return {"ok": True, "out": req["out"], "windows": len(pm),
                    "notes": int(notes)}
        if op == "interp":
            pm1, c1, bpm = self._load(req["a"])
            pm2, c2, _ = self._load(req["b"])
            n = min(len(pm1), len(pm2))
            count = int(req.get("count", 5))
            what = req.get("what", "chord")
            est = self.s.interp(pm1[:n], c1[:n], pm2[:n], c2[:n],
                                interp_chd=what in ("chord", "both"),
                                interp_rhy=what in ("texture", "both"),
                                int_count=count)
            outs = []
            # %-format only with an integer spec (%d, %03i, ...); a literal
            # '%' in the path takes the '.j.mid' suffix instead
            has_int_spec = re.search(r"%[-+ #0]*\d*[di]", req["out"])
            for j in range(count):
                out = req["out"] % j if has_int_spec else \
                    f"{req['out']}.{j}.mid"
                write_grids(out, est[:, j], bpm, self.spec)
                outs.append(out)
            return {"ok": True, "out": outs, "windows": int(n)}
        raise ValueError(f"unknown op {op!r}")


def serve_lines(server: Server, lines, out: TextIO) -> None:
    """Answer each request line on ``out`` until ``quit`` or the end of
    ``lines``; a line that fails gets an ok:false reply."""
    for line in lines:
        line = line.strip()
        if not line:
            continue
        t0 = time.perf_counter()
        op = None
        try:
            req = json.loads(line)
            op = req.get("op") if isinstance(req, dict) else None
            if op == "quit":
                print(json.dumps({"ok": True, "bye": True}), file=out,
                      flush=True)
                break
            resp = server.handle(req)
        except Exception as e:                      # serve loop must survive
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        ms = (time.perf_counter() - t0) * 1e3
        server.record(op, ms)
        resp["ms"] = round(ms, 1)
        print(json.dumps(resp), file=out, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--fixed-batch", type=int, default=16,
                    help="rows a chunk: a request's rows go in chunks of "
                         "it, the last padded with zero rows; on the card a "
                         "chunk's encode is one graph replay, and through "
                         "K4 the chunks of a request share launches up to "
                         "what the card decodes at once")
    ap.add_argument("--max-windows", type=int, default=64)
    ap.add_argument("--frame-decoder", default="auto",
                    choices=["auto", "xla", "pallas", "pallas_full"],
                    help="auto and pallas_full: K4; pallas: K3; xla is "
                         "refused (no plain serving route on the card)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="split request rows over every visible device")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model dims (smoke runs, untrained)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None,
         model_config: Optional[ModelConfig] = None,
         stdin: Optional[TextIO] = None,
         stdout: Optional[TextIO] = None) -> None:
    """Serve as the flags say; ``model_config`` replaces the widths of a
    fresh model (``--tiny``'s or the canonical ones)."""
    args = parser().parse_args(argv)
    out = stdout or sys.stdout
    if args.frame_decoder not in FRAME_DECODERS:
        raise SystemExit(f"--frame-decoder {args.frame_decoder}: the plain "
                         "versions are not a serving route on the card; use "
                         "auto, pallas_full (K4) or pallas (K3)")
    device = resolve_device(args.device)
    cfg = model_config or (tiny_model_config() if args.tiny
                           else ModelConfig())
    params, cfg = checkpoint.load_model(args.checkpoint, cfg, args.seed,
                                        device)
    if args.checkpoint:
        print(json.dumps({"loaded": args.checkpoint}), file=out, flush=True)
    else:
        print(json.dumps({"warning": "no checkpoint - untrained model"}),
              file=out, flush=True)
    route = FRAME_DECODERS[args.frame_decoder]
    mesh = make_mesh(device_type=device.type) if args.data_parallel \
        else None
    sampler = Sampler(params, cfg, frame_decoder=route,
                      fixed_batch=args.fixed_batch,
                      device=None if mesh else device, mesh=mesh)
    server = Server(sampler, cfg.pianotree, args.max_windows, cfg=cfg)
    print(json.dumps({"ready": True, "fixed_batch": args.fixed_batch,
                      "device": str(sampler.device),
                      "devices": len(sampler.devices),
                      "frame_decoder": route}), file=out, flush=True)
    serve_lines(server, stdin or sys.stdin, out)


if __name__ == "__main__":
    main()
