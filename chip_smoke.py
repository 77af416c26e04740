"""Chip smoke test of the pctd_tpu_torch serving and training paths on one
CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version on the card: the decode kernels K3 and
K4, the train-frame forward K1 and its backward K2 (K2a, the per-row chain,
and K2b, the weight-gradient reduction), K1 and K2a in both their modes
(CE fused in, and logits out). Then it serves the four latent-control
workflows through ``Sampler(fixed_batch=128)`` and trains the model for a
few steps through ``Trainer`` at B=128 in each loss mode
(``ModelConfig.fused_loss`` True, then False), all at the canonical model
width (random weights from ``--seed``), and shows that each path went
through its kernels. Prints one line per phase with its seconds,
a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result,
without a CUDA card or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig, TrainConfig
from pctd_tpu_torch.data.loaders import SegmentCorpus, make_loaders
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models import pianotree_decoder as ptd
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.kernels import ar_decoder, build, full_decoder
from pctd_tpu_torch.ops.kernels import train_frame as tf
from pctd_tpu_torch.train import trainer as tr
from pctd_tpu_torch.train.optim import global_norm

#: H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
AGREE = 0.999          # discrete outputs, kernel vs plain
SUMMARY_ATOL = 1e-4    # K3 summary on rows whose discrete outputs agree
SIZES = (1, 37, 128, 300)
NUMS_RTOL = 1e-5       # K1 CE numerators vs plain
STATE_ATOL = 1e-4      # K1 summary and note hiddens vs plain
GRAD_TOL = 1e-4        # K2 grads vs autograd of plain: x (1 + max|plain|)
LOSS_RTOL = 1e-5       # train step 1, kernels vs plain path on the card
NORM_RTOL = 1e-4       # its gradient global norm
MODES_RTOL = 1e-5      # step 1's metrics, logits out vs CE fused in
CORE_TOL = 1e-4        # K1 logits out: logits, summary x (1 + max|plain|)
TRAIN_STEPS = 6
LOGITS_STEPS = 3       # train steps with logits out
TURNS = 4              # timed train steps of each loss mode, in turns
HOST_OPS = 8           # host ops listed by self time in a profiled step
TRAIN_B = 128


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def requests(rng: np.random.RandomState, B: int):
    """Synthetic (pr_mat (B, 32, 128), chord (B, 8, 36)): sparse onsets with
    durations 1..8, and root one-hot | chroma | bass one-hot chords."""
    pr = np.zeros((B, 32, 128), np.float32)
    on = rng.rand(B, 32, 128) < 0.02
    pr[on] = rng.randint(1, 9, on.sum())
    c = np.zeros((B, 8, 36), np.float32)
    rows, steps = np.arange(B)[:, None], np.arange(8)[None, :]
    c[rows, steps, rng.randint(0, 12, (B, 8))] = 1.0
    c[..., 12:24] = rng.randint(0, 2, (B, 8, 12))
    c[rows, steps, 24 + rng.randint(0, 12, (B, 8))] = 1.0
    return pr, c


def cuda_ms(fn, n: int) -> float:
    """Mean ms of ``fn`` over ``n`` runs after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def frame_work(fw, spec, B: int):
    """(FLOPs, bytes) K3 must do and move for B rows: the products of one
    frame (gates and row selects are a few % more, not counted) and each
    weight, input and output once."""
    d = build.decoder_dims(fw, spec)
    SL, DC = d.P + d.DH + 2 + 3 * d.DH, 2 + 3 * d.DH
    macs = (d.TH * 4 * d.NH + d.K * d.NH * 3 * d.NH
            + (d.K - 1) * (d.NH * SL + d.W * d.DH * DC)
            + d.K * 2 * (d.E + d.EH) * 3 * d.EH)
    weights = sum(t.numel() for n, t in zip(fw._fields, fw)
                  if n not in ("wt_tok", "wt_hh", "bt_hh"))
    io = d.TH + d.E + (d.K - 1) * (1 + d.W) + 2 * d.EH + 1
    return 2.0 * macs * B, 4.0 * (weights + io * B)


def full_work(fw, spec, B: int):
    """(FLOPs, bytes) K4 must do and move for B rows over T frames."""
    d = build.decoder_dims(fw, spec)
    f_flops, _ = frame_work(fw, spec, B)
    t_flops = 2.0 * B * (2 * d.EH + d.TH) * 3 * d.TH
    weights = sum(t.numel() for t in fw)
    io = d.TH + 3 * d.TH + 2 * d.EH + d.E + d.T * (d.K - 1) * (1 + d.W)
    return d.T * (f_flops + t_flops), 4.0 * (weights + io * B)


def bound_ms(flops: float, nbytes: float):
    f, b = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f, "operations") if f >= b else (b, "bytes")


def segments(rng: np.random.RandomState, n: int) -> SegmentCorpus:
    """Synthetic raw segments in the loader's format: uint8 onset (2) /
    sustain (1) / rest (0) rolls and raw [root, chroma, bass] chord rows."""
    pr = np.zeros((n, 32, 128), np.uint8)
    pr[rng.rand(n, 32, 128) < 0.03] = 2
    for step in range(1, 32):
        held = ((pr[:, step - 1] > 0) & (pr[:, step] == 0)
                & (rng.rand(n, 128) < 0.6))
        pr[:, step][held] = 1
    chord = np.zeros((n, 8, 14), np.float32)
    chord[..., 0] = rng.randint(0, 12, (n, 8))
    chord[..., 1:13] = rng.randint(0, 2, (n, 8, 12))
    chord[..., 13] = rng.randint(0, 12, (n, 8))
    return SegmentCorpus(pr, chord)


def frame_case(params, cfg, B: int, gen: torch.Generator):
    """Train-frame weights and one frame's inputs at the shapes of the
    training path: time hidden, ground-truth note embeddings, teacher coins
    and integer targets (pads included)."""
    spec = cfg.pianotree
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    dev = gen.device
    rn = lambda *s: torch.randn(s, device=dev, generator=gen)
    ri = lambda hi, *s: torch.randint(0, hi, s, device=dev, generator=gen,
                                      dtype=torch.int32)
    cw = tf.CoreWeights(*(w.detach().contiguous()
                          for w in tf.core_weights(params["dec"], cfg)))
    return cw, dict(frame_h=rn(B, cfg.dec_time_hidden) * 0.6,
                    x_emb=rn(B, K, cfg.note_emb_size) * 0.5,
                    coins=ri(2, K - 1), gt_pitch=ri(P + 1, B, K - 1),
                    gt_dur=ri(3, B, K - 1, W))


def k1_rows(cw, spec, inp):
    """K1 (with its stash) and the plain version on ``inp``; the rows whose
    pitch, dur bits and lengths agree."""
    got = tf.frame_fwd(cw, spec, **inp, stash=True)
    want = tf.frame_recon_plain(cw, spec, **inp)
    dec = torch.cat([want.pitch[..., None], want.bits], -1)
    rows = (got[3] == dec).flatten(1).all(1) & (got[2] == want.lengths)
    return rows, got, want


def k2_grads(cw, spec, inp, g_nums, g_summ, plain: bool):
    """Gradients of sum(g_nums * nums) + sum(g_summ * summary) with respect to
    the 24 weights, frame_h and x_emb: through K1/K2 or autograd of the plain
    version."""
    leaves = [w.clone().requires_grad_(True) for w in cw]
    fh = inp["frame_h"].clone().requires_grad_(True)
    xe = inp["x_emb"].clone().requires_grad_(True)
    args = (tf.CoreWeights(*leaves), spec, fh, xe, inp["coins"],
            inp["gt_pitch"], inp["gt_dur"])
    if plain:
        out = tf.frame_recon_plain(*args)
        nums, summ = out.nums, out.summary
    else:
        nums, summ = tf.frame_recon(*args)
    ((nums * g_nums).sum() + (summ * g_summ).sum()).backward()
    return [w.grad for w in leaves] + [fh.grad, xe.grad]


def core_inputs(inp):
    """The logits-out frame's inputs of a :func:`frame_case` (no targets)."""
    return {k: inp[k] for k in ("frame_h", "x_emb", "coins")}


def core_decisions(pitch, dur):
    """(B, K-1, 1+W) int32 [pitch argmax | dur bits] of logits."""
    return torch.cat([pitch.argmax(-1, keepdim=True).to(torch.int32),
                      (dur[..., 1] > dur[..., 0]).to(torch.int32)], -1)


def core_grads(cw, spec, inp, cots, plain: bool):
    """Gradients of the logits-out frame's outputs contracted with ``cots``
    (d_pitch, d_dur, d_summ) with respect to the 24 weights, frame_h and
    x_emb: through K1/K2 or autograd of the plain version."""
    leaves = [w.clone().requires_grad_(True) for w in cw]
    fh = inp["frame_h"].clone().requires_grad_(True)
    xe = inp["x_emb"].clone().requires_grad_(True)
    fn = tf.frame_core_plain if plain else tf.frame_core
    out = fn(tf.CoreWeights(*leaves), spec, fh, xe, inp["coins"])
    sum((o * g).sum() for o, g in zip(out[:3], cots)).backward()
    return [w.grad for w in leaves] + [fh.grad, xe.grad]


@contextlib.contextmanager
def plain_frames():
    """Inside this context the decoder's teacher-forced frames run
    ``frame_recon_plain`` and ``frame_core_plain`` on the card (autograd of
    them for gradients), for the plain reference of a train step; the
    kernel routes are restored on exit."""
    kernel_routes = (ptd.train_frame.frame_recon, ptd.train_frame.frame_core)

    def plain(*args):
        out = tf.frame_recon_plain(*args)
        return out.nums, out.summary

    ptd.train_frame.frame_recon = plain
    ptd.train_frame.frame_core = tf.frame_core_plain
    try:
        yield
    finally:
        ptd.train_frame.frame_recon, ptd.train_frame.frame_core = \
            kernel_routes


def train_frame_work(cw, spec, B: int, logits: bool = False):
    """(FLOPs, bytes) of K1 (with its stash) and K2a for B rows of one frame,
    in loss mode or with ``logits`` out: their products (gates and selects
    are a few % more, not counted), each weight read once, each input and
    output (stash, cotangents; targets or logits and their cotangents)
    once."""
    d = tf.dims_of(cw, spec)
    S, W = d.K - 1, d.W
    slot = (d.E * 3 * d.NH + d.NH * 3 * d.NH + d.NH * d.P
            + (d.NH + d.P) * d.DH + W * d.DH * 3 * d.DH + W * d.DH * 2)
    summ = d.K * 2 * (d.E + d.EH) * 3 * d.EH
    frame = d.TH * 4 * d.NH
    k1_macs = frame + S * slot + summ       # S hidden-gate products: h0..h14
    k2_macs = frame + S * (slot + W * 3 * d.DH) + summ
    weights = sum(w.numel() for w in cw)
    stash = sum(t.numel() for t in tf.new_stash(d, 1, "meta"))
    cots = sum(t.numel() for t in tf.new_cotangents(d, 1, "meta"))
    k1_io = (d.TH + d.K * d.E + S * (1 + W)                  # inputs
             + (1 + W) + 2 * d.EH + 1 + S * (1 + W))          # outputs
    k2_io = stash + cots + d.TH + d.K * d.E + 2 * d.EH + S * (1 + W) + 1
    if logits:      # no targets or numerators: logits out, their cotangents
        k1_io = (d.TH + d.K * d.E
                 + S * (d.P + 2 * W) + 2 * d.EH + 1 + S * (1 + W))
        k2_io = (stash + cots + d.TH + d.K * d.E + 2 * d.EH
                 + S * (d.P + 2 * W) + 1)
    return ((2.0 * k1_macs * B, 4.0 * (weights + (k1_io + stash) * B)),
            (2.0 * k2_macs * B, 4.0 * (weights + k2_io * B)))


def wgrad_work(tasks):
    """(FLOPs, bytes) of K2b: 2 N I O (+ N O adds for a bias) a task, each
    operand read and each gradient written once."""
    flops = sum((2.0 * t.I + (1 if t.gb.numel() else 0)) * t.N * t.O
                for t in tasks)
    nbytes = sum(4.0 * (t.N * (t.I + t.O) + (t.I + 1) * t.O) for t in tasks)
    return flops, nbytes


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()


def plain_backward_ms(cw, spec, inp, cots, n: int,
                      logits: bool = False) -> float:
    """Mean ms of the autograd backward of the plain frame version (K2's
    plain version) in loss mode, its outputs contracted with ``cots`` =
    (d_nums, d_summ), or with ``logits`` out, (d_pitch, d_dur, d_summ); CUDA
    events around each backward only."""
    total = 0.0
    for i in range(n + 1):
        leaves = tf.CoreWeights(*(w.clone().requires_grad_(True)
                                  for w in cw))
        if logits:
            out = tf.frame_core_plain(leaves, spec, **core_inputs(inp))[:3]
        else:
            out = tf.frame_recon_plain(leaves, spec, **inp)[:2]
        loss = sum((o * g).sum() for o, g in zip(out, cots))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss.backward()
        e1.record()
        torch.cuda.synchronize()
        if i:                                   # the first one warms up
            total += e0.elapsed_time(e1)
    return total / n


def optimizer_ms(trainer, n: int) -> float:
    """Mean ms of one clip + Adam step over every parameter (on copies)."""
    from pctd_tpu_torch.train.optim import Adam

    leaves = [t.detach().clone() for t in trainer.leaves]
    grads = [torch.randn_like(t) for t in leaves]
    opt = Adam(leaves, trainer.tcfg)
    return cuda_ms(lambda: opt.step(grads), n)


def profile_step(trainer) -> dict:
    """Device time of one train step by kernel group, from torch.profiler:
    the train-frame kernels, cuBLAS/CUTLASS products (time GRU, encoders,
    chord decoder, heads) and the other PyTorch kernels (gates, losses,
    tensorize, optimizer); and the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = next(trainer.batches())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - s0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("  profiler: no device events; breakdown not measured")
        return {"measured": False}
    groups = {"K1": 0.0, "K2a": 0.0, "K2b": 0.0, "gemm": 0.0, "other": 0.0}
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        n = e.name
        key = ("K1" if "train_fwd_kernel" in n else
               "K2a" if "train_bwd_kernel" in n else
               "K2b" if "wgrad_kernel" in n else
               "gemm" if re.search(r"gemm|cutlass|cublas", n, re.I) else
               "other")
        groups[key] += us
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    ms = {k: v / 1e3 for k, v in groups.items()}
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:HOST_OPS]
    host_ms = {e.key: e.self_cpu_time_total / 1e3 for e in host}
    out = {"measured": True, "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us, "kernel_ms": ms,
           "host_self_ms_top": host_ms}
    print(f"  profiled step: {wall_us / 1e3:.2f} ms wall (profiler on), "
          f"device busy {busy / 1e3:.2f} ms, idle share "
          f"{out['idle_share']:.3f}; device ms by group "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    print("  host self time by op (profiler on), top: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in host_ms.items()))
    return out


def eos_variant(params, cfg, fw_of, h, sos):
    """Copy of ``params`` whose pitch head emits eos, so frame lengths
    spread over 1..15 and the masked summary is exercised (random weights
    never emit eos, and a bias alone ends frames at slot 1 or never): the
    eos weight column scaled by 3, plus the bias offset whose K3 length
    histogram on ``h`` has the most distinct values."""
    eos = cfg.pianotree.pitch_eos
    best = None
    for off in (-0.2, 0.0, 0.1, 0.2):
        q = copy.deepcopy(params)
        q["dec"]["pitch_out"]["w"][:, eos] *= 3.0
        q["dec"]["pitch_out"]["b"][eos] += off
        lens = ar_decoder.frame_decode_plain(fw_of(q), cfg.pianotree, h,
                                             sos)[3]
        hist = torch.bincount(lens.long(), minlength=16).tolist()
        print(f"  eos column x3, bias {off:+}: length histogram {hist}")
        key = sum(1 for x in hist if x)
        if best is None or key > best[0]:
            best = (key, off, q)
    print(f"  eos-biased variant: bias {best[1]:+}")
    return best[2]


def agreement(a, b) -> float:
    return (a == b).float().mean().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card",
              file=sys.stderr)
        return 2
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full f32 (no TF32)")
    dev = torch.device("cuda")
    cfg = ModelConfig()
    spec = cfg.pianotree
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)

    # 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no answer"
    print(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {kind} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    phase("device", t0)

    # 2. build
    t0 = time.perf_counter()
    _, log = build.build()
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("  " + line.strip())
    lib = build.library()
    phase("build", t0)

    # 3. weights
    t0 = time.perf_counter()
    params = dv.init_params(cfg, seed=args.seed, device=dev)
    fw_of = lambda p: ar_decoder.folded_frame_weights(p["dec"], cfg)
    fw = fw_of(params)
    dims = build.decoder_dims(fw, spec)
    wst = build.DecoderWeightsC(*(t.data_ptr() for t in fw), *dims)
    cw0 = tf.core_weights(params["dec"], cfg)
    tw = build.train_weights(cw0, tf.dims_of(cw0, spec))
    for r in (1, 2, 4):
        print(f"  shared memory, {r} row(s) a block: K3/K4 "
              f"{lib.pctd_smem_bytes(ctypes.byref(wst), r)} B, K1 "
              f"{lib.pctd_train_smem_bytes(ctypes.byref(tw), r, 0)} B, K2a "
              f"{lib.pctd_train_smem_bytes(ctypes.byref(tw), r, 1)} B")
    h_probe = torch.randn(128, cfg.dec_time_hidden, device=dev,
                          generator=gen) * 0.6
    sos_probe = ptd.decode_inputs(
        params["dec"], cfg, torch.zeros(128, cfg.z_dim, device=dev)).sos_emb
    biased = eos_variant(params, cfg, fw_of, h_probe, sos_probe)
    weight_sets = {"seed": (params, fw), "eos_biased": (biased,
                                                        fw_of(biased))}
    phase("weights", t0)

    # 4. K3 vs its plain version
    t0 = time.perf_counter()
    k3_err, k3_agree = 0.0, 1.0
    for wname, (p, w) in weight_sets.items():
        for B in (128, 37):
            h = torch.randn(B, cfg.dec_time_hidden, device=dev,
                            generator=gen) * 0.6
            sos = sos_probe[:B].contiguous()
            got = ar_decoder.frame_decode(w, spec, h, sos)
            want = ar_decoder.frame_decode_plain(w, spec, h, sos)
            torch.cuda.synchronize()
            ag = [agreement(got[i], want[i]) for i in (0, 1, 3)]
            rows = ((got[0] == want[0]).all(1) & (got[1] == want[1])
                    .flatten(1).all(1) & (got[3] == want[3]))
            err = (got[2] - want[2]).abs()[rows].max().item() \
                if rows.any() else float("inf")
            hist = torch.bincount(got[3].long(), minlength=16).tolist()
            print(f"  K3 {wname} B={B}: agreement pitch/dur/len {ag}, "
                  f"summary max|err| {err:.3g} on {int(rows.sum())} rows; "
                  f"lengths {hist}")
            check(min(ag) >= AGREE, f"K3 {wname} B={B} agreement {ag}")
            check(err <= SUMMARY_ATOL, f"K3 {wname} B={B} summary {err}")
            k3_err, k3_agree = max(k3_err, err), min(k3_agree, min(ag))
    phase("K3 vs plain", t0)

    # 5. K4 vs its plain version
    t0 = time.perf_counter()
    k4_err, k4_agree = 0, 1.0
    for wname, (p, w) in weight_sets.items():
        for B in (128, 512):
            z = torch.randn(B, cfg.z_dim, device=dev, generator=gen)
            inputs = ptd.decode_inputs(p["dec"], cfg, z)
            got = full_decoder.decode_grid_full(w, spec, *inputs)
            want = full_decoder.decode_grid_full_plain(w, spec, *inputs)
            torch.cuda.synchronize()
            ag = agreement(got, want)
            err = (got - want).abs().max().item()
            eos = got[..., 0] == spec.pitch_eos
            lens = torch.where(eos.any(-1), eos.int().argmax(-1) + 1,
                               spec.max_simu_note - 1)
            hist = torch.bincount(lens.flatten().long(),
                                  minlength=16).tolist()
            print(f"  K4 {wname} B={B}: grid agreement {ag:.6f}, "
                  f"max|err| {err}; frame lengths {hist}")
            check(ag >= AGREE, f"K4 {wname} B={B} agreement {ag}")
            k4_err, k4_agree = max(k4_err, err), min(k4_agree, ag)
    phase("K4 vs plain", t0)

    # 6. K1 vs its plain version
    t0 = time.perf_counter()
    k1_err, k1_agree = 0.0, 1.0
    for wname, (p, _) in weight_sets.items():
        for B in (128, 37):
            cw, inp = frame_case(p, cfg, B, gen)
            with torch.no_grad():
                rows, got, want = k1_rows(cw, spec, inp)
                torch.cuda.synchronize()
                ag = rows.float().mean().item()
                check(ag >= AGREE, f"K1 {wname} B={B} decisions {ag}")
                summ = (got[1] - want.summary).abs()[rows].max().item()
                hs = (got[4].hs - want.hs).abs()[:, rows].max().item()
                sub = {k: (v if k == "coins" else v[rows])
                       for k, v in inp.items()}
                nums = rel_err(tf.frame_fwd(cw, spec, **sub, stash=False)[0],
                               tf.frame_recon_plain(cw, spec, **sub).nums)
            hist = torch.bincount(got[2].long(), minlength=16).tolist()
            print(f"  K1 {wname} B={B}: decisions agree on {ag:.6f} of "
                  f"rows; on those nums rel err {nums:.3g}, summary "
                  f"max|err| {summ:.3g}, hs max|err| {hs:.3g}; lengths "
                  f"{hist}")
            check(nums <= NUMS_RTOL, f"K1 {wname} B={B} nums {nums}")
            check(max(summ, hs) <= STATE_ATOL,
                  f"K1 {wname} B={B} summary/hs {summ} {hs}")
            k1_err = max(k1_err, summ, hs)
            k1_agree = min(k1_agree, ag)
    phase("K1 vs plain", t0)

    # 7. K2 (K2a chain + K2b weight grads) vs autograd of the plain version
    t0 = time.perf_counter()
    k2a_err = k2b_err = 0.0
    for wname, (p, _) in weight_sets.items():
        B = 128
        cw, inp = frame_case(p, cfg, B, gen)
        with torch.no_grad():
            rows = k1_rows(cw, spec, inp)[0]
        if not rows.all():
            print(f"  K2 {wname}: K1 and plain decisions differ on "
                  f"{int((~rows).sum())} of {B} rows; held on the others")
        inp = {k: (v if k == "coins" else v[rows]) for k, v in inp.items()}
        g_nums = torch.rand(1 + spec.dur_width, device=dev, generator=gen)
        g_summ = torch.randn(int(rows.sum()), 2 * cfg.dec_emb_hidden,
                             device=dev, generator=gen)
        got = k2_grads(cw, spec, inp, g_nums, g_summ, plain=False)
        want = k2_grads(cw, spec, inp, g_nums, g_summ, plain=True)
        torch.cuda.synchronize()
        names = list(tf.CoreWeights._fields) + ["d_frame_h", "d_x_emb"]
        worst = []
        for name, a, b in zip(names, got, want):
            err = (a - b).abs().max().item()
            tol = GRAD_TOL * (1.0 + b.abs().max().item())
            check(err <= tol, f"K2 {wname} {name}: max|err| {err} > {tol}")
            worst.append((err / tol, name, err))
            if name.startswith("d_"):
                k2a_err = max(k2a_err, err)
            else:
                k2b_err = max(k2b_err, err)
        top = sorted(worst, reverse=True)[:3]
        print(f"  K2 {wname} B={int(rows.sum())}: all 26 gradients within "
              f"tolerance; closest to it: "
              + ", ".join(f"{n} {e:.3g} ({r:.2f} of tol)" for r, n, e in top))
    phase("K2 vs autograd of plain", t0)

    # 7b. K1 in logits-out mode vs its plain version
    t0 = time.perf_counter()
    k1l_err = 0.0
    for wname, (p, _) in weight_sets.items():
        for B in (128, 37):
            cw, inp = frame_case(p, cfg, B, gen)
            with torch.no_grad():
                pitch, dur, summ, lens, decisions, _ = tf.frame_core_fwd(
                    cw, spec, **core_inputs(inp), stash=False)
                want = tf.frame_core_plain(cw, spec, **core_inputs(inp))
            torch.cuda.synchronize()
            plain_dec = core_decisions(want.pitch_logits, want.dur_logits)
            bad = int((decisions != plain_dec).flatten(1).any(1).sum())
            check(bad == 0, f"K1 logits out {wname} B={B}: decisions differ "
                  f"from the plain version's on {bad} rows")
            check(torch.equal(lens, want.lengths),
                  f"K1 logits out {wname} B={B}: lengths differ")
            check(torch.equal(core_decisions(pitch, dur), decisions),
                  f"K1 logits out {wname} B={B}: the logits' argmaxes "
                  "differ from the kernel's decisions")
            errs = []
            for name, a, b in (("pitch", pitch, want.pitch_logits),
                               ("dur", dur, want.dur_logits),
                               ("summary", summ, want.summary)):
                err = (a - b).abs().max().item()
                tol = CORE_TOL * (1.0 + b.abs().max().item())
                check(err <= tol, f"K1 logits out {wname} B={B} {name}: "
                      f"max|err| {err} > {tol}")
                errs.append(f"{name} {err:.3g} ({err / tol:.2f} of tol)")
                k1l_err = max(k1l_err, err)
            hist = torch.bincount(lens.long(), minlength=16).tolist()
            print(f"  K1 logits out {wname} B={B}: decisions and lengths "
                  f"equal the plain version's on every row, and the "
                  f"logits' argmaxes; max|err| " + ", ".join(errs)
                  + f"; lengths {hist}")
    phase("K1 logits out vs plain", t0)

    # 7c. K2 in logits-out mode (K2a + K2b) vs autograd of the plain version
    t0 = time.perf_counter()
    k2al_err = k2bl_err = 0.0
    K, P = spec.max_simu_note, spec.pitch_range
    for wname, (p, _) in weight_sets.items():
        B = 128
        cw, inp = frame_case(p, cfg, B, gen)
        with torch.no_grad():
            rows = k1_rows(cw, spec, inp)[0]
        if not rows.all():
            print(f"  K2 logits out {wname}: K1 and plain decisions differ "
                  f"on {int((~rows).sum())} of {B} rows; held on the others")
        inp = {k: (v if k == "coins" else v[rows]) for k, v in inp.items()}
        n = int(rows.sum())
        cots = (torch.randn(n, K - 1, P, device=dev, generator=gen),
                torch.randn(n, K - 1, spec.dur_width, 2, device=dev,
                            generator=gen),
                torch.randn(n, 2 * cfg.dec_emb_hidden, device=dev,
                            generator=gen))
        got = core_grads(cw, spec, inp, cots, plain=False)
        want = core_grads(cw, spec, inp, cots, plain=True)
        torch.cuda.synchronize()
        names = list(tf.CoreWeights._fields) + ["d_frame_h", "d_x_emb"]
        worst = []
        for name, a, b in zip(names, got, want):
            err = (a - b).abs().max().item()
            tol = GRAD_TOL * (1.0 + b.abs().max().item())
            check(err <= tol, f"K2 logits out {wname} {name}: max|err| "
                  f"{err} > {tol}")
            worst.append((err / tol, name, err))
            if name.startswith("d_"):
                k2al_err = max(k2al_err, err)
            else:
                k2bl_err = max(k2bl_err, err)
        top = sorted(worst, reverse=True)[:3]
        print(f"  K2 logits out {wname} B={n}: all 26 gradients within "
              f"tolerance; closest to it: "
              + ", ".join(f"{n_} {e:.3g} ({r:.2f} of tol)"
                          for r, n_, e in top))
    phase("K2 logits out vs autograd of plain", t0)

    # 8. serving: the main path, counted
    t0 = time.perf_counter()
    sampler = Sampler(params, cfg, fixed_batch=128, device=dev)
    ref_pr, ref_c = requests(rng, 4)
    warm = sampler.swap(ref_pr, ref_pr, ref_c, ref_c, True, True)
    cpu = Sampler(params, cfg, device="cpu")
    ref = cpu.swap(ref_pr, ref_pr, ref_c, ref_c, True, True)
    check((warm == ref).mean() >= AGREE,
          f"card vs CPU plain decode agreement {(warm == ref).mean()}")
    print(f"  card vs CPU plain path, swap of 4: agreement "
          f"{(warm == ref).mean():.6f}")
    full_decoder.decode_grid_full.launches = 0
    ar_decoder.frame_decode.launches = 0
    workflows = {
        "swap_fix_rhy": lambda pr1, pr2, c1, c2: sampler.swap(
            pr1, pr2, c1, c2, fix_rhy=True, fix_chd=False),
        "swap_fix_chd": lambda pr1, pr2, c1, c2: sampler.swap(
            pr1, pr2, c1, c2, fix_rhy=False, fix_chd=True),
        "posterior_sample": lambda pr1, pr2, c1, c2:
            sampler.posterior_sample(gen, pr1, c1, scale=0.5),
        "prior_sample": lambda pr1, pr2, c1, c2: sampler.prior_sample(
            gen, pr1, c1, sample_rhy=True),
        "interp": lambda pr1, pr2, c1, c2: sampler.interp(
            pr1, c1, pr2, c2, interp_chd=True, int_count=5),
    }
    serving = {}
    for name, fn in workflows.items():
        for n in SIZES:
            pr1, c1 = requests(rng, n)
            pr2, c2 = requests(rng, n)
            times = []
            for _ in range(3):
                s0 = time.perf_counter()
                out = fn(pr1, pr2, c1, c2)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - s0)
            segs = n * (5 if name == "interp" else 1)
            shape = ((n, 5) if name == "interp" else (n,)) + (32, 15, 6)
            check(out.shape == shape and out.dtype == np.int32,
                  f"{name} n={n}: {out.shape} {out.dtype}")
            check(((out[..., 0] >= 0) & (out[..., 0] < spec.pitch_range))
                  .all() and np.isin(out[..., 1:], (0, 1)).all(),
                  f"{name} n={n}: grid values out of range")
            p50 = float(np.median(times)) * 1e3
            serving[f"{name}/{n}"] = {"p50_ms": p50,
                                      "segments_per_s": segs / p50 * 1e3}
            print(f"  {name} n={n}: p50 {p50:.2f} ms, "
                  f"{segs / p50 * 1e3:.1f} segments/s")
    frame_sampler = Sampler(params, cfg, frame_decoder="frame",
                            fixed_batch=128, device=dev)
    pr1, c1 = requests(rng, 128)
    s0 = time.perf_counter()
    via_k3 = frame_sampler.swap(pr1, pr1, c1, c1, True, True)
    torch.cuda.synchronize()
    k3_serve_ms = (time.perf_counter() - s0) * 1e3
    via_k4 = sampler.swap(pr1, pr1, c1, c1, True, True)
    launches = {"K4": full_decoder.decode_grid_full.launches,
                "K3": ar_decoder.frame_decode.launches}
    print(f"  frame decoder (K3) swap n=128: {k3_serve_ms:.2f} ms, agreement "
          f"with K4 {(via_k3 == via_k4).mean():.6f}; launches {launches}")
    check((via_k3 == via_k4).mean() >= AGREE, "K3 vs K4 served grids")
    check(launches["K4"] > 0 and launches["K3"] > 0,
          f"a kernel of the path was not launched: {launches}")
    phase("serving", t0)

    # 9. training: the main path, counted
    t0 = time.perf_counter()
    tcfg = TrainConfig(batch_size=TRAIN_B, accum_steps=1, seed=args.seed)
    corpora = (segments(rng, 64), segments(rng, 16))
    train_b, val_b = make_loaders(*corpora, TRAIN_B, seed=args.seed)
    trainer = tr.Trainer(cfg, tcfg, train_b, val_b, device=dev)
    # the same loader again, for the first batch the trainer will take
    first = next(make_loaders(*corpora, TRAIN_B, seed=args.seed)[0].epoch())
    x, c, pr_mat = tr.batch_features(*trainer._to_device(first), cfg)
    k1_before = tf.frame_fwd.launches
    with plain_frames():
        ref_m, ref_g = tr.loss_and_grads(
            trainer.params, cfg, tcfg, 0,
            torch.Generator(device=dev).manual_seed(tcfg.seed), x, c, pr_mat)
    check(tf.frame_fwd.launches == k1_before,
          "the plain reference step launched K1")
    ref_m = {k: v.item() for k, v in ref_m.items()}
    ref_norm = global_norm(ref_g).item()
    del ref_g
    for f in (tf.frame_fwd, tf.frame_bwd, tf.weight_grads,
              full_decoder.decode_grid_full, ar_decoder.frame_decode):
        f.launches = 0
    trainer.train_steps(TRAIN_STEPS)
    val = trainer.eval_epoch()
    torch.cuda.synchronize()
    train_launches = {"K1": tf.frame_fwd.launches,
                      "K2a": tf.frame_bwd.launches,
                      "K2b": tf.weight_grads.launches}
    n_val = len(val_b)
    print(f"  launches in {TRAIN_STEPS} train steps + {n_val} eval "
          f"batch(es): {train_launches}")
    T = spec.num_step
    check(train_launches == {"K1": T * (TRAIN_STEPS + n_val),
                             "K2a": T * TRAIN_STEPS,
                             "K2b": T * TRAIN_STEPS},
          f"train launches {train_launches}")
    check(full_decoder.decode_grid_full.launches == 0
          and ar_decoder.frame_decode.launches == 0,
          "the training path launched a decode kernel")
    for i, m in enumerate(trainer.history):
        print(f"  step {i + 1}: loss {m['loss']:.6f} recon "
              f"{m['recon_loss']:.6f} kl {m['kl_loss']:.6f} chord "
              f"{m['chord_loss']:.6f} grad norm {trainer.grad_norms[i]:.6f}"
              f" ({trainer.step_seconds[i] * 1e3:.1f} ms)")
        check(all(np.isfinite(v) for v in m.values()), f"step {i + 1} {m}")
    print(f"  val: loss {val['loss']:.6f}")
    check(all(np.isfinite(v) for v in val.values()), f"val {val}")
    step1 = trainer.history[0]
    loss_err = max(abs(step1[k] - ref_m[k]) / max(abs(ref_m[k]), 1e-30)
                   for k in dv.METRIC_NAMES)
    norm_err = abs(trainer.grad_norms[0] - ref_norm) / ref_norm
    print(f"  step 1 vs the plain path on the card: loss {step1['loss']!r}"
          f" vs {ref_m['loss']!r}, recon {step1['recon_loss']!r} vs "
          f"{ref_m['recon_loss']!r}; 11 metrics max rel err {loss_err:.3g}; "
          f"grad norm {trainer.grad_norms[0]!r} vs {ref_norm!r} "
          f"(rel err {norm_err:.3g})")
    check(loss_err <= LOSS_RTOL, f"step 1 metrics rel err {loss_err}")
    check(norm_err <= NORM_RTOL, f"step 1 grad norm rel err {norm_err}")
    step_ms = float(np.median(trainer.step_seconds[1:])) * 1e3
    training = {"step_ms_median_2_to_n": step_ms,
                "segments_per_s": TRAIN_B / step_ms * 1e3,
                "steps": TRAIN_STEPS, "batch": TRAIN_B,
                "step1_metric_rel_err": loss_err,
                "step1_grad_norm_rel_err": norm_err}
    print(f"  train step (median of steps 2..{TRAIN_STEPS}): {step_ms:.2f} "
          f"ms, {TRAIN_B / step_ms * 1e3:.1f} segments/s")
    phase("training", t0)

    # 9b. training with logits out (fused_loss=False): the main path of the
    # frame kernels' logits-out mode, counted
    t0 = time.perf_counter()
    cfg_lo = dataclasses.replace(cfg, fused_loss=False)
    lo_train_b, lo_val_b = make_loaders(*corpora, TRAIN_B, seed=args.seed)
    lo_trainer = tr.Trainer(cfg_lo, tcfg, lo_train_b, lo_val_b, device=dev)
    step_gen = lambda: torch.Generator(device=dev).manual_seed(tcfg.seed)
    k1_before = tf.frame_core_fwd.launches
    with plain_frames():
        lo_ref_m, lo_ref_g = tr.loss_and_grads(
            lo_trainer.params, cfg_lo, tcfg, 0, step_gen(), x, c, pr_mat)
    check(tf.frame_core_fwd.launches == k1_before,
          "the plain reference step launched K1")
    lo_ref_m = {k: v.item() for k, v in lo_ref_m.items()}
    lo_ref_norm = global_norm(lo_ref_g).item()
    del lo_ref_g
    # the same batch, noise and weights with the CE fused in
    fused_m = tr.eval_metrics(lo_trainer.params, cfg, tcfg, 0, step_gen(),
                              *lo_trainer._to_device(first))
    fused_m = {k: v.item() for k, v in fused_m.items()}
    counted = (tf.frame_fwd, tf.frame_bwd, tf.frame_core_fwd,
               tf.frame_core_bwd, tf.weight_grads,
               full_decoder.decode_grid_full, ar_decoder.frame_decode)
    for f in counted:
        f.launches = 0
    lo_trainer.train_steps(LOGITS_STEPS)
    lo_val = lo_trainer.eval_epoch()
    torch.cuda.synchronize()
    lo_launches = {"K1": tf.frame_core_fwd.launches,
                   "K2a": tf.frame_core_bwd.launches,
                   "K2b": tf.weight_grads.launches}
    others = {f.__name__: f.launches for f in counted
              if f not in (tf.frame_core_fwd, tf.frame_core_bwd,
                           tf.weight_grads)}
    n_val = len(lo_val_b)
    print(f"  launches in {LOGITS_STEPS} train steps + {n_val} eval "
          f"batch(es) with logits out: {lo_launches}; loss-mode and decode "
          f"kernels {others}")
    check(lo_launches == {"K1": T * (LOGITS_STEPS + n_val),
                          "K2a": T * LOGITS_STEPS,
                          "K2b": T * LOGITS_STEPS},
          f"logits-out train launches {lo_launches}")
    check(not any(others.values()),
          f"the logits-out path launched another kernel: {others}")
    for i, m in enumerate(lo_trainer.history):
        print(f"  step {i + 1}: loss {m['loss']:.6f} recon "
              f"{m['recon_loss']:.6f} kl {m['kl_loss']:.6f} chord "
              f"{m['chord_loss']:.6f} grad norm "
              f"{lo_trainer.grad_norms[i]:.6f} "
              f"({lo_trainer.step_seconds[i] * 1e3:.1f} ms)")
        check(all(np.isfinite(v) for v in m.values()), f"step {i + 1} {m}")
    print(f"  val: loss {lo_val['loss']:.6f}")
    check(all(np.isfinite(v) for v in lo_val.values()), f"val {lo_val}")
    lo1 = lo_trainer.history[0]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    lo_loss_err = max(rel(lo1[k], lo_ref_m[k]) for k in dv.METRIC_NAMES)
    lo_norm_err = rel(lo_trainer.grad_norms[0], lo_ref_norm)
    modes_err = max(rel(lo1[k], fused_m[k]) for k in dv.METRIC_NAMES)
    print(f"  step 1 vs the plain path on the card: loss {lo1['loss']!r} vs "
          f"{lo_ref_m['loss']!r}; 11 metrics max rel err {lo_loss_err:.3g}; "
          f"grad norm {lo_trainer.grad_norms[0]!r} vs {lo_ref_norm!r} (rel "
          f"err {lo_norm_err:.3g})")
    print(f"  step 1 vs the fused mode on the same batch, noise and weights: "
          f"loss {lo1['loss']!r} vs {fused_m['loss']!r}, recon "
          f"{lo1['recon_loss']!r} vs {fused_m['recon_loss']!r}; 11 metrics "
          f"max rel err {modes_err:.3g}")
    check(lo_loss_err <= LOSS_RTOL, f"logits-out step 1 metrics rel err "
          f"{lo_loss_err}")
    check(lo_norm_err <= NORM_RTOL, f"logits-out step 1 grad norm rel err "
          f"{lo_norm_err}")
    check(modes_err <= MODES_RTOL, f"logits-out vs fused step 1 metrics "
          f"rel err {modes_err}")
    lo_step_ms = float(np.median(lo_trainer.step_seconds[1:])) * 1e3
    training_lo = {"step_ms_median_2_to_n": lo_step_ms,
                   "segments_per_s": TRAIN_B / lo_step_ms * 1e3,
                   "steps": LOGITS_STEPS, "batch": TRAIN_B,
                   "step1_metric_rel_err": lo_loss_err,
                   "step1_grad_norm_rel_err": lo_norm_err,
                   "step1_vs_fused_rel_err": modes_err}
    print(f"  logits-out train step (median of steps 2..{LOGITS_STEPS}): "
          f"{lo_step_ms:.2f} ms, {TRAIN_B / lo_step_ms * 1e3:.1f} "
          f"segments/s")
    phase("training (logits out)", t0)

    # 10. timing
    t0 = time.perf_counter()
    timing = {}
    for B in (128, 512):
        z = torch.randn(B, cfg.z_dim, device=dev, generator=gen)
        inputs = ptd.decode_inputs(params["dec"], cfg, z)
        h = torch.randn(B, cfg.dec_time_hidden, device=dev,
                        generator=gen) * 0.6
        sos = inputs.sos_emb
        k3 = cuda_ms(lambda: ar_decoder.frame_decode(fw, spec, h, sos), 20)
        k4 = cuda_ms(lambda: full_decoder.decode_grid_full(fw, spec,
                                                            *inputs), 5)
        k3p = cuda_ms(lambda: ar_decoder.frame_decode_plain(fw, spec, h,
                                                            sos), 3)
        k4p = cuda_ms(lambda: full_decoder.decode_grid_full_plain(
            fw, spec, *inputs), 1)
        per_r = {}
        grid = torch.empty((B, spec.num_step, spec.max_simu_note - 1, 6),
                           dtype=torch.int32, device=dev)
        for r in (1, 2, 4):
            per_r[r] = cuda_ms(lambda: build.launch(
                "pctd_full_decode", fw, dims, B, [*inputs, grid], rows=r), 3)
        timing[B] = {"K3": (k3, k3p, *bound_ms(*frame_work(fw, spec, B))),
                     "K4": (k4, k4p, *bound_ms(*full_work(fw, spec, B)))}
        print(f"  B={B}: K3 {k3:.3f} ms (plain {k3p:.3f}), K4 {k4:.3f} ms "
              f"(plain {k4p:.3f}); K4 ms by rows a block "
              + ", ".join(f"{r}: {v:.3f}" for r, v in per_r.items()))
        for name, (ms, pms, bms, by) in timing[B].items():
            print(f"  B={B} {name} bound {bms:.4f} ms ({by}), "
                  f"{bms / ms:.3%} of it")

    W, EH2 = spec.dur_width, 2 * cfg.dec_emb_hidden
    for B in (128, 512):
        cw, inp = frame_case(params, cfg, B, gen)
        d = tf.dims_of(cw, spec)
        fwd = lambda: tf.frame_fwd(cw, spec, **inp, stash=True)
        _, _, lens, _, st = fwd()
        d_nums = torch.rand(1 + W, device=dev, generator=gen)
        d_summ = torch.randn(B, EH2, device=dev, generator=gen)
        bwd = lambda: tf.frame_bwd(cw, spec, inp["frame_h"], inp["coins"],
                                   inp["gt_pitch"], inp["gt_dur"], lens, st,
                                   d_nums, d_summ)
        ct = bwd()[2]
        out = [tf.CoreWeights(*(torch.empty_like(w) for w in cw))
               for _ in range(2)]
        tasks = [tf.wgrad_tasks(d, B, inp["frame_h"], st, ct, g) for g in out]
        k1 = cuda_ms(fwd, 10)
        k2a = cuda_ms(bwd, 10)
        k2b = cuda_ms(lambda: build.launch_wgrad(tasks[0]), 10)
        k2b_plain = cuda_ms(lambda: tf.wgrad_plain(tasks[1]), 3)
        k2b_vs = max((a - b).abs().max().item() / (1 + b.abs().max().item())
                     for a, b in zip(*out))
        check(k2b_vs <= GRAD_TOL, f"K2b vs its plain version {k2b_vs}")
        with torch.no_grad():
            k1p = cuda_ms(lambda: tf.frame_recon_plain(cw, spec, **inp), 2)
        k2p = plain_backward_ms(cw, spec, inp, (d_nums, d_summ), 2)
        (f1, b1), (f2a, b2a) = train_frame_work(cw, spec, B)
        # logits-out mode: K1 with its stash, K2a on random logit cotangents
        fwd_lo = lambda: tf.frame_core_fwd(cw, spec, **core_inputs(inp),
                                           stash=True)
        pitch, dur, _, lens_lo, _, st_lo = fwd_lo()
        cots_lo = (torch.randn(pitch.shape, device=dev, generator=gen),
                   torch.randn(dur.shape, device=dev, generator=gen), d_summ)
        bwd_lo = lambda: tf.frame_core_bwd(cw, spec, inp["frame_h"],
                                           inp["coins"], lens_lo, st_lo,
                                           *cots_lo)
        k1l = cuda_ms(fwd_lo, 10)
        k2al = cuda_ms(bwd_lo, 10)
        with torch.no_grad():
            k1lp = cuda_ms(lambda: tf.frame_core_plain(
                cw, spec, **core_inputs(inp)), 2)
        k2lp = plain_backward_ms(cw, spec, inp, cots_lo, 2, logits=True)
        (f1l, b1l), (f2al, b2al) = train_frame_work(cw, spec, B, logits=True)
        timing[B].update({
            "K1": (k1, k1p, *bound_ms(f1, b1)),
            "K2a": (k2a, k2p, *bound_ms(f2a, b2a)),
            "K2b": (k2b, k2b_plain, *bound_ms(*wgrad_work(tasks[0]))),
            "K1 logits": (k1l, k1lp, *bound_ms(f1l, b1l)),
            "K2a logits": (k2al, k2lp, *bound_ms(f2al, b2al))})
        print(f"  B={B}: K1 {k1:.3f} ms (plain {k1p:.3f}), K2a {k2a:.3f} ms "
              f"+ K2b {k2b:.3f} ms (plain K2, autograd backward, "
              f"{k2p:.3f}; plain K2b {k2b_plain:.3f}); K2b vs its plain "
              f"version: max|err| / (1 + max|plain|) {k2b_vs:.3g}")
        print(f"  B={B}: logits out: K1 {k1l:.3f} ms (plain {k1lp:.3f}), K2a "
              f"{k2al:.3f} ms (plain K2, autograd backward, {k2lp:.3f})")
        for name in ("K1", "K2a", "K2b", "K1 logits", "K2a logits"):
            ms, pms, bms, by = timing[B][name]
            print(f"  B={B} {name} bound {bms:.4f} ms ({by}), "
                  f"{bms / ms:.3%} of it")
        del st, ct, tasks, out, st_lo
    opt_ms = optimizer_ms(trainer, 5)
    print(f"  optimizer step (clip + Adam, all parameters): {opt_ms:.3f} ms")
    profile = profile_step(trainer)
    training.update({"optimizer_ms": opt_ms, "profile": profile})
    print("  with logits out:")
    training_lo["profile"] = profile_step(lo_trainer)
    # the two loss modes' train steps in turns (host clock, each step ends
    # in a host read of its metrics)
    turns = {"fused": (trainer, []), "logits_out": (lo_trainer, [])}
    streams = {k: t_.batches() for k, (t_, _) in turns.items()}
    for _ in range(TURNS):
        for name, (t_, ms) in turns.items():
            t_.train_step(next(streams[name]))
            ms.append(t_.step_seconds[-1] * 1e3)
    in_turns = {k: float(np.median(ms)) for k, (_, ms) in turns.items()}
    print(f"  train step in turns, median of {TURNS} each: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in in_turns.items())
          + "; steps " + "; ".join(
              f"{k} " + " ".join(f"{v:.1f}" for v in ms)
              for k, (_, ms) in turns.items()))
    training_lo["step_ms_in_turns"] = in_turns
    phase("timing", t0)

    # 11. kernels
    rows = []
    src = "pctd_tpu_torch/ops/kernels/csrc/decoder.cu"
    for name, fn, err, ag, tol in (
            ("K3 frame_kernel", "pctd_tpu/ops/pallas/ar_decoder.py:238",
             k3_err, k3_agree,
             f"pitch/dur/length agreement >= {AGREE}; summary max|err| "
             f"<= {SUMMARY_ATOL} on agreeing rows"),
            ("K4 full_kernel", "pctd_tpu/ops/pallas/full_decoder.py:59",
             k4_err, k4_agree,
             f"grid agreement >= {AGREE} (max_abs_err: largest int "
             "difference of a grid cell)")):
        key = name[:2]
        ms, pms, bms, by = timing[128][key]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": fn, "launches": launches[key],
                     "max_abs_err": err, "agreement": ag, "tolerance": tol,
                     "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by,
                     "library_ms": None, "batch": 128,
                     "ms_b512": timing[512][key][0],
                     "plain_ms_b512": timing[512][key][1]})
    tsrc = "pctd_tpu_torch/ops/kernels/csrc/train_frame.cu"
    for key, name, fn, err, tol in (
            ("K1", "K1 train_fwd_kernel",
             "pctd_tpu/ops/pallas/train_frame.py:289", k1_err,
             f"decisions agree on >= {AGREE} of rows; on those, nums rel "
             f"err <= {NUMS_RTOL}, summary and hs max|err| <= {STATE_ATOL}"),
            ("K2a", "K2a train_bwd_kernel",
             "pctd_tpu/ops/pallas/train_frame.py:736", k2a_err,
             f"d_frame_h, d_x_emb max|err| <= {GRAD_TOL} x (1 + max|plain|)"
             " vs autograd of the plain version"),
            ("K2b", "K2b wgrad_kernel",
             "pctd_tpu/ops/pallas/train_frame.py:736", max(k2b_err, k2bl_err),
             f"24 weight grads max|err| <= {GRAD_TOL} x (1 + max|plain|) "
             "vs autograd of the plain version, in both modes"),
            ("K1 logits", "K1 train_fwd_kernel (logits out)",
             "pctd_tpu/ops/pallas/train_frame.py:289", k1l_err,
             "decisions and lengths equal the plain version's on every row "
             "and the logits' argmaxes; logits and summary max|err| <= "
             f"{CORE_TOL} x (1 + max|plain|)"),
            ("K2a logits", "K2a train_bwd_kernel (logits out)",
             "pctd_tpu/ops/pallas/train_frame.py:736", k2al_err,
             f"d_frame_h, d_x_emb max|err| <= {GRAD_TOL} x (1 + max|plain|)"
             " vs autograd of the plain version")):
        ms, pms, bms, by = timing[128][key]
        logits = key.endswith("logits")
        rows.append({"name": name, "route": "cuda", "source": tsrc,
                     "replaces": fn,
                     "launches": (lo_launches[key.split()[0]] if logits
                                  else train_launches[key]),
                     "max_abs_err": err, "tolerance": tol, "ms": ms,
                     "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                     "library_ms": None, "batch": 128,
                     "ms_b512": timing[512][key][0],
                     "plain_ms_b512": timing[512][key][1]})
        if key == "K2b":      # one K2b serves both modes
            rows[-1]["launches_logits_out"] = lo_launches["K2b"]
    print(json.dumps({"serving": serving, "training": training,
                      "training_logits_out": training_lo, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
