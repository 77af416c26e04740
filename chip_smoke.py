"""Chip smoke test of the pctd_tpu_torch serving path on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the decode kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then serves the four
latent-control workflows through ``Sampler(fixed_batch=128)`` at the
canonical model width (random weights from ``--seed``) and shows that the
served decodes went through the kernels. Prints one line per phase with its
seconds, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result,
without a CUDA card or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models import pianotree_decoder as ptd
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.kernels import ar_decoder, build, full_decoder

#: H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
AGREE = 0.999          # discrete outputs, kernel vs plain
SUMMARY_ATOL = 1e-4    # K3 summary on rows whose discrete outputs agree
SIZES = (1, 37, 128, 300)


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
    for r in (1, 2, 4):
        print(f"  shared memory, {r} row(s) a block: "
              f"{lib.pctd_smem_bytes(ctypes.byref(wst), r)} B")
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

    # 6. serving: the main path, counted
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

    # 7. timing
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
    phase("timing", t0)

    # 8. kernels
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
    print(json.dumps({"serving": serving, "card": card}))
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
