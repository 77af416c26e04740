"""Chip smoke test of the pctd_tpu_torch serving and training paths on one
CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from the sources in this checkout and, while the
card holds nothing else, runs the conv model's train step graph at the
committed step envelope's batch through a train epoch, an eval epoch and
a train epoch again (phase "step graph at the envelope"). It holds each
kernel against its plain PyTorch version on the card: the decode kernels K3 and
K4 (row groups in thread-block clusters, at B = 1, 37, 128 and 512 in
clusters of 8 and of 16, the same bits over two launches), the
train-frame forward K1 (row groups in thread-block clusters, its chain
weights streamed from packed panels; the same bits over two launches in
each mode and storage type) and its backward K2 (K2a, the reverse chain
in three kernels, and K2b, the weight-gradient reduction), K1 and K2a in
both their modes (CE fused in, and logits out), and K3, K1, K2a and K2b in
both storage types (float32 and bfloat16). K2a is also held alone against
``frame_bwd_plain`` on the same stash (f32 against f64, with plain TF32 as
the control that must fail the gate; bf16 against bf16; two launches' bits).
Then it serves the four latent-control workflows through
``Sampler(fixed_batch=128)`` (K4), a swap of 300 and one of 512 requests
through an unchunked ``Sampler()`` (one K4 launch of all the rows, above the
~240 rows the card holds in one wave of clusters), and with
``compute_dtype="bfloat16"``
through ``Sampler(frame_decoder="frame")`` (K3 in bf16), and trains the
model for a few steps through ``Trainer`` at B=128 in each loss mode
(``ModelConfig.fused_loss`` True, then False), in float32 and then with
``compute_dtype="bfloat16"``, all at the canonical model width (random
weights from ``--seed``), and shows that each path went through its
kernels (in bf16, with bf16 tensors at every launch). The phase "K2b by
task" times the weight-gradient reduction on each of its 16 reductions
alone and on all together at B=128 and 512 in both storage types, holds it
against an f64 reference (f32) and against ``wgrad_plain`` in bf16 ulps
(bf16), each gate beside a control that it must refuse, and across two
launches (the same bits), measures the mma.sync issue rates that bound it,
and times an f32 train step with K2b and one with ``wgrad_plain`` in its
place, both eager, in turns beside the main path's step (a replay). The
phase "K2a by phase" times K2a, each of its three kernels alone and each
of the two serial chains alone at B=128 and 512 in both storage types,
the chains at each cluster size, and counts K2a's kernels in the profiled
steps. The phase "timing" times the row-group K3
(both storage types) and K4 queued behind a sleep kernel (the per-row
kernels they replaced were timed by ``tools/decode_by_rows.py``, which
``git show c1278ea`` recovers); the phase "K3/K4 by phase"
times them whole and by phase at both cluster sizes. The phase "K1 by
phase" times the row-group K1 whole (at both cluster sizes) and by phase
at B=128 and 512 in both storage types and modes with every teacher coin
0, measures one SM's bulk-copy rate from L2 (``csrc/l2_stream.cu``), and,
given ``--parent-k1`` (the JSON line of ``tools/k1_by_rows.py`` run on a
checkout of the per-row K1), prints the per-row times beside. The
training run: the train CLI (``pctd_tpu_torch.cli.train``) in this process
for two epochs of 9 steps at B=128 on 8 synthetic songs (launch counts:
the wrappers count the steps whose Python ran, the eager first step and
the step graph's captures, and the profiled steps count a replay's kernels
on the device timeline against an eager step's; epoch lines, checkpoints, ``metrics.csv`` rows, a profile trace), a run
resumed from a checkpoint against two uninterrupted runs (the same bits),
the evaluate CLI on the run's checkpoint against the plain frames, the
pianotree texture encoder (its detrend on the card against the numpy copy,
three steps, step 1 against the plain path) and the automatic
accumulation's step envelope (the bytes of an f32 step at B=128 and 512,
against the committed ``train.trainer.STEP_ENVELOPE``). The serving
daemon (``pctd_tpu_torch.cli.serve``) on the training run's checkpoints:
MIDI written in-process from synthetic songs, every op at 8 and 64 windows
at fixed batch 16 and 128 (every reply ok, K4 launched once a chunk of
decoded rows and nothing else; one request on the K3 route), its grids
against the CPU plain path, reload (another checkpoint's bytes; other
widths refused, nothing changed), the daemon as a process with malformed
lines, and the generate and arrange CLIs. The reference checkpoint: the
run's checkpoint to a reference ``.pt`` and back
(``pctd_tpu_torch.cli.convert_checkpoint``, the same bits), served by the
daemon in this process (the source checkpoint's bytes), and a pianotree
``.pt`` detected. The demo tree: ``pctd_tpu_torch.cli.make_demos --k 4`` on
the run's checkpoint (K4 only, counted; the reference tree's files and
track names, every file parsing). The 32-bar stretch (num_step=128) at
canonical width: served through ``Sampler(fixed_batch=128)`` (the four
workflows at n = 1, 37, 128, K4 once a chunk; a swap against K4's plain
version; K4 at T=128 timed queued; the K3 route in f32 and bf16, 128
launches a chunk, bf16 against the plain bf16 route with each differing
row's first difference a near-tie), and trained at B=128 on an 8-bar
synthetic corpus (f32 fused, logits out, bf16; K1/K2a/K2b 128 launches a
step; step 1 against the plain path; its step envelope against the
committed ``STEP_ENVELOPE[("conv", 128)]``). The pianotree texture encoder
served: the detrended grid on the card, ``Sampler.encode`` with it, the
``disentangle_vae`` workflows with ``dt_x`` through K4 against the CPU plain
path, the Sampler's workflows refusing the model. The phase "data
parallel": the data-parallel train step over a process group of one rank
(NCCL, in this process; step 1 bit-equal to the single-device step, K1/
K2a/K2b 32 times a step) and over two gloo ranks on this card (spawned as
``python3 chip_smoke.py --dp-rank ...`` after the build; the exact loss
and gradients against one process on the whole batch, the compat mode
against the halves), ``cli.serve --data-parallel`` against the daemon
without the flag (the same bytes) and ``cli.make_demos --frame-decoder
pallas`` (K3 only) against the K4 demo tree.
Prints one line per phase with its seconds, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Exits nonzero,
printing no result, without a CUDA card or when any phase fails. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import dataclasses
import io
import itertools
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pctd_tpu_torch.cli import arrange as cli_arrange
from pctd_tpu_torch.cli import convert_checkpoint as cli_convert
from pctd_tpu_torch.cli import evaluate as cli_evaluate
from pctd_tpu_torch.cli import generate as cli_generate
from pctd_tpu_torch.cli import make_demos as cli_make_demos
from pctd_tpu_torch.cli import serve as cli_serve
from pctd_tpu_torch.cli import train as cli_train
from pctd_tpu_torch.config import (ChordSpec, DataConfig, ModelConfig,
                                   PianoTreeSpec, TrainConfig,
                                   tiny_model_config)
from pctd_tpu_torch.data import demo as dm
from pctd_tpu_torch.data.detrend import detrend_pianotree_batch
from pctd_tpu_torch.data.loaders import SegmentCorpus, make_loaders
from pctd_tpu_torch.data.midi_io import MidiFile
from pctd_tpu_torch.data.songs import midi_to_windows
from pctd_tpu_torch.data.synthetic import synthetic_corpora, synthetic_song
from pctd_tpu_torch.data.tensorize import window_features
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.models import pianotree_decoder as ptd
from pctd_tpu_torch.models import texture_encoder as txt_enc
from pctd_tpu_torch.models.sampler import Sampler
from pctd_tpu_torch.ops.kernels import ar_decoder, build, full_decoder
from pctd_tpu_torch.ops.kernels import train_frame as tf
from pctd_tpu_torch.train import checkpoint as ckpt
from pctd_tpu_torch.train import schedules
from pctd_tpu_torch.train import trainer as tr
from pctd_tpu_torch.train.logging import RunPaths
from pctd_tpu_torch.train.optim import Adam, global_norm
from pctd_tpu_torch.utils import device_mem
from pctd_tpu_torch.utils.cuda_timing import cuda_ms, queued_ms
from pctd_tpu_torch.utils.precision import cast_params
from pctd_tpu_torch.utils.torch_interop import save_reference_checkpoint
from pctd_tpu_torch.utils.weights import named_leaves, params_to

#: H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, dense bf16 on the
#: tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: dense TF32 tensor-core peak (the same data sheet), and the fastest rates
#: of the f32-accurate products that K2b's function needs: three TF32
#: passes for an f32 x f32 product (3xTF32; six bf16 passes give the same),
#: three bf16 passes for bf16 x f32 (X is bf16, and dY splits exactly into
#: hi + mid + lo in bf16; K2b itself runs two TF32 passes, at 495 / 2)
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32 = PEAK_TF32_FLOPS / 3
PEAK_3XBF16 = PEAK_BF16_FLOPS / 3
AGREE = 0.999          # discrete outputs, kernel vs plain
SUMMARY_ATOL = 1e-4    # K3 summary on rows whose discrete outputs agree
SIZES = (1, 37, 128, 300)
DECODE_B = (1, 37, 128, 512)  # K3/K4 vs plain: ragged and full groups
DECODE_REPS = {"K3": 20, "K3 bf16": 20, "K4": 3}  # launches a timing averages
NUMS_RTOL = 1e-5       # K1 CE numerators vs plain
STATE_ATOL = 1e-4      # K1 summary and note hiddens vs plain
GRAD_TOL = 1e-4        # K2 grads vs autograd of plain: x (1 + max|plain|)
LOSS_RTOL = 1e-5       # train step 1, kernels vs plain path on the card
NORM_RTOL = 1e-4       # its gradient global norm
MODES_RTOL = 1e-5      # step 1's metrics, logits out vs CE fused in
CORE_TOL = 1e-4        # K1 logits out: logits, summary x (1 + max|plain|)
BF16 = torch.bfloat16
# bf16 K1 vs plain. An f32 sum in another order rounds ~2e-4 of the bf16
# hiddens to the other neighbour, and an argmax over bf16 logits meets
# near-ties, so a few decisions differ (0.16% of the slots, 2.1% of the rows,
# at B=512 on the card): every first difference of a row must be a near-tie
# of the plain version's logits, and the agreement must stay above floors:
# 0.999 over the phase (read: slots 0.999596, lengths 1.0); a case of B=37
# has 555 slots, so one flip there reads 0.998.
BF16_SLOT_AGREE = 0.99   # decided slots [pitch | 5 bits], each case
BF16_POOL_AGREE = 0.999  # decided slots, all cases of the phase
BF16_LEN_AGREE = 0.999   # lengths by row, all cases of the phase
BF16_TIE = 1e-2        # a first difference: plain logit gap / (1 + |max|)
BF16_TOL = 1e-2        # bf16 K1 logits, summary, nums: x (1 + max|plain|)
BF16_GRAD_TOL = 1e-2   # bf16 K2 grads vs autograd of plain: x (1 + max|plain|)
# bf16 train step 1, kernels vs the plain path on the card (read: metrics
# 2.95e-7, norm 7.8e-6); the bf16 vs f32 gap (read 9.6e-4) must exceed it
BF16_LOSS_RTOL = 1e-5
BF16_NORM_RTOL = 1e-4  # its gradient global norm
BF16_VS_F32_RTOL = 0.05  # bf16 vs f32 step 1 (the JAX package's own bar)
# bf16 K3 vs plain: decisions and lengths as AGREE, each row's first
# differing decision a near-tie (BF16_TIE); the summary on agreeing rows
# within BF16_SUMMARY_TOL x (1 + max|plain|): an f32 sum in another order
# can round a bf16 summary value to its other neighbour (2^-8 relative)
BF16_SUMMARY_TOL = 1e-2
SERVE_BF16_SIZES = (1, 37, 128, 300)
WIDE_SIZES = (300, 512)   # unchunked swaps: one K4 launch of n rows
TRAIN_STEPS = 6
LOGITS_STEPS = 3       # train steps with logits out
BF16_STEPS = 3         # train steps in bf16, in each loss mode
TURNS = 4              # timed train steps of each loss mode, in turns
HOST_OPS = 8           # host ops listed by self time in a profiled step
TRAIN_B = 128
WGRAD_F64_TOL = 1e-5   # K2b f32 vs an f64 reference: x (1 + max|ref|)
K2B_REPS = 10          # launches a K2b timing averages
K2A_NAME = ("K2a train_bwd_slots_kernel + train_bwd_chain_kernel + "
            "train_bwd_proj_kernel")
K2A_REPS = 10          # launches a K2a timing averages
# K2a f32 vs frame_bwd_plain in f64 on the same stash: x (1 + max|ref|), per
# output (its products are f32-accurate: 3xTF32)
K2A_F64_TOL = 1e-5
K2A_GATE_B = (128, 512)
K2A_CLUSTERS = (8, 16)  # the note chain's cluster sizes, timed beside
K1_REPS = 10            # launches a K1 timing averages
# K1 vs plain: the plan's row groups (37: clusters of 16; 128: of 8) and
# per-row kernel (512: 4 rows a block)
K1_B = (128, 37, 512)
# the training run (phase "training run"): the CLI's synthetic corpus of 8
# songs at the default seed 3345 is 105 train / 15 val segments, 9 steps
# of 128 an epoch and one val batch of 15 rows
RUN_SONGS = 8
RUN_EPOCHS = 2
RUN_LOG_EVERY = 4
RUN_STEPS = 9
RESUME_STEPS = 4       # uninterrupted; the resumed run saves after 2
PT_STEPS = 3           # pianotree-variant train steps
ENVELOPE_B = (128, 512)  # the auto-accumulation envelope's two batches
ENVELOPE_SHARE = 0.9   # of the card's memory
# the serving daemon (phase "serving daemon"): its --fixed-batch (the
# default 16, and 128), request sizes in 2-bar windows from synthetic songs
# of so many bars, timed calls a request, interpolation steps
DAEMON_FB = (16, 128)
DAEMON_BARS = {8: 16, 64: 130}
DAEMON_REPS = 3
DAEMON_INTERP = 5
# the 32-bar stretch (num_step=128): request sizes; f32 fused train steps
# (and an eval batch), logits-out and bf16 steps; the 8-bar synthetic
# corpus (songs of so many bars: 17 windows a song, ~170 train segments)
STRETCH_SIZES = (1, 37, 128)
STRETCH_STEPS = 3
STRETCH_OTHER_STEPS = 2
STRETCH_SONGS, STRETCH_BARS = 12, 24
# pianotree serving: rows encoded (chunks of 16, the last partial), rows a
# workflow decodes on the card and on the CPU plain path
PT_SERVE_ROWS = 37
PT_CPU_ROWS = 4
DEMO_K = 4             # the demo tree's k x k style-transfer grid
# the phase "data parallel": timed steps of each spawned rank, and how long
# the phase waits for its ranks
DP_TIMED_STEPS = 2
DP_RANK_TIMEOUT = 300


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def requests(rng: np.random.RandomState, B: int, T: int = 32):
    """Synthetic (pr_mat (B, T, 128), chord (B, T/4, 36)): sparse onsets
    with durations 1..8, and root one-hot | chroma | bass one-hot
    chords."""
    pr = np.zeros((B, T, 128), np.float32)
    on = rng.rand(B, T, 128) < 0.02
    pr[on] = rng.randint(1, 9, on.sum())
    n = T // 4
    c = np.zeros((B, n, 36), np.float32)
    rows, steps = np.arange(B)[:, None], np.arange(n)[None, :]
    c[rows, steps, rng.randint(0, 12, (B, n))] = 1.0
    c[..., 12:24] = rng.randint(0, 2, (B, n, 12))
    c[rows, steps, 24 + rng.randint(0, 12, (B, n))] = 1.0
    return pr, c


def phase_outputs(key: str, fw, spec, B: int, dev):
    """Output tensors of a row-group K3 ("K3", "K3 bf16") or K4 ("K4")
    launch of B rows."""
    S, W = spec.max_simu_note - 1, spec.dur_width
    i32 = dict(dtype=torch.int32, device=dev)
    if key == "K4":
        return [torch.empty((B, spec.num_step, S, 1 + W), **i32)]
    EH2 = build.decoder_dims(fw, spec).EH * 2
    return [torch.empty((B, S), **i32), torch.empty((B, S, W), **i32),
            torch.empty((B, EH2), dtype=fw.w_hh.dtype, device=dev),
            torch.empty((B,), **i32)]


def sass_sizes(lib_path, pattern: str) -> dict:
    """Instructions in the compiled code (``cuobjdump -sass``) of each
    kernel of the built library whose name matches ``pattern``: {short
    name: count}; {} where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(lib_path)],
                             capture_output=True, text=True,
                             timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    sizes, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*?(" + pattern + r"I\w+?)EE", line)
        if "Function : " in line:
            name = m.group(1) if m else None
            if name:
                sizes.setdefault(name, 0)
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return sizes


def frame_work(fw, spec, B: int):
    """(FLOPs, bytes) K3 must do and move for B rows: the products of one
    frame (gates and row selects are a few % more, not counted) and each
    weight, input and output once, at its dtype's size."""
    d = build.decoder_dims(fw, spec)
    SL, DC = d.P + d.DH + 2 + 3 * d.DH, 2 + 3 * d.DH
    macs = (d.TH * 4 * d.NH + d.K * d.NH * 3 * d.NH
            + (d.K - 1) * (d.NH * SL + d.W * d.DH * DC)
            + d.K * 2 * (d.E + d.EH) * 3 * d.EH)
    weights = sum(t.numel() * t.element_size()
                  for n, t in zip(fw._fields, fw)
                  if n not in ("wt_tok", "wt_hh", "bt_hh"))
    es = fw.w_hh.element_size()
    io = es * (d.TH + d.E + 2 * d.EH) + 4 * ((d.K - 1) * (1 + d.W) + 1)
    return 2.0 * macs * B, weights + io * B


def frame_bound_bf16(fw, spec, B: int):
    """(bound ms, what bounds it) of K3 in bf16, its work counted as the
    Pallas function defines it: the two products of the bf16 time hidden
    with bf16 weights (``w_frame``) at the dense bf16 peak, every other
    product (an f32 operand: the slot or dur hidden, the one-hot token, the
    summary inputs) at the f32 CUDA-core peak, since its result must equal
    the f32 product; bytes at each tensor's size (bf16 weights and inputs,
    the f32 constants)."""
    d = build.decoder_dims(fw, spec)
    flops, nbytes = frame_work(fw, spec, B)
    proj = 2.0 * B * d.TH * 4 * d.NH
    f = (proj / PEAK_BF16_FLOPS + (flops - proj) / PEAK_F32_FLOPS) * 1e3
    b = nbytes / PEAK_BYTES * 1e3
    return (f, "operations") if f >= b else (b, "bytes")


def full_work(fw, spec, B: int):
    """(FLOPs, bytes) K4 must do and move for B rows over T frames."""
    d = build.decoder_dims(fw, spec)
    f_flops, _ = frame_work(fw, spec, B)
    t_flops = 2.0 * B * (2 * d.EH + d.TH) * 3 * d.TH
    weights = sum(t.numel() for t in fw)
    io = d.TH + 3 * d.TH + 2 * d.EH + d.E + d.T * (d.K - 1) * (1 + d.W)
    return d.T * (f_flops + t_flops), 4.0 * (weights + io * B)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """The least time for the work: operations over ``peak`` (f32 on CUDA
    cores by default; the dense bf16 tensor peak for the bf16 rows) or
    bytes over the HBM rate, whichever is larger."""
    f, b = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


def k1_same_bits(fn) -> bool:
    """Whether two calls of a K1 wrapper give the same bits in every output,
    the stash included."""
    flat = lambda out: [t for o in out if o is not None
                        for t in (o if isinstance(o, tuple) else (o,))]
    a, b = flat(fn()), flat(fn())
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def k1_by_phase(cw, spec, inp, B: int, logits: bool) -> dict:
    """K1 on one frame case (coins as given), queued behind a sleep kernel:
    the plan's pick, the row groups whole at 8 and 16 blocks a cluster,
    the per-row kernel at 4 rows a block, and each phase of
    ``build.K1_PHASES`` of the row groups alone at 8 blocks a cluster (a
    phase alone reads zeros where the ones before it would have written),
    with its stash: {variant: (ms, queued)}."""
    d = tf.dims_of(cw, spec)
    dev, dt = inp["frame_h"].device, cw.w_hh.dtype
    S, W = d.K - 1, d.W
    i32 = dict(dtype=torch.int32, device=dev)
    common = [torch.empty(B, 2 * d.EH, dtype=dt, device=dev),
              torch.empty(B, **i32), torch.empty(B, S, 1 + W, **i32)]
    ins = [inp["coins"], inp["frame_h"], inp["x_emb"]]
    if logits:
        tensors = [*ins, torch.empty(B, S, d.P, dtype=dt, device=dev),
                   torch.empty(B, S, W, 2, dtype=dt, device=dev), *common]
    else:
        tensors = [*ins, inp["gt_pitch"], inp["gt_dur"],
                   torch.empty(B, 1 + W, device=dev), *common]
    st = tf.new_stash(d, B, dev, dt)
    plan = build.k1_plan_on_card(cw, d, B, dev)
    pick = f"C={plan.C}" if plan.C else f"R={plan.R}"
    variants = {f"plan ({pick})": (build.K1_ALL, plan.C, plan.R),
                **{f"groups C={c}": (build.K1_ALL, c, 0)
                   for c in build.DECODE_CLUSTERS},
                "per-row R=4": (build.K1_ALL, 0, 4),
                **{n: (b, 8, 0) for n, b in build.K1_PHASES.items()}}
    return {name: queued_ms(lambda ph=ph, c=c, r=r: build.launch_train_fwd(
        cw, d, B, tensors, st, logits=logits, phases=ph, cluster=c, rows=r),
        K1_REPS) for name, (ph, c, r) in variants.items()}


def l2_stream_rates(dev, panel: int = 600 * 1024) -> dict:
    """One SM's bulk-copy rate from L2 into shared memory (GB/s a block,
    ``csrc/l2_stream.cu``): 4 stages of 16 KB in flight, as K1's ring, one
    block alone and a block on every SM (8 distinct panels of ``panel``
    bytes, as K1's clusters of 8 read), 20 passes each."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = torch.zeros(8 * panel // 4, device=dev)
    out = {}
    for blocks in (1, sms):
        sink = torch.empty(blocks * 256, device=dev)
        ms, ok = queued_ms(lambda: build.launch_l2_stream(
            src, blocks, panel, 8, 16384, 4, 20, sink), 3)
        check(ok, "L2 stream probe: the host did not enqueue the timed calls "
              "within the sleep kernel")
        out[f"blocks={blocks}"] = panel * 20 / (ms * 1e-3) / 1e9
    return out


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


def to_bf16(cw, inp):
    """A frame case in bf16: the weights, frame_h and x_emb rounded."""
    return (tf.CoreWeights(*(w.to(BF16) for w in cw)),
            {k: (v.to(BF16) if v.is_floating_point() else v)
             for k, v in inp.items()})


@contextlib.contextmanager
def launch_dtypes():
    """Records, for every train-frame kernel launch in the context, the set
    of dtypes of the weights and the inputs in the storage type that the
    wrapper hands to the C entry point: K1 the weights, frame_h and x_emb;
    K2a the weights, the stash values and the output cotangents it reads;
    K2b the stash rows and the gradients. Yields a Counter of (kernel,
    dtypes)."""
    seen = collections.Counter()
    names = ("launch_train_fwd", "launch_train_bwd", "launch_wgrad")
    kernel_routes = tuple(getattr(build, n) for n in names)
    f32 = set(tf.F32_STASH)
    stored = lambda st: [t for n, t in zip(tf.Stash._fields, st)
                         if n not in f32]

    def fwd(cw, d, batch, tensors, stash, logits=False, **kw):
        seen[("K1", frozenset(str(t.dtype) for t in [*cw, *tensors[1:3]]))] \
            += 1
        return kernel_routes[0](cw, d, batch, tensors, stash, logits, **kw)

    def bwd(cw, d, batch, tensors, stash, cot, logits=False, **kw):
        cots = tensors[2:5] if logits else tensors[5:6]
        seen[("K2a", frozenset(str(t.dtype) for t in
                               [*cw, *stored(stash), *cots]))] += 1
        return kernel_routes[1](cw, d, batch, tensors, stash, cot, logits,
                                **kw)

    def wgrad(tasks, *plan):
        seen[("K2b", frozenset(str(x.dtype) for t in tasks
                               for x in (t.X, t.gW, t.gb) if x.numel()))] \
            += 1
        return kernel_routes[2](tasks, *plan)

    for n, fn in zip(names, (fwd, bwd, wgrad)):
        setattr(build, n, fn)
    try:
        yield seen
    finally:
        for n, fn in zip(names, kernel_routes):
            setattr(build, n, fn)


@contextlib.contextmanager
def decode_launch_dtypes():
    """Records, for every K3 launch in the context, the set of dtypes the
    wrapper hands to the C entry point for the storage type: the weights
    (the f32 constants ``ar_decoder.F32_FIELDS`` aside), ``h_time``,
    ``sos_emb`` and the summary; and the entry point's name. Yields a
    Counter of (entry point, dtypes)."""
    seen = collections.Counter()
    kernel_route = build.launch

    def launch(name, fw, dims, batch, tensors, **kw):
        if name.startswith("pctd_frame_decode"):
            stored = [t for n, t in zip(fw._fields, fw)
                      if n not in ar_decoder.F32_FIELDS]
            seen[(name, frozenset(str(t.dtype) for t in
                                  [*stored, tensors[0], tensors[1],
                                   tensors[4]]))] += 1
        return kernel_route(name, fw, dims, batch, tensors, **kw)

    build.launch = launch
    try:
        yield seen
    finally:
        build.launch = kernel_route


@contextlib.contextmanager
def plain_decode():
    """Inside this context the K3 route of ``decode_grid`` runs
    ``frame_decode_plain`` on the card, for the served grids' plain
    reference; the kernel route is restored on exit."""
    kernel_route = ar_decoder.frame_decode
    ar_decoder.frame_decode = ar_decoder.frame_decode_plain
    try:
        yield
    finally:
        ar_decoder.frame_decode = kernel_route


def serve_workflows(sampler, sizes, rng, gen):
    """The four workflows (swap in both fixings) through ``sampler`` at each
    request size, three calls each: checks the grids' shape, dtype and
    range and returns ({"workflow/n": {"p50_ms", "segments_per_s"}}, the
    number of fixed-batch decode chunks the calls ran)."""
    spec = sampler.cfg.pianotree
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
    serving, chunks = {}, 0
    for name, fn in workflows.items():
        for n in sizes:
            pr1, c1 = requests(rng, n, spec.num_step)
            pr2, c2 = requests(rng, n, spec.num_step)
            times = []
            for _ in range(3):
                s0 = time.perf_counter()
                out = fn(pr1, pr2, c1, c2)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - s0)
            segs = n * (5 if name == "interp" else 1)
            chunks += 3 * -(-segs // sampler.fixed_batch)
            shape = ((n, 5) if name == "interp" else (n,)) + (
                spec.num_step, 15, 6)
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
    return serving, chunks


def root_margins(got_dec, want_dec, pitch_logits, dur_logits):
    """For each row whose kernel decisions differ from the plain version's,
    the plain version's margin at the first differing decision (slot-major,
    [pitch | bit 0..W-1] within a slot): for a pitch, its max logit minus
    the logit of the kernel's pitch; for a bit, |logit1 - logit0|; both over
    1 + |max logit| (pitch) or 1 + max|logit| (bit), on the plain version's
    bf16 logits. A margin near 0 is a near-tie."""
    B, S, C = got_dec.shape
    diff = (got_dec != want_dec).reshape(B, S * C)
    rows = diff.any(1).nonzero()[:, 0]
    if not len(rows):
        return torch.zeros(0, device=got_dec.device)
    first = diff[rows].int().argmax(1)
    k, c = first // C, first % C
    pl = pitch_logits.float()[rows, k]                 # (n, P)
    mx = pl.max(-1).values
    pick = pl.gather(-1, got_dec[rows, k, 0].long()[:, None])[:, 0]
    m_pitch = (mx - pick) / (1 + mx.abs())
    dl = dur_logits.float()[rows, k, (c - 1).clamp(min=0)]   # (n, 2)
    m_bit = (dl[:, 1] - dl[:, 0]).abs() / (1 + dl.abs().amax(-1))
    return torch.where(c == 0, m_pitch, m_bit)


def launch_summary(seen) -> dict:
    """A :func:`launch_dtypes` record as {"kernel [dtypes]": launches}."""
    return {f"{k} {sorted(v)}": n for (k, v), n in sorted(seen.items())}


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
    are a few % more, not counted), and the bytes the replaced Pallas pair
    (``_fwd_call`` with its stash, ``_bwd_call``) must move: each weight
    read once, each input and output once (frame_h, x_emb, the summary, the
    logits, their cotangents, d_frame_h and d_x_emb at the storage type's
    size; the int32 targets and lengths; the CE numerators once a frame),
    and the stash that pair passes, the K note hiddens (B, NH) of the
    storage type. The port's further stash (the f32 gates and the other
    activations) and the cotangents K2a hands to K2b are its own design,
    not the function's, and are left out."""
    d = tf.dims_of(cw, spec)
    S, W = d.K - 1, d.W
    es = cw.w_hh.element_size()
    slot = (d.E * 3 * d.NH + d.NH * 3 * d.NH + d.NH * d.P
            + (d.NH + d.P) * d.DH + W * d.DH * 3 * d.DH + W * d.DH * 2)
    summ = d.K * 2 * (d.E + d.EH) * 3 * d.EH
    frame = d.TH * 4 * d.NH
    k1_macs = frame + S * slot + summ       # S hidden-gate products: h0..h14
    k2_macs = frame + S * (slot + W * 3 * d.DH) + summ
    weights = es * sum(w.numel() for w in cw)
    hs = es * d.K * d.NH                    # the stash, a row
    ins = es * (d.TH + d.K * d.E)           # frame_h, x_emb (or d_ of them)
    summary = es * 2 * d.EH                 # the summary (or d_summ)
    # loss mode: int32 targets in, the numerators out once a frame; logits
    # out: the logits out of K1, their cotangents into K2a
    per_row = es * S * (d.P + 2 * W) if logits else 4 * S * (1 + W)
    nums = 0 if logits else 4 * (1 + W)
    k1_io = ins + per_row + summary + 4 + hs
    k2_io = ins + hs + per_row + summary + ins
    return ((2.0 * k1_macs * B, weights + nums + k1_io * B),
            (2.0 * k2_macs * B, weights + nums + k2_io * B))


def wgrad_work(tasks):
    """(FLOPs, bytes) of K2b: 2 N I O (+ N O adds for a bias) a task, and
    each weight gradient written once at its size. Its operands (stash rows
    and cotangents) are the port's traffic between K1, K2a and K2b; the
    replaced Pallas backward keeps them on chip, so they are left out."""
    flops = sum((2.0 * t.I + (1 if t.gb.numel() else 0)) * t.N * t.O
                for t in tasks)
    nbytes = sum(t.gW.numel() * t.gW.element_size()
                 + t.gb.numel() * t.gb.element_size() for t in tasks)
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


def profile_call(fn, what: str) -> dict:
    """Device time of one call of ``fn`` by kernel group, from
    torch.profiler: the frame kernels (K1, K2a, K2b, K3, K4), cuBLAS/CUTLASS
    products (time GRU, encoders, chord decoder, heads) and the other
    PyTorch kernels (gates, losses, tensorize, optimizer, casts); and the
    device's idle share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - s0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("  profiler: no device events; breakdown not measured")
        return {"measured": False}
    groups, counts = collections.Counter(), collections.Counter()
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        n = e.name
        key = ("K1" if "train_fwd" in n else
               "K2a" if "train_bwd_" in n else
               "K2b" if "wgrad_" in n else
               "K3" if "frame_kernel" in n else
               "K4" if "full_kernel" in n else
               "gemm" if re.search(r"gemm|cutlass|cublas", n, re.I) else
               "other")
        groups[key] += us
        counts[key] += 1
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
           "kernel_count": dict(counts),
           "host_self_ms_top": host_ms}
    print(f"  profiled {what}: {wall_us / 1e3:.2f} ms wall (profiler on), "
          f"device busy {busy / 1e3:.2f} ms, idle share "
          f"{out['idle_share']:.3f}; device ms by group "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    print("  host self time by op (profiler on), top: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in host_ms.items()))
    return out


def profile_step(trainer) -> dict:
    """:func:`profile_call` of one train step, a replay of the trainer's
    step graph, with an eager step (:func:`eager_step_ms`) on the same
    batch profiled beside it under "eager". A replay runs the kernels its
    capture launched and no wrapper counts them, so they are counted here,
    on the device timeline: K1, K2a and K2b the same in the two steps, and
    the eager step's wrappers count T launches of each."""
    wrappers = (tf.frame_fwd, tf.frame_core_fwd, tf.frame_bwd,
                tf.frame_core_bwd, tf.weight_grads)
    T = trainer.mcfg.pianotree.num_step
    batch = next(trainer.batches())
    replays = trainer.step_replays
    out = profile_call(lambda: trainer.train_step(batch), "step (a replay)")
    check(trainer.step_replays == replays + 1,
          "the profiled step is not a replay")
    before = [f.launches for f in wrappers]
    out["eager"] = profile_call(lambda: eager_step_ms(trainer, batch),
                                "eager step")
    counted = sorted(f.launches - n for f, n in zip(wrappers, before))
    check(counted == [0, 0, T, T, T],
          f"the eager step's wrappers counted {counted}")
    if out["measured"] and out["eager"]["measured"]:
        got, want = ({k: p["kernel_count"].get(k, 0)
                      for k in ("K1", "K2a", "K2b")}
                     for p in (out, out["eager"]))
        print(f"  frame kernels on the device timeline: replay {got}, "
              f"eager step {want}")
        check(got == want and min(got.values()) >= T,
              f"a replay's frame kernels {got}, an eager step's {want}")
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


def wgrad_inputs(params, cfg, gen, B: int, bf16: bool):
    """K2b's operands at B rows: a frame case (in bf16 if ``bf16``) run
    through K1 with its stash and K2a in loss mode. Returns a function that
    makes the 16 reductions writing into a fresh set of gradients."""
    spec = cfg.pianotree
    dev = gen.device
    cw, inp = frame_case(params, cfg, B, gen)
    if bf16:
        cw, inp = to_bf16(cw, inp)
    with torch.no_grad():
        _, _, lens, _, st = tf.frame_fwd(cw, spec, **inp, stash=True)
        d_nums = torch.rand(1 + spec.dur_width, device=dev, generator=gen)
        d_summ = torch.randn(B, 2 * cfg.dec_emb_hidden, device=dev,
                             generator=gen).to(cw.w_hh.dtype)
        ct = tf.frame_bwd(cw, spec, inp["frame_h"], inp["coins"],
                          inp["gt_pitch"], inp["gt_dur"], lens, st, d_nums,
                          d_summ)[2]
    d = tf.dims_of(cw, spec)

    def tasks():
        g = tf.CoreWeights(*(torch.empty_like(w) for w in cw))
        return tf.wgrad_tasks(d, B, inp["frame_h"], st, ct, g)
    return tasks


def task_outputs(tk):
    """A K2b task's outputs: (gW or None when I = 0, gb or None)."""
    return (tk.gW if tk.I else None, tk.gb if tk.gb.numel() else None)


def wgrad_f64(tasks):
    """Each task's (gW, gb) in f64 on the card, from its rows."""
    ref = []
    for tk in tasks:
        x, dy = tf.task_rows(tk)
        dy = dy.double()
        ref.append((None if x is None else x.double().t() @ dy,
                    dy.sum(0) if tk.gb.numel() else None))
    return ref


def scaled_errs(tasks, ref):
    """For each task, max|out - ref| / (1 + max|ref|) over its outputs."""
    errs = []
    for tk, r in zip(tasks, ref):
        errs.append(max((a.double() - b).abs().max().item()
                        / (1.0 + b.abs().max().item())
                        for a, b in zip(task_outputs(tk), r)
                        if b is not None))
    return errs


def bf16_ulps(a, b):
    """|a - b| in units of the bf16 spacing at |b|, elementwise (b of bf16;
    2^-133, the least bf16 step, where b is 0)."""
    b32 = b.float()
    _, e = torch.frexp(b32)
    ulp = torch.where(b32 == 0, torch.full_like(b32, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(b32),
                                  (e - 8).clamp(min=-133)))
    return (a.float() - b32).abs() / ulp


def ulp_report(tasks, plain_tasks, ref) -> dict:
    """The bf16 kernel outputs against wgrad_plain's, in bf16 ulps of the
    plain value: the largest, how many elements exceed one ulp, how many of
    those also miss the f32 gate (WGRAD_F64_TOL x (1 + max|ref|)) against
    the f64 reference, and the worst element with its f64 reference and its
    output's max|ref|. Two f32-accurate sums in another order differ by
    more than a bf16 ulp where an element cancels below their f32 rounding
    error; such an element must still meet the f32 gate."""
    worst, over, outside = None, 0, 0
    for k, (ta, tb, r) in enumerate(zip(tasks, plain_tasks, ref)):
        for a, b, f in zip(task_outputs(ta), task_outputs(tb), r):
            if a is None:
                continue
            u = bf16_ulps(a, b)
            big = u > 1
            over += int(big.sum())
            gate = WGRAD_F64_TOL * (1.0 + f.abs().max().item())
            outside += int(((a.double() - f).abs() > gate)[big].sum())
            j = int(u.argmax())
            if worst is None or u.flatten()[j].item() > worst["ulps"]:
                worst = {"ulps": u.flatten()[j].item(),
                         "task": tf.WGRAD_NAMES[k],
                         "kernel": a.flatten()[j].item(),
                         "plain": b.flatten()[j].item(),
                         "f64": f.flatten()[j].item(),
                         "max_ref": f.abs().max().item()}
    return {"max": worst["ulps"], "over_one": over,
            "over_one_outside_f32_gate": outside, "worst": worst}


@contextlib.contextmanager
def plain_wgrad():
    """Inside this context the training path's weight gradients come from
    ``wgrad_plain`` (cuBLAS products) in K2b's place; restored on exit."""
    kernel_route = tf.weight_grads

    def plain(cw, spec, frame_h, st, ct):
        grads = tf.CoreWeights(*(torch.empty_like(w) for w in cw))
        tf.wgrad_plain(tf.wgrad_tasks(tf.dims_of(cw, spec), frame_h.shape[0],
                                      frame_h, st, ct, grads))
        return grads

    tf.weight_grads = plain
    try:
        yield
    finally:
        tf.weight_grads = kernel_route


def python_steps(trainer) -> int:
    """Steps of ``trainer`` whose Python ran, so that the kernel wrappers
    counted their launches: the eager steps and the step graph's captures.
    A replay runs the captured kernels and no wrapper (:func:`profile_step`
    counts them on the device timeline)."""
    return trainer.step_count - trainer.step_replays + trainer.step_captures


@contextlib.contextmanager
def made_trainers():
    """The Trainers made inside the block, in a list (a CLI run's)."""
    made, init = [], tr.Trainer.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    tr.Trainer.__init__ = recording
    try:
        yield made
    finally:
        tr.Trainer.__init__ = init


def eager_step_ms(trainer, batch) -> float:
    """ms of one train step of ``trainer`` run eagerly, through the function
    its step graph captures (``Trainer._run``), so that a context that swaps
    a kernel route (:func:`plain_wgrad`) reaches it: a replay runs the
    captured kernels whatever the routes are."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._run(*trainer._to_device(batch),
                 trainer._scalars().to(trainer.device))
    trainer.step_count += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def tf32_matmuls():
    """float32 matmuls in single-pass TF32 inside the block (the controls
    that an f32-accurate gate must refuse), the setting restored after."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties away from zero), as
    ``cvt.rna.tf32.f32`` gives K2b's hi part: add half of the 13 dropped
    mantissa bits, then mask them off."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mma_ceilings(dev, threads: int = 128, warps_per_sm: int = 32,
                 iters: int = 4096) -> dict:
    """Measured issue-rate ceilings (TFLOP/s) of the tensor-core
    instructions on K2b's bound (``csrc/mma_peak.cu``): mma.sync m16n8k8
    TF32 and m16n8k16 bf16, register operands, ``warps_per_sm`` warps on
    every SM, the mean of 5 launches after one warm-up by CUDA events."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * warps_per_sm * 32 // threads
    out = torch.empty(blocks * threads, device=dev)
    rates = {}
    for name, bf16, flops in (("tf32 m16n8k8", False, 2048),
                              ("bf16 m16n8k16", True, 4096)):
        ms = cuda_ms(lambda b=bf16: build.launch_mma_peak(
            b, blocks, threads, iters, out), 5)
        rates[name] = blocks * threads // 32 * iters * 8 * flops / ms / 1e9
    check(bool(torch.isfinite(out).all()), "mma.sync probe: not finite")
    return rates


def k2b_case(make, bf16: bool) -> dict:
    """K2b on one set of operands: its time on each task alone (the task
    launched with its slices and workspace from the whole plan) and on all
    together, and wgrad_plain's, the calls queued behind a sleep kernel
    (:func:`queued_ms`; beside them the plain CUDA-event means, which a
    call's host time can stretch), and what its gates read: f32 against an
    f64 reference, with wgrad_plain in f32 beside it and in single-pass
    TF32 (the control); bf16 in bf16 ulps of wgrad_plain
    (:func:`ulp_report`), with wgrad_plain on dY rounded to TF32 (K2b
    without its lo pass, the control); two launches' bits; both against
    wgrad_plain scaled by (1 + max|plain|)."""
    tasks, plain_tasks, again = make(), make(), make()
    plan = tf.wgrad_plan(tf.wgrad_shapes(tasks))
    ws = torch.empty(max(plan.ws_elems, 1), device=tasks[0].DY.device)

    def alone(k):
        build.launch_wgrad([tasks[k]], [plan.slices[k]], ws,
                           [plan.ws_off[k]])
    # a task alone runs in tens of microseconds, under a launch's host time
    per_task = [queued_ms(lambda k=k: alone(k), K2B_REPS)
                for k in range(len(tasks))]
    whole, queued = queued_ms(lambda: tf.wgrad(tasks), K2B_REPS)
    plain, plain_queued = queued_ms(lambda: tf.wgrad_plain(plain_tasks), 3)
    events = cuda_ms(lambda: tf.wgrad(tasks), K2B_REPS)
    plain_events = cuda_ms(lambda: tf.wgrad_plain(plain_tasks), 3)
    tf.wgrad(again)
    torch.cuda.synchronize()
    ref = wgrad_f64(tasks)
    out = {"per_task_ms": dict(zip(tf.WGRAD_NAMES,
                                   (ms for ms, _ in per_task))),
           "queued_behind_sleep": all(q for _, q in per_task)
           and queued and plain_queued,
           "slices": dict(zip(tf.WGRAD_NAMES, plan.slices)),
           "items": sum(s * -(-(i + b) // tf.WG_TILE) * -(-o // tf.WG_TILE)
                        for s, (_, i, o, b) in
                        zip(plan.slices, tf.wgrad_shapes(tasks))),
           "item_chunks_max": plan.length,
           "workspace_bytes": 4 * plan.ws_elems,
           "ms": whole, "ms_cuda_events": events,
           "plain_ms": plain, "plain_ms_cuda_events": plain_events,
           "vs_f64": max(scaled_errs(tasks, ref)),
           "plain_vs_f64": max(scaled_errs(plain_tasks, ref)),
           "bit_identical": all(
               torch.equal(a, b) for ta, tb in zip(tasks, again)
               for a, b in zip(task_outputs(ta), task_outputs(tb))
               if a is not None),
           "vs_plain": max((a.float() - b.float()).abs().max().item()
                           / (1.0 + b.float().abs().max().item())
                           for ta, tb in zip(tasks, plain_tasks)
                           for a, b in zip(task_outputs(ta),
                                           task_outputs(tb))
                           if a is not None)}
    if bf16:
        out["ulps"] = ulp_report(tasks, plain_tasks, ref)
        control = [tk._replace(DY=tf32_round(tk.DY)) for tk in make()]
        tf.wgrad_plain(control)
        out["control_ulps"] = ulp_report(control, plain_tasks, ref)
    else:
        tf32_tasks = make()
        with tf32_matmuls():
            tf.wgrad_plain(tf32_tasks)
        out["tf32_vs_f64"] = max(scaled_errs(tf32_tasks, ref))
    flops, nbytes = wgrad_work(tasks)
    out["bound"] = bound_ms(flops, nbytes,
                            PEAK_3XBF16 if bf16 else PEAK_3XTF32)
    out["tasks"] = [(tk.N, tk.I, tk.O, int(tk.gb.numel() > 0))
                    for tk in tasks]
    return out


def k2a_case(params, cfg, gen, B: int, bf16: bool):
    """One loss-mode frame case at B rows (in bf16 if ``bf16``) run through
    K1 with its stash, and random cotangents of its outputs: (weights,
    inputs, lengths, stash, d_nums, d_summ)."""
    spec = cfg.pianotree
    cw, inp = frame_case(params, cfg, B, gen)
    if bf16:
        cw, inp = to_bf16(cw, inp)
    with torch.no_grad():
        lens, st = tf.frame_fwd(cw, spec, **inp, stash=True)[2::2]
    d_nums = torch.rand(1 + spec.dur_width, device=gen.device, generator=gen)
    d_summ = torch.randn(B, 2 * cfg.dec_emb_hidden, device=gen.device,
                         generator=gen).to(cw.w_hh.dtype)
    return cw, inp, lens, st, d_nums, d_summ


def k2a_launch_ms(spec, case, variants: dict) -> dict:
    """K2a's device time on ``case`` (:func:`k2a_case`) for each launch
    variant (keyword arguments of ``build.launch_train_bwd``), the launches
    queued behind a sleep kernel (:func:`queued_ms`): {name: (ms, queued)}."""
    cw, inp, lens, st, d_nums, d_summ = case
    d = tf.dims_of(cw, spec)
    B = lens.shape[0]
    ct, d_frame_h, d_x_emb, dh_inj = tf.bwd_buffers(d, B, lens.device,
                                                    cw.w_hh.dtype)
    tensors = [inp["coins"], inp["gt_pitch"], inp["gt_dur"], lens, d_nums,
               d_summ, d_frame_h, d_x_emb, dh_inj]
    return {name: queued_ms(lambda kw=kw: build.launch_train_bwd(
        cw, d, B, tensors, st, ct, **kw), K2A_REPS)
        for name, kw in variants.items()}


def k2a_gate_case(params, cfg, gen, B: int, bf16: bool) -> dict:
    """K2a on one loss-mode frame case (:func:`k2a_case`) against
    frame_bwd_plain on the same stash, every output and cotangent as
    max|out - ref| / (1 + max|ref|): f32 against the plain version in f64,
    with the plain version in f32 beside it and in f32 with TF32 matmuls
    (the control, which must miss the gate); bf16 against the plain version
    in bf16 (f32 arithmetic). Also whether two launches give the same bits,
    and K2a's time queued behind a sleep kernel beside the plain version's
    (CUDA events; its host loop of small torch calls sets it)."""
    spec = cfg.pianotree
    cw, inp, lens, st, d_nums, d_summ = k2a_case(params, cfg, gen, B, bf16)
    args = (inp["frame_h"], inp["coins"], inp["gt_pitch"], inp["gt_dur"],
            lens)
    run = lambda: tf.frame_bwd(cw, spec, *args, st, d_nums, d_summ)
    flat = lambda out: [out[0], out[1], *out[2]]
    names = ["d_frame_h", "d_x_emb", *tf.Cotangents._fields]

    def plain(dtype=None):
        cast = (lambda x: x.to(dtype)) if dtype else (lambda x: x)
        return flat(tf.frame_bwd_plain(
            tf.CoreWeights(*map(cast, cw)), spec, cast(args[0]), *args[1:],
            tf.Stash(*map(cast, st)), cast(d_nums), cast(d_summ)))

    def errs(got, ref):
        return {n: (a.double() - b.double()).abs().max().item()
                / (1.0 + b.double().abs().max().item())
                for n, a, b in zip(names, got, ref)}
    got, again = flat(run()), flat(run())
    out = {"bit_identical": all(torch.equal(a, b)
                                for a, b in zip(got, again))}
    if bf16:
        out["vs_plain"] = errs(got, plain())
    else:
        ref = plain(torch.float64)
        out["vs_f64"] = errs(got, ref)
        out["plain_f32_vs_f64"] = errs(plain(), ref)
        with tf32_matmuls():
            tf32 = plain()
        out["tf32_vs_f64"] = errs(tf32, ref)
    out["ms"], out["queued"] = queued_ms(run, K2A_REPS)
    out["plain_ms"] = cuda_ms(plain, 2)
    return out


def k2a_shared_memory(lib, tw) -> dict:
    """K2a's shared memory a block (bytes, f32) by kernel, and for the chain
    kernel the cluster size a launch takes at B=128 and 512 and at the
    other sizes, with how many such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    out = {"slots": lib.pctd_train_bwd_smem_bytes(
        ctypes.byref(tw), 0, 0, 0, None, None)}
    for c, B in ((0, 128), (0, 512), (8, 0), (16, 0)):
        taken, most = ctypes.c_int(), ctypes.c_int()
        b = lib.pctd_train_bwd_smem_bytes(ctypes.byref(tw), 1, c, B,
                                          ctypes.byref(taken),
                                          ctypes.byref(most))
        name = f"chain, B={B}: C={taken.value}" if B else \
            f"chain C={taken.value}"
        out[name] = f"{b} ({most.value} clusters at once)"
    out["proj"] = lib.pctd_train_bwd_smem_bytes(ctypes.byref(tw), 2, 0, 0,
                                                None, None)
    return out


def agreement(a, b) -> float:
    return (a == b).float().mean().item()


def captured(fn):
    """``fn()``'s result and its standard output, which is printed too."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print("\n".join("  | " + ln for ln in buf.getvalue().splitlines()))
    return out, buf.getvalue()


def step_footprint(trainer, batch) -> int:
    """Bytes one train step needs: the trainer's params and Adam moments
    plus the peak allocation the step adds (torch.cuda.
    max_memory_allocated), so tensors of other phases do not count. After
    one step, the step is the step graph's capture and first replay; the
    graph keeps that memory as its own."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    state = sum(t.numel() * t.element_size()
                for t in trainer.leaves + trainer.opt.mu + trainer.opt.nu)
    return state + torch.cuda.max_memory_allocated() - before


def measure_envelope(cfg, corpora, seed: int, dev) -> dict:
    """The step envelope of ``cfg``: the bytes of an f32 step (CE fused in)
    at each batch of ``ENVELOPE_B`` on ``corpora`` (train, val),
    extrapolated linearly to ``ENVELOPE_SHARE`` of the card's memory and
    rounded down to 128; fails if the committed
    ``train.trainer.STEP_ENVELOPE`` entry exceeds it."""
    total = torch.cuda.get_device_properties(dev).total_memory
    foot = {}
    for B in ENVELOPE_B:
        tcfg_e = TrainConfig(batch_size=B, accum_steps=1, seed=seed)
        lb, _ = make_loaders(*corpora, B, seed=seed)
        t = tr.Trainer(cfg, tcfg_e, lb, device=dev)
        it = t.batches()
        t.train_step(next(it))          # first use: panels, caches
        foot[B] = step_footprint(t, next(it))
        del t, it
    torch.cuda.empty_cache()
    (b0, f0), (b1, f1) = sorted(foot.items())
    slope = (f1 - f0) / (b1 - b0)
    fixed = f0 - b0 * slope
    env = int((ENVELOPE_SHARE * total - fixed) / slope) // 128 * 128
    key = (cfg.txt_encoder, cfg.pianotree.num_step)
    committed = tr.step_envelope(cfg)
    print(f"  {key}: an f32 step takes " + ", ".join(
        f"{v / 1e9:.3f} GB at B={k}" for k, v in foot.items())
        + f"; {slope / 1e6:.3f} MB a segment + {fixed / 1e9:.3f} GB; "
        f"{ENVELOPE_SHARE:.0%} of {total} B holds B={env}; committed "
        f"STEP_ENVELOPE {committed}")
    check(committed <= env, f"{key}: the committed envelope {committed} "
          f"exceeds the measured {env}")
    return {"footprint_bytes": foot, "bytes_a_segment": slope,
            "fixed_bytes": fixed, "envelope": env, "committed": committed}


def training_run_phases(args, cfg, dev, counted, step_ms: float, tmp: str
                        ):
    """The phases of the training run: the train CLI (two epochs with
    checkpoints, metric writers and a profile), a resumed run against
    uninterrupted ones, the evaluate CLI on the run's checkpoint, the
    pianotree texture encoder, and the automatic accumulation's envelope.
    ``step_ms`` is ``Trainer.train_step``'s median from the phase
    "training", printed beside the epoch loop's. The runs write under
    ``tmp``; returns (the phases' numbers, the train CLI's run directory)."""
    spec = cfg.pianotree
    T = spec.num_step
    out = {}
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    fused_k = {"K1": tf.frame_fwd, "K2a": tf.frame_bwd,
               "K2b": tf.weight_grads}
    reset = lambda: [setattr(f, "launches", 0) for f in counted]

    def launches_of(ks):
        got = {k: f.launches for k, f in ks.items()}
        others = {f.__name__: f.launches for f in counted
                  if f not in ks.values()}
        return got, others

    # 9d. the training run through the CLI, in this process
    t0 = time.perf_counter()
    argv = ["--epochs", str(RUN_EPOCHS), "--batch-size", str(TRAIN_B),
            "--synthetic-songs", str(RUN_SONGS), "--log-every",
            str(RUN_LOG_EVERY), "--profile", "1", "--result-dir", tmp]
    print(f"  python -m pctd_tpu_torch.cli.train {' '.join(argv)}")
    reset()
    with made_trainers() as made:
        result, text = captured(lambda: cli_train.main(argv))
    torch.cuda.synchronize()
    got, others = launches_of(fused_k)
    steps = RUN_EPOCHS * RUN_STEPS
    run_t, = made
    py = python_steps(run_t)
    print(f"  launches in {RUN_EPOCHS} epochs ({steps} steps, {py} of them "
          f"run by Python, {run_t.step_captures} captures, "
          f"{run_t.step_replays} replays; {RUN_EPOCHS} eval batches): "
          f"{got}; other frame and decode kernels {others}")
    # an eval lets the step graph go: one capture an epoch
    check((run_t.step_captures, run_t.step_replays, py)
          == (RUN_EPOCHS, steps - 1, RUN_EPOCHS + 1),
          f"training-run captures {run_t.step_captures}, replays "
          f"{run_t.step_replays}")
    check(f"corpus: 105 train / 15 val segments (synthetic, {RUN_SONGS} "
          "songs)" in text, "the CLI's corpus line")
    for e in range(1, RUN_EPOCHS + 1):
        check(f"Epoch: {e:02} |" in text, f"epoch line {e}")
    check(got == {"K1": T * (py + RUN_EPOCHS), "K2a": T * py,
                  "K2b": T * py}, f"training-run launches {got}")
    del run_t, made
    check(not any(others.values()),
          f"the training run launched another kernel: {others}")
    val_loss = result["val"]["loss"]
    check(np.isfinite(val_loss) and val_loss > 0, f"val loss {val_loss}")
    check(result["train_steps"] == RUN_STEPS,
          f"steps an epoch: {result['train_steps']}")
    run_dir, = [os.path.join(tmp, d) for d in os.listdir(tmp)
                if d.startswith("result_")]
    for tag in ("epoch", "valid", "final"):
        check(os.path.isfile(os.path.join(run_dir, "models",
                                          f"disvae_{tag}")),
              f"checkpoint {tag}")
    with open(os.path.join(run_dir, "final_metrics.json")) as f:
        check(json.load(f)["val"]["loss"] == val_loss,
              "final_metrics.json")
    with open(os.path.join(run_dir, "writers", "metrics.csv")) as f:
        rows = [ln.split(",")[:2] for ln in f.read().splitlines()[1:]]
    want = ([["train", str(i)] for i in range(0, steps, RUN_LOG_EVERY)]
            + [["val", str(i)] for i in range(0, RUN_EPOCHS,
                                                RUN_LOG_EVERY)])
    check(sorted(rows) == sorted(want), f"metrics.csv rows {rows}")
    traces = os.listdir(os.path.join(run_dir, "profile"))
    trace_mb = sum(os.path.getsize(os.path.join(run_dir, "profile", t))
                   for t in traces) / 1e6
    check(traces == ["train_steps_2_3.json"] and trace_mb > 0,
          f"profile trace {traces}")
    loop_ms = result["train_seconds"] / result["train_steps"] * 1e3
    print(f"  epoch {RUN_EPOCHS}: {result['epoch_seconds']:.3f} s "
          f"({result['train_seconds']:.3f} s of {RUN_STEPS} train steps, "
          f"{loop_ms:.2f} ms a step in the epoch loop, host reads every "
          f"{RUN_LOG_EVERY} steps; Trainer.train_step, which reads every "
          f"step: {step_ms:.2f} ms); val loss {val_loss:.6f}; metrics.csv "
          f"{len(rows)} rows; profile trace {trace_mb:.1f} MB")
    out["run"] = {"epoch_seconds": result["epoch_seconds"],
                  "train_seconds": result["train_seconds"],
                  "steps": RUN_STEPS, "loop_step_ms": loop_ms,
                  "train_step_ms": step_ms, "launches": got,
                  "val_loss": val_loss}
    phase("training run", t0)

    # 9e. resume: 2 steps, a checkpoint, a fresh Trainer restored from it,
    # 2 more steps, against two uninterrupted runs of 4
    t0 = time.perf_counter()
    dcfg = DataConfig()
    train_c, val_c = synthetic_corpora(n_songs=RUN_SONGS, seed=dcfg.seed,
                                       cfg=dcfg)
    loader, _ = make_loaders(train_c, val_c, TRAIN_B, seed=args.seed)
    batches = list(itertools.islice(loader.epoch(), RESUME_STEPS))
    tcfg = TrainConfig(batch_size=TRAIN_B, accum_steps=1, seed=args.seed)
    fresh = lambda **kw: tr.Trainer(cfg, tcfg, None, device=dev, **kw)
    runs = []
    for _ in range(2):
        t = fresh()
        for b in batches:
            t.train_step(b)
        runs.append(t)
    half = fresh(run_paths=RunPaths(root="resume", with_date=False,
                                    base_dir=tmp))
    for b in batches[:2]:
        half.train_step(b)
    half.save_checkpoint("half")
    resumed = fresh()
    resumed.restore_checkpoint(half.run_paths.model_path(half.name, "half"))
    for b in batches[2:]:
        resumed.train_step(b)

    def state(t):
        return t.leaves + t.opt.mu + t.opt.nu

    def diff(a, b):
        """(largest |difference| of the states, of the step-4 metrics)."""
        ds = max((x.detach() - y.detach()).abs().max().item()
                 for x, y in zip(state(a), state(b)))
        dm = max(abs(a.history[-1][k] - b.history[-1][k])
                 for k in dv.METRIC_NAMES)
        return ds, dm

    same = lambda a, b: (all(torch.equal(x, y) for x, y in
                             zip(state(a), state(b)))
                         and a.history[-1] == b.history[-1]
                         and a.grad_norms[-1] == b.grad_norms[-1]
                         and a.opt.count == b.opt.count
                         and a.step_count == b.step_count)
    twice = same(*runs)
    bits = same(resumed, runs[0])
    spread, off = diff(*runs), diff(resumed, runs[0])
    print(f"  two uninterrupted runs of {RESUME_STEPS} steps bit-identical: "
          f"{twice} (max |diff| params+Adam {spread[0]:.3g}, step-4 metrics "
          f"{spread[1]:.3g}); resumed (2 + save + restore + 2) vs "
          f"uninterrupted bit-identical: {bits} (max |diff| {off[0]:.3g}, "
          f"{off[1]:.3g}); step 4 loss {resumed.history[-1]['loss']!r} vs "
          f"{runs[0].history[-1]['loss']!r}")
    if twice:
        check(bits, f"the resumed run differs from the uninterrupted one: "
              f"{off}")
    else:
        check(off[0] <= spread[0] and off[1] <= spread[1],
              f"the resumed run differs by {off}, more than two "
              f"uninterrupted runs do: {spread}")
    out["resume"] = {"uninterrupted_bit_identical": twice,
                     "resumed_bit_identical": bits,
                     "uninterrupted_max_diff": spread,
                     "resumed_max_diff": off}
    del runs, half, resumed
    phase("resume", t0)

    # 9f. the evaluate CLI on the run's final checkpoint, deterministic,
    # through the kernels and through the plain frame path
    t0 = time.perf_counter()
    ck = os.path.join(run_dir, "models", "disvae_final")
    ev_argv = ["--checkpoint", ck, "--deterministic", "--batch-size",
               str(TRAIN_B), "--synthetic-songs", str(RUN_SONGS)]
    print(f"  python -m pctd_tpu_torch.cli.evaluate {' '.join(ev_argv)}")
    reset()
    ev, _ = captured(lambda: cli_evaluate.main(ev_argv))
    k1_eval = tf.frame_fwd.launches
    with plain_frames():
        ev_plain, _ = captured(lambda: cli_evaluate.main(ev_argv))
    check(tf.frame_fwd.launches == k1_eval == T * ev["num_batches"],
          f"evaluate K1 launches {k1_eval}, then {tf.frame_fwd.launches} "
          "with the plain frames")
    ev_err = max(rel(ev[k], ev_plain[k]) for k in dv.METRIC_NAMES)
    print(f"  deterministic evaluate, kernels vs the plain frames: loss "
          f"{ev['loss']!r} vs {ev_plain['loss']!r}; 11 metrics max rel err "
          f"{ev_err:.3g}")
    check(all(np.isfinite(ev[k]) for k in dv.METRIC_NAMES),
          f"evaluate {ev}")
    check(ev_err <= LOSS_RTOL, f"evaluate vs plain rel err {ev_err}")
    out["evaluate"] = {"metrics": ev, "vs_plain_rel_err": ev_err}
    phase("evaluate", t0)

    # 9g. the pianotree texture encoder: its detrend on the card against
    # the numpy copy, and training through K1/K2 with step 1 held against
    # the plain path
    t0 = time.perf_counter()
    cfg_pt = dataclasses.replace(cfg, txt_encoder="pianotree")
    idx = np.arange(TRAIN_B)
    pr = torch.as_tensor(train_c.pr[idx % len(train_c)], device=dev)
    chord = torch.as_tensor(train_c.chord[idx % len(train_c)], device=dev)
    shift = torch.as_tensor(idx % 12 - 6, dtype=torch.int32, device=dev)
    x, c, pr_mat, dt_x = tr.batch_features(pr, chord, shift, cfg_pt)
    dt_np = detrend_pianotree_batch(x.cpu().numpy(), c.cpu().numpy())
    exact = np.array_equal(dt_x.cpu().numpy(), dt_np)
    print(f"  detrend on the card vs the numpy copy, B={TRAIN_B} over 12 "
          f"shifts: equal {exact}")
    check(exact, "the device detrend differs from the numpy copy")
    pt_train, pt_val = make_loaders(train_c, val_c, TRAIN_B, seed=args.seed)
    pt = tr.Trainer(cfg_pt, tcfg, pt_train, pt_val, device=dev)
    first = next(make_loaders(train_c, val_c, TRAIN_B,
                              seed=args.seed)[0].epoch())
    fx = tr.batch_features(*pt._to_device(first), cfg_pt)
    with plain_frames():
        ref_m, ref_g = tr.loss_and_grads(
            pt.params, cfg_pt, tcfg, schedules.train_params_at(0, tcfg),
            torch.Generator(device=dev).manual_seed(tcfg.seed), *fx[:3],
            1, fx[3])
    ref_m = {k: v.item() for k, v in ref_m.items()}
    ref_norm = global_norm(ref_g).item()
    del ref_g
    reset()
    pt.train_steps(PT_STEPS)
    pt_val_m = pt.eval_epoch()
    torch.cuda.synchronize()
    got, others = launches_of(fused_k)
    n_val, py = len(pt_val), python_steps(pt)
    print(f"  launches in {PT_STEPS} pianotree train steps ({py} run by "
          f"Python) + {n_val} eval batch(es): {got}; other kernels {others}")
    check(got == {"K1": T * (py + n_val), "K2a": T * py, "K2b": T * py},
          f"pianotree launches {got}")
    check(not any(others.values()),
          f"the pianotree path launched another kernel: {others}")
    for i, m in enumerate(pt.history):
        print(f"  step {i + 1}: loss {m['loss']:.6f} kl_rhy "
              f"{m['kl_rhy']:.6f} grad norm {pt.grad_norms[i]:.6f} "
              f"({pt.step_seconds[i] * 1e3:.1f} ms)")
        check(all(np.isfinite(v) for v in m.values()),
              f"pianotree step {i + 1} {m}")
    check(all(np.isfinite(v) for v in pt_val_m.values()),
          f"pianotree val {pt_val_m}")
    pt_err = max(rel(pt.history[0][k], ref_m[k]) for k in dv.METRIC_NAMES)
    pt_norm_err = rel(pt.grad_norms[0], ref_norm)
    print(f"  step 1 vs the plain path on the card: loss "
          f"{pt.history[0]['loss']!r} vs {ref_m['loss']!r}; 11 metrics max "
          f"rel err {pt_err:.3g}; grad norm {pt.grad_norms[0]!r} vs "
          f"{ref_norm!r} (rel err {pt_norm_err:.3g})")
    check(pt_err <= LOSS_RTOL, f"pianotree step 1 rel err {pt_err}")
    check(pt_norm_err <= NORM_RTOL,
          f"pianotree step 1 grad norm rel err {pt_norm_err}")
    pt_step_ms = float(np.median(pt.step_seconds[1:])) * 1e3
    pt_prof = profile_step(pt)
    leaves = tr.param_list(pt.params["txt_enc"])

    def encoder_fwd_bwd():
        dist = txt_enc.apply_pianotree(pt.params["txt_enc"], fx[3],
                                       txt_enc.lengths_from_detrended(fx[3]))
        torch.autograd.grad((dist.mean.sum() + dist.std.sum()), leaves)

    enc_prof = profile_call(encoder_fwd_bwd,
                            "pianotree encoder forward + backward")
    enc_ms = (enc_prof.get("device_busy_ms") if enc_prof["measured"]
              else None)
    print(f"  pianotree train step (median of steps 2..{PT_STEPS}): "
          f"{pt_step_ms:.2f} ms; the encoder's device time, forward + "
          f"backward at B={TRAIN_B}: {enc_ms} ms")
    out["pianotree"] = {"step_ms_median_2_to_n": pt_step_ms,
                        "step1_metric_rel_err": pt_err,
                        "step1_grad_norm_rel_err": pt_norm_err,
                        "launches": got, "profile": pt_prof,
                        "encoder_device_ms": enc_ms}
    del pt
    phase("pianotree variant", t0)

    # 9h. the automatic accumulation's envelope: the bytes of an f32 step
    # (CE fused in) at two batch sizes, extrapolated to 90% of the card
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    envelopes = {enc: measure_envelope(
        dataclasses.replace(cfg, txt_encoder=enc), (train_c, val_c),
        args.seed, dev) for enc in ("conv", "pianotree")}
    auto = tr.auto_accum_steps(cfg, TrainConfig(batch_size=TRAIN_B), dev)
    print(f"  card memory {total} B (device_mem.MEASURED_HBM "
          f"{device_mem.MEASURED_HBM}); auto_accum_steps at B={TRAIN_B}: "
          f"{auto}")
    check(auto == 1, f"auto_accum_steps at B={TRAIN_B} is {auto}")
    out["envelope"] = {"card_bytes": total, **envelopes}
    phase("auto accumulation", t0)
    return out, run_dir


def envelope_epochs(cfg, seed: int, dev) -> dict:
    """An f32 Trainer of ``cfg`` at its committed step envelope's batch B:
    a train epoch of three steps (the step graph's eager warm-up, its
    capture and a replay), an eval epoch of one batch of B, which has the
    step's memory once the graph lets it go, and a second train epoch (a
    capture and two replays). Fails if one runs out of memory; returns the
    allocator's peak and the reserved bytes of each."""
    B = tr.step_envelope(cfg)
    val_c = segments(np.random.RandomState(seed), B)
    n = -(-3 * B // 12)             # three steps over the 12 shifts
    train_c = SegmentCorpus(val_c.pr[:n], val_c.chord[:n])
    train_b, val_b = make_loaders(train_c, val_c, B, seed=seed)
    t = tr.Trainer(cfg, TrainConfig(batch_size=B, seed=seed), train_b, val_b,
                   device=dev)
    out = {"batch": B, "accum": t.accum}
    for what, run in (("train", t.train_epoch), ("eval", t.eval_epoch),
                      ("train again", t.train_epoch)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0 = time.perf_counter()
        m = run()
        torch.cuda.synchronize()
        out[what] = {"s": time.perf_counter() - s0,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "reserved_bytes": torch.cuda.memory_reserved(),
                     "loss": m["loss"]}
        print(f"  B={B} {what}: {out[what]['s']:.2f} s, loss "
              f"{m['loss']:.6f}, peak allocated "
              f"{out[what]['peak_bytes'] / 2**30:.2f} GiB, reserved "
              f"{out[what]['reserved_bytes'] / 2**30:.2f} GiB")
        check(np.isfinite(m["loss"]), f"B={B} {what}: loss {m['loss']}")
    out.update(captures=t.step_captures, replays=t.step_replays)
    check((t.accum, t.step_captures, t.step_replays) == (1, 2, 5),
          f"at the envelope: accumulation {t.accum}, captures "
          f"{t.step_captures}, replays {t.step_replays}")
    del t
    torch.cuda.empty_cache()
    return out


def daemon_inputs(seed: int, tmp: str) -> dict:
    """Input MIDI written in-process from synthetic songs: two files ("a",
    "b") of each request size of ``DAEMON_BARS`` and, for arrange, one
    with a track named melody."""
    files = {}
    for i, (n, bars) in enumerate(DAEMON_BARS.items()):
        for j, tag in enumerate("ab"):
            music = synthetic_song(np.random.RandomState(seed + 10 * i + j),
                                   n_bars=bars)
            files[f"{tag}{n}"] = os.path.join(tmp, f"{tag}{n}.mid")
            music.write_midi(files[f"{tag}{n}"])
    music = synthetic_song(np.random.RandomState(seed + 99), n_bars=20)
    music.track_name_list = ["melody", "bridge", "piano"]
    files["melody"] = os.path.join(tmp, "melody.mid")
    music.write_midi(files["melody"])
    return files


def daemon_requests(files: dict, n: int, out: str) -> dict:
    """{name: (request, decoded rows)}: each op of the daemon on the files
    of n windows."""
    a, b = files[f"a{n}"], files[f"b{n}"]
    o = lambda name: os.path.join(out, f"{name}_{n}.mid")
    reqs = {
        "style_transfer/chord": {"op": "style_transfer", "content": a,
                                 "style": b, "out": o("st_chord"),
                                 "fix": "chord"},
        "style_transfer/texture": {"op": "style_transfer", "content": a,
                                   "style": b, "out": o("st_texture"),
                                   "fix": "texture"},
        "variation": {"op": "variation", "input": a, "out": o("variation"),
                      "scale": 0.5, "seed": 1},
        "prior/texture": {"op": "prior", "input": a, "out": o("prior_t"),
                          "sample": "texture", "seed": 2},
        "prior/chord": {"op": "prior", "input": a, "out": o("prior_c"),
                        "sample": "chord", "seed": 3},
        "prior/both": {"op": "prior", "input": a, "out": o("prior_b"),
                       "sample": "both", "seed": 4},
        "interp": {"op": "interp", "a": a, "b": b,
                   "out": os.path.join(out, f"interp_{n}_%d.mid"),
                   "count": DAEMON_INTERP, "what": "chord"},
    }
    return {k: (r, n * (DAEMON_INTERP if k == "interp" else 1))
            for k, r in reqs.items()}


def counted_request(server, req: dict, counted, want: dict):
    """One request through ``server.handle`` with every launch count set to
    0 just before: (reply, host ms, the counts). Fails unless the reply is
    ok and the counts are ``want`` (by wrapper name; 0 where not named)."""
    for f in counted:
        f.launches = 0
    s0 = time.perf_counter()
    reply = server.handle(dict(req))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - s0) * 1e3
    got = {f.__name__: f.launches for f in counted}
    check(reply.get("ok") is True, f"daemon {req['op']}: {reply}")
    expect = {k: want.get(k, 0) for k in got}
    check(got == expect, f"daemon {req['op']}: launches {got}, expected "
          f"{expect}")
    return reply, ms, got


def request_breakdown(server, files: dict, n: int, out: str) -> dict:
    """A chord-fixed style transfer of n windows by stage, each stage synced
    (host ms): ingest (``midi_to_windows`` of both files), tensorize,
    encode, decode (the K4 chunks and the host code around them), MIDI
    writing; the notes written; the front end's share of the stages' sum;
    and K4's device ms for one chunk and for the request's chunks in the
    launches they share in the Sampler (each queued behind a sleep
    kernel)."""
    spec, dev, sync = server.spec, server.s.device, torch.cuda.synchronize
    fb = server.s.fixed_batch
    t = {}
    s0 = time.perf_counter()
    wa = midi_to_windows(files[f"a{n}"], server.max_windows)
    wb = midi_to_windows(files[f"b{n}"], server.max_windows)
    t["ingest"] = (time.perf_counter() - s0) * 1e3
    s0 = time.perf_counter()
    pa = window_features(wa[0], wa[2], spec, dev)
    pb = window_features(wb[0], wb[2], spec, dev)
    sync()
    t["tensorize"] = (time.perf_counter() - s0) * 1e3
    s0 = time.perf_counter()
    d_chd, d_rhy = server.s.encode(pb[0], pa[1])
    sync()
    t["encode"] = (time.perf_counter() - s0) * 1e3
    s0 = time.perf_counter()
    grids = server.s.decode(d_chd.mean, d_rhy.mean)
    t["decode"] = (time.perf_counter() - s0) * 1e3
    s0 = time.perf_counter()
    notes = cli_serve.write_grids(os.path.join(out, f"breakdown_{n}.mid"),
                                  grids, wa[3], spec)
    t["write"] = (time.perf_counter() - s0) * 1e3
    t["sum"] = sum(t.values())
    t["notes"] = notes
    t["front_end_share"] = (t["ingest"] + t["tensorize"]
                            + t["write"]) / t["sum"]
    z = torch.cat([d_chd.mean, d_rhy.mean], -1)
    z = torch.cat([z, z.new_zeros((-len(z) % fb, z.shape[1]))])
    inputs = [ptd.decode_inputs(server.s.params["dec"], server.cfg,
                                z[lo:lo + fb]) for lo in range(0, len(z), fb)]
    for key, fn in (("k4_chunk_device_ms", lambda: full_decoder
                     .decode_grid_full(server.s.fw, spec, *inputs[0])),
                    ("k4_device_ms", lambda: full_decoder
                     .decode_grid_full_chunks(server.s.fw, spec, inputs))):
        t[key], queued = queued_ms(fn, DAEMON_REPS)
        check(queued, f"{key}: the host did not enqueue the timed calls "
              "within the sleep kernel")
    return t


def daemon_subprocess(files: dict, first: str, epoch: str, tmp: str) -> dict:
    """``python -m pctd_tpu_torch.cli.serve --checkpoint first`` on the card
    with the request sequence of the JAX daemon's end-to-end test (reload
    to ``epoch``), malformed lines included: exits 0 with the same pattern
    of replies."""
    out1, out2 = (os.path.join(tmp, f"sub_{k}.mid") for k in ("st", "var"))
    reqs = [json.dumps(r) for r in [
        {"op": "ping"},
        {"op": "style_transfer", "content": files["a8"],
         "style": files["b8"], "out": out1, "fix": "chord"},
        {"op": "variation", "input": files["a8"], "out": out2, "scale": 0.5,
         "seed": 1},
        {"op": "nonsense"}]]
    reqs += ["{not json}", "[1, 2, 3]"]
    reqs += [json.dumps(r) for r in [
        {"op": "reload", "checkpoint": epoch},
        {"op": "reload", "checkpoint": os.path.join(tmp, "missing")},
        {"op": "variation", "input": files["a8"], "out": out2, "scale": 0.5,
         "seed": 2},
        {"op": "stats"},
        {"op": "quit"}]]
    root = os.path.dirname(os.path.abspath(__file__))
    argv = ["-m", "pctd_tpu_torch.cli.serve", "--checkpoint", first,
            "--fixed-batch", "16", "--max-windows", "64"]
    print(f"  python {' '.join(argv)} < {len(reqs)} lines")
    s0 = time.perf_counter()
    res = subprocess.run([sys.executable, *argv],
                         input="\n".join(reqs) + "\n", cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - s0
    check(res.returncode == 0, f"the daemon exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    replies = [ln for ln in lines if "ok" in ln]
    print("  | " + "\n  | ".join(json.dumps(ln)[:160] for ln in lines))
    ok = [r.get("ok") for r in replies]
    check(ok == [True, True, True, False, False, False, True, False, True,
                 True, True], f"the daemon's replies {ok}")
    check(any(ln.get("ready") for ln in lines[:3])
          and lines[0] == {"loaded": first}, "the daemon's first lines")
    check(replies[1]["windows"] == 8 and "unknown op" in
          replies[3]["error"] and replies[6]["reloaded"] == epoch
          and replies[10].get("bye"), "the daemon's replies")
    stats = replies[9]["stats"]
    check(stats["variation"]["count"] == 2 and stats["reload"]["count"] == 2,
          f"the daemon's stats {stats}")
    check(replies[1]["notes"] > 0, "the daemon wrote no notes")
    for out, r in ((out1, replies[1]), (out2, replies[8])):
        check(len(MidiFile.read(out).tracks) == (1 if r["notes"] else 0),
              f"{out}: tracks for {r['notes']} notes")
    return {"wall_s": wall, "stats": stats}


def serving_daemon_phase(args, cfg, dev, counted, card: str, models: str,
                         params: dict, tmp: str) -> dict:
    """The serving daemon (``pctd_tpu_torch.cli.serve``) at canonical widths
    on the training run's checkpoints and on the random weights ``params``
    saved as a checkpoint: the run's 18 steps decode eos at every frame's
    first slot, the random weights a note at every slot, so the two bound
    the notes a request writes and the gates see both decisions. MIDI in,
    MIDI out, every valid request ok, K4 launched once a run of the
    fixed-batch chunks of decoded rows that share a launch (K3 32 times a
    chunk on the pallas route) and nothing else launched; the grids
    against the CPU plain path; reload; the daemon as a process; the
    generate and arrange CLIs. Prints each op's p50 by
    weights, fixed batch and request size."""
    t0 = time.perf_counter()
    spec = cfg.pianotree
    final, epoch = (os.path.join(models, f"disvae_{k}")
                    for k in ("final", "epoch"))
    out_dir = os.path.join(tmp, "daemon")
    os.makedirs(out_dir)
    K4, K3 = (full_decoder.decode_grid_full.__name__,
              ar_decoder.frame_decode.__name__)
    chunks = lambda rows, fb: -(-rows // fb)

    def k4_launches(srv, rows):
        """K4 launches of a decode of ``rows`` rows: a launch a run of the
        fixed-batch chunks that share one."""
        fb = srv.s.fixed_batch
        cap = full_decoder.groups_at_once(srv.s.fw, spec, dev)
        return len(full_decoder.launch_runs(chunks(rows, fb), fb, cap))

    out = {"card": card}
    total = collections.Counter()

    def request(srv, req, want):
        reply, ms, got = counted_request(srv, req, counted, want)
        total.update(got)
        return reply, ms

    # inputs: MIDI written in-process; ingest's host time a file
    files = daemon_inputs(args.seed, tmp)
    ingest = {}
    for name, path in files.items():
        times, got = [], None
        for _ in range(DAEMON_REPS):
            s0 = time.perf_counter()
            got = midi_to_windows(path, 64)
            times.append((time.perf_counter() - s0) * 1e3)
        ingest[name] = {"windows": len(got[0]),
                        "midi_to_windows_ms": float(np.median(times))}
    print("  inputs (windows, midi_to_windows host ms, median of "
          f"{DAEMON_REPS}): " + ", ".join(
              f"{k} {v['windows']} {v['midi_to_windows_ms']:.2f}"
              for k, v in ingest.items()))
    check(all(ingest[f"{t}{n}"]["windows"] == n for n in DAEMON_BARS
              for t in "ab"), f"input windows {ingest}")
    out["ingest"] = ingest

    scfg = ckpt.load_model(final, cfg, 0, "cpu")[1]
    check(scfg == cfg, f"the checkpoint's config {scfg}")
    notes_ck = os.path.join(tmp, "random")
    ckpt.save_state(notes_ck, params, Adam(tr.param_list(params),
                                           TrainConfig()), 0,
                    torch.Generator(), cfg)
    weights = {"run": final, "random": notes_ck}

    def server(path, fb=16, route="full", device=dev):
        return cli_serve.Server(Sampler(
            ckpt.load_model(path, cfg, 0, device)[0], scfg,
            frame_decoder=route, fixed_batch=fb, device=device),
            spec, 64, cfg=scfg)

    # each op at 8 and 64 windows, at fixed batch 16 and 128, counted
    p50, breakdown = {}, {}
    for wname, path in weights.items():
        for fb in DAEMON_FB:
            srv = server(path, fb)
            warm = daemon_requests(files, 8, out_dir)["style_transfer/chord"]
            request(srv, warm[0], {K4: 1})
            for n in DAEMON_BARS:
                for name, (req, rows) in daemon_requests(files, n,
                                                         out_dir).items():
                    times = []
                    for _ in range(DAEMON_REPS):
                        reply, ms = request(srv, req,
                                            {K4: k4_launches(srv, rows)})
                        times.append(ms)
                    check(reply["windows"] == n, f"{name}: {reply}")
                    p50[f"{wname} fb={fb} n={n} {name}"] = float(
                        np.median(times))
            breakdown[f"{wname} fb={fb} n=64"] = request_breakdown(
                srv, files, 64, out_dir)
            del srv
    print(f"  daemon p50 ms a request ({card}; host clock, MIDI in to MIDI "
          f"out, median of {DAEMON_REPS}):")
    for wname in weights:
        for fb in DAEMON_FB:
            for n in DAEMON_BARS:
                key = f"{wname} fb={fb} n={n} "
                print(f"    {key}: " + ", ".join(
                    f"{k[len(key):]} {v:.2f}" for k, v in p50.items()
                    if k.startswith(key)))
    for k, t in breakdown.items():
        print(f"  style_transfer {k} by stage (host ms, synced): " + ", ".join(
            f"{s} {t[s]:.2f}" for s in ("ingest", "tensorize", "encode",
                                        "decode", "write", "sum"))
            + f"; {t['notes']} notes; front end {t['front_end_share']:.1%} "
            f"of it; K4 {t['k4_chunk_device_ms']:.3f} device ms a chunk, "
            f"{t['k4_device_ms']:.3f} a request")
    out.update({"p50_ms": p50, "breakdown": breakdown})

    # the K3 route (--frame-decoder pallas): 32 K3 launches a chunk
    srv = server(final, fb=16, route="frame")
    req, rows = daemon_requests(files, 64, out_dir)["style_transfer/chord"]
    reply, ms = request(srv, req, {K3: spec.num_step * chunks(rows, 16)})
    print(f"  --frame-decoder pallas (K3) style transfer of 64 windows at "
          f"fb=16: {ms:.2f} ms, {spec.num_step * chunks(rows, 16)} K3 "
          "launches, no K4")
    out["k3_route_st64_fb16_ms"] = ms
    del srv

    # the grids against the CPU plain path, and the written MIDI against
    # write_demo of Sampler.swap's grids, with each weight set
    wa, wb = (midi_to_windows(files[k], 64) for k in ("a8", "b8"))
    out["vs_cpu_plain"] = {}
    for wname, path in weights.items():
        srv, cpu = server(path), server(path, device="cpu")
        pa, pb = (window_features(w[0], w[2], spec, dev)
                  for w in (wa, wb))
        grids = srv.s.swap(pa[0], pb[0], pa[1], pb[1], fix_rhy=False,
                           fix_chd=True)
        want = cpu.s.swap(pa[0].cpu(), pb[0].cpu(), pa[1].cpu(),
                          pb[1].cpu(), fix_rhy=False, fix_chd=True)
        agree = float((grids == want).mean())
        lens = (grids[..., 0] != spec.pitch_eos).cumprod(-1).sum(-1)
        served = os.path.join(out_dir, f"gate_served_{wname}.mid")
        composed = os.path.join(out_dir, f"gate_composed_{wname}.mid")
        srv.handle({"op": "style_transfer", "content": files["a8"],
                    "style": files["b8"], "out": served, "fix": "chord"})
        dm.write_demo(composed, [[dm.grid_to_pr_and_notes(
            g, bpm=wa[3], spec=spec)[1] for g in grids]], ["generated"],
            bpm=wa[3], shift_beat=8)
        same = open(served, "rb").read() == open(composed, "rb").read()
        print(f"  {wname} weights, style transfer of 8 windows: grid "
              f"agreement with the CPU plain path {agree:.6f} (>= {AGREE}); "
              f"frame lengths {np.bincount(lens.ravel(), minlength=16)}; "
              f"served MIDI equals write_demo of Sampler.swap's grids: "
              f"{same}")
        check(agree >= AGREE, f"{wname}: daemon grids vs the CPU plain "
              f"path {agree}")
        check(same, f"{wname}: the served MIDI is not write_demo of the "
              "swap's grids")
        out["vs_cpu_plain"][wname] = agree
        del srv, cpu
    check(lens.sum() > 0, "the random weights decode no notes: the gate "
          "would not see a note's decisions")

    # a request of several chunks with a partial last one against the CPU:
    # interp of 64 windows at fixed batch 128 decodes 320 rows in chunks of
    # 128, 128 and 64 (random weights)
    wa, wb = (midi_to_windows(files[k], 64) for k in ("a64", "b64"))
    srv, cpu = (server(notes_ck, fb=128, device=d) for d in (dev, "cpu"))
    pa, pb = (window_features(w[0], w[2], spec, dev) for w in (wa, wb))
    kw = dict(interp_chd=True, interp_rhy=False, int_count=DAEMON_INTERP)
    for f in counted:
        f.launches = 0
    grids = srv.s.interp(pa[0], pa[1], pb[0], pb[1], **kw)
    got = {f.__name__: f.launches for f in counted}
    want = cpu.s.interp(*(t.cpu() for t in (*pa, *pb)), **kw)
    rows = len(wa[0]) * DAEMON_INTERP
    agree = float((grids == want).mean())
    print(f"  random weights, interp of {len(wa[0])} windows ({rows} rows, "
          f"{chunks(rows, 128)} chunks of 128, the last partial): grid "
          f"agreement with the CPU plain path {agree:.6f} (>= {AGREE}); "
          f"launches {got}")
    check(rows % 128 and got == {k: (k4_launches(srv, rows) if k == K4
                                     else 0) for k in got},
          f"multi-chunk interp: {rows} rows, launches {got}")
    check(agree >= AGREE, f"multi-chunk interp vs the CPU plain path {agree}")
    out["vs_cpu_plain"]["random interp 64 fb=128"] = agree
    del srv, cpu

    # reload: the epoch checkpoint, other weights of the same widths, and
    # other widths (refused, nothing changes)
    req = {"op": "style_transfer", "content": files["a8"],
           "style": files["b8"], "fix": "chord"}

    def served_bytes(s, name):
        path = os.path.join(out_dir, f"reload_{name}.mid")
        check(s.handle(dict(req, out=path))["ok"] is True, name)
        return open(path, "rb").read()

    wide = os.path.join(tmp, "other_widths")
    tiny = tiny_model_config()
    p_tiny = dv.init_params(tiny, seed=args.seed, device="cpu")
    ckpt.save_state(wide, p_tiny, Adam(tr.param_list(p_tiny),
                                       TrainConfig()), 0,
                    torch.Generator(), tiny)
    srv = server(final)
    before = served_bytes(srv, "final")
    same_params = all(torch.equal(a, b) for a, b in zip(
        ckpt.load_state(final)["params"].values(),
        ckpt.load_state(epoch)["params"].values()))
    reloads = {}
    for name, path in (("epoch", epoch), ("random", notes_ck)):
        check(srv.handle({"op": "reload", "checkpoint": path})["ok"] is True,
              f"reload {name}")
        got = served_bytes(srv, name)
        reloads[name] = got == served_bytes(server(path), f"{name}_fresh")
        check(reloads[name], f"after reload to {name} the daemon does not "
              "serve what a fresh daemon on it serves")
    check(got != before, "the reloaded weights serve the old bytes")
    buf = io.StringIO()
    cli_serve.serve_lines(srv, [json.dumps({"op": "reload",
                                            "checkpoint": wide})], buf)
    refused = json.loads(buf.getvalue())
    check(refused["ok"] is False and "do not match" in refused["error"],
          f"reload of other widths: {refused}")
    check(served_bytes(srv, "after_refusal") == got,
          "a refused reload changed what the daemon serves")
    print(f"  reload: the epoch checkpoint (params equal to final's: "
          f"{same_params}) and the random weights serve a fresh "
          f"daemon's bytes; other widths refused "
          f"({refused['error'][:80]}...), bytes unchanged")
    out["reload"] = {"epoch_params_equal_final": same_params, **reloads}
    del srv

    # the daemon as a process
    out["subprocess"] = daemon_subprocess(files, notes_ck, epoch, tmp)
    print(f"  the daemon process: exit 0 in {out['subprocess']['wall_s']:.1f}"
          " s, replies as the JAX daemon's test asserts")

    # the generate and arrange CLIs on the card
    clis = {}
    for name, main_, argv, tracks, k4 in (
            ("generate", cli_generate.main,
             ["--chords", "C-Am-F-G", "--bars", "8", "--samples", "2",
              "--texture-from", files["b8"]], ["sample_0", "sample_1"], 2),
            ("generate (prior)", cli_generate.main,
             ["--chords", "Am D7 G", "--samples", "2", "--seed", "5"],
             ["sample_0", "sample_1"], 2),
            ("arrange", cli_arrange.main,
             [files["melody"], "--given-bars", "4"],
             ["melody", "arranged_acc"], 1)):
        path = os.path.join(out_dir, re.sub(r"\W+", "_", name) + ".mid")
        argv = argv + ["--checkpoint", notes_ck, "--out", path]
        for f in counted:
            f.launches = 0
        s0 = time.perf_counter()
        captured(lambda: main_(argv))
        ms = (time.perf_counter() - s0) * 1e3
        got = {f.__name__: f.launches for f in counted}
        names = [t.name for t in MidiFile.read(path).tracks]
        print(f"  {name}: {ms:.1f} ms, tracks {names}, launches {got}")
        check(names == tracks, f"{name}: tracks {names}")
        check(got == {k: (k4 if k == K4 else 0) for k in got},
              f"{name}: launches {got}")
        clis[name] = ms
    out["cli_ms"] = clis
    out["launches"] = {"K4": total[K4], "K3": total[K3]}
    print(f"  launches in the counted requests: {dict(total)}")
    phase("serving daemon", t0)
    return out


def stretch_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` at the 32-bar stretch: 128 steps, 32 chord beats."""
    return dataclasses.replace(cfg, pianotree=PianoTreeSpec(num_step=128),
                               chord=ChordSpec(num_step=32))


def counts(counted) -> dict:
    return {f.__name__: f.launches for f in counted}


def reset_counts(counted) -> None:
    for f in counted:
        f.launches = 0


@contextlib.contextmanager
def recorded_plain_frames(hs: list):
    """Inside this context the K3 route of ``decode_grid`` runs
    ``frame_decode_plain`` on the card and appends each frame's time hidden
    to ``hs``; the kernel route is restored on exit."""
    kernel_route = ar_decoder.frame_decode

    def plain(fw, spec, h, sos_emb, **kw):
        hs.append(h)
        return ar_decoder.frame_decode_plain(fw, spec, h, sos_emb)

    ar_decoder.frame_decode = plain
    try:
        yield
    finally:
        ar_decoder.frame_decode = kernel_route


def first_frame_margins(fw, spec, got, want, hs, dev) -> list:
    """For each row whose grid ``got`` (the kernel route's) differs from
    ``want`` (the plain route's, whose frames' time hiddens are ``hs``):
    the plain version's margin (:func:`root_margins`) at the first
    differing decision of the first differing frame."""
    got, want = (torch.as_tensor(a, device=dev) for a in (got, want))
    B, T = got.shape[:2]
    diff = (got != want).reshape(B, T, -1).any(-1)
    margins = []
    for r in diff.any(1).nonzero()[:, 0].tolist():
        t = int(diff[r].int().argmax())
        hid, gi = ar_decoder.frame_projection(fw, hs[t][r:r + 1])
        *_, pl, dl = ar_decoder.slot_chain_plain(fw, spec, hid, gi,
                                                 logits=True)
        margins.append(root_margins(got[r:r + 1, t], want[r:r + 1, t],
                                    pl, dl).item())
    return margins


def stretch_serving_phase(args, dev, counted, gen, rng) -> dict:
    """The stretch (``stretch_config``) served at canonical width in f32
    through ``Sampler(fixed_batch=128)``: the four workflows at n = 1, 37,
    128 (K4 once a chunk, nothing else), a swap of 128 against K4's plain
    version on the card and K4's bits over two launches, K4 at T=128 timed
    queued behind a sleep kernel beside its bound and its plain version;
    the K3 route at n=128 in f32 (128 K3 launches a chunk, against K4's
    grids) and bf16 (against the plain bf16 route on the card, each
    differing row's first difference a near-tie)."""
    t0 = time.perf_counter()
    cfg = stretch_config(ModelConfig())
    spec = cfg.pianotree
    T = spec.num_step
    K4, K3 = full_decoder.decode_grid_full, ar_decoder.frame_decode
    params = dv.init_params(cfg, seed=args.seed, device=dev)
    sampler = Sampler(params, cfg, fixed_batch=TRAIN_B, device=dev)
    warm_pr, warm_c = requests(rng, 4, T)
    sampler.swap(warm_pr, warm_pr, warm_c, warm_c, True, True)
    reset_counts(counted)
    serving, chunks = serve_workflows(sampler, STRETCH_SIZES, rng, gen)
    got = counts(counted)
    print(f"  launches in {chunks} decode chunks of <= {TRAIN_B} rows: "
          f"{got}")
    check(got[K4.__name__] == chunks and sum(got.values()) == chunks,
          f"stretch serving launches {got}, expected {chunks} K4 and "
          "nothing else")

    pr, c = requests(rng, TRAIN_B, T)
    d_chd, d_rhy = sampler.encode(pr, c)
    inputs = ptd.decode_inputs(params["dec"], cfg, torch.cat(
        [d_chd.mean, d_rhy.mean], -1))
    served = sampler.swap(pr, pr, c, c, True, True)
    plain = full_decoder.decode_grid_full_plain(sampler.fw, spec, *inputs)
    ag = agreement(torch.as_tensor(served, device=dev), plain)
    once, twice = K4(sampler.fw, spec, *inputs), K4(sampler.fw, spec,
                                                       *inputs)
    same = torch.equal(once, twice)
    eos = once[..., 0] == spec.pitch_eos
    hist = torch.bincount(torch.where(
        eos.any(-1), eos.int().argmax(-1) + 1, spec.max_simu_note - 1)
        .flatten().long(), minlength=16).tolist()
    print(f"  served swap n={TRAIN_B} vs K4's plain version on the card: "
          f"grid agreement {ag:.6f}; two launches bit-identical: {same}; "
          f"frame lengths {hist}")
    check(ag >= AGREE, f"stretch swap vs K4's plain version {ag}")
    check(same, "stretch K4: two launches differ")
    k4_ms, ok = queued_ms(lambda: K4(sampler.fw, spec, *inputs),
                          DECODE_REPS["K4"])
    check(ok, "K4 T=128: the host did not enqueue the timed calls within "
          "the sleep kernel")
    k4_plain_ms = cuda_ms(lambda: full_decoder.decode_grid_full_plain(
        sampler.fw, spec, *inputs), 1)
    k4_bound, k4_by = bound_ms(*full_work(sampler.fw, spec, TRAIN_B))
    print(f"  K4 T={T} B={TRAIN_B} (queued): {k4_ms:.4f} ms; plain "
          f"{k4_plain_ms:.3f} ms; bound {k4_bound:.4f} ms ({k4_by}), "
          f"{k4_bound / k4_ms:.3%} of it")

    f_sampler = Sampler(params, cfg, frame_decoder="frame",
                        fixed_batch=TRAIN_B, device=dev)
    f_sampler.swap(warm_pr, warm_pr, warm_c, warm_c, True, True)
    reset_counts(counted)
    s0 = time.perf_counter()
    via_k3 = f_sampler.swap(pr, pr, c, c, True, True)
    torch.cuda.synchronize()
    k3_ms = (time.perf_counter() - s0) * 1e3
    got_k3 = counts(counted)
    ag_k3 = float((via_k3 == served).mean())
    print(f"  K3 route swap n={TRAIN_B}: {k3_ms:.2f} ms, launches {got_k3};"
          f" agreement with K4's grids {ag_k3:.6f}")
    check(got_k3[K3.__name__] == T and sum(got_k3.values()) == T,
          f"K3 route launches {got_k3}, expected {T} K3")
    check(ag_k3 >= AGREE, f"stretch K3 route vs K4 grids {ag_k3}")

    cfg_b = dataclasses.replace(cfg, compute_dtype="bfloat16")
    b_sampler = Sampler(params, cfg_b, frame_decoder="frame",
                        fixed_batch=TRAIN_B, device=dev)
    b_sampler.swap(warm_pr, warm_pr, warm_c, warm_c, True, True)
    reset_counts(counted)
    with decode_launch_dtypes() as seen:
        s0 = time.perf_counter()
        via_b = b_sampler.swap(pr, pr, c, c, True, True)
        torch.cuda.synchronize()
        k3b_ms = (time.perf_counter() - s0) * 1e3
    got_b = counts(counted)
    check(got_b[K3.__name__] == T and sum(got_b.values()) == T
          and sum(seen.values()) == T and all(
              k == "pctd_frame_decode_bf16" and v == {"torch.bfloat16"}
              for (k, v) in seen),
          f"bf16 K3 route launches {got_b}, {launch_summary(seen)}")
    hs = []
    with recorded_plain_frames(hs):
        via_bp = b_sampler.swap(pr, pr, c, c, True, True)
    check(K3.launches == T, "the plain bf16 route launched K3")
    ag_b = float((via_b == via_bp).mean())
    margins = first_frame_margins(b_sampler.fw, spec, via_b, via_bp, hs,
                                  dev)
    worst = max(margins, default=0.0)
    ag_f32 = float((via_b == via_k3).mean())
    print(f"  bf16 K3 route swap n={TRAIN_B}: {k3b_ms:.2f} ms, launches "
          f"{got_b}; agreement with the plain bf16 route on the card "
          f"{ag_b:.6f}, {len(margins)} differing rows, worst first-"
          f"difference margin {worst:.3g}; with the f32 K3 route "
          f"{ag_f32:.6f} (the control, < 1)")
    check(ag_b >= AGREE, f"stretch bf16 K3 route vs plain {ag_b}")
    check(worst <= BF16_TIE, f"stretch bf16 K3 route: a row's first "
          f"differing decision is no near-tie (margin {worst:.3g})")
    check(ag_f32 < 1.0, "the bf16 stretch swap equals the f32 one")
    phase("stretch serving", t0)
    return {"workflows": serving, "chunks": chunks,
            "launches": {"K4": chunks, "K3 f32": T, "K3 bf16": T},
            "swap128_vs_plain": ag, "k4_ms": k4_ms,
            "k4_plain_ms": k4_plain_ms, "k4_bound_ms": k4_bound,
            "k4_bound_by": k4_by, "k3_route_swap128_ms": k3_ms,
            "k3_route_vs_k4": ag_k3, "k3_bf16_route_swap128_ms": k3b_ms,
            "k3_bf16_vs_plain": ag_b, "k3_bf16_worst_margin": worst}


def stretch_training_phase(args, dev, counted) -> dict:
    """The stretch trained at canonical width at B=128 on an 8-bar
    synthetic corpus (``DataConfig(num_bar=8)``): f32 with the CE fused in
    (``STRETCH_STEPS`` steps and an eval batch; step 1 against the plain
    path on the card; one step profiled), logits out and bf16 fused
    (``STRETCH_OTHER_STEPS`` steps each), K1, K2a and K2b launched 128
    times a step (K1 also 128 an eval batch) and nothing else; then the
    (conv, 128) step envelope at B=128 and 512."""
    t0 = time.perf_counter()
    cfg = stretch_config(ModelConfig())
    T = cfg.pianotree.num_step
    dcfg = dataclasses.replace(DataConfig(), num_bar=8)
    corpora = synthetic_corpora(n_songs=STRETCH_SONGS, seed=dcfg.seed,
                                n_bars=STRETCH_BARS, cfg=dcfg)
    check(corpora[0].pr.shape[1:] == (T, 128)
          and corpora[0].chord.shape[1:] == (32, 14),
          f"8-bar corpus shapes {corpora[0].pr.shape}")
    print(f"  8-bar corpus: {len(corpora[0])} train / {len(corpora[1])} val "
          f"segments")
    tcfg = TrainConfig(batch_size=TRAIN_B, accum_steps=1, seed=args.seed)
    step_gen = lambda: torch.Generator(device=dev).manual_seed(tcfg.seed)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out = {}
    runs = {"f32 fused": (cfg, STRETCH_STEPS),
            "f32 logits out": (dataclasses.replace(cfg, fused_loss=False),
                               STRETCH_OTHER_STEPS),
            "bf16 fused": (dataclasses.replace(cfg, compute_dtype="bfloat16"),
                           STRETCH_OTHER_STEPS)}
    first = next(make_loaders(*corpora, TRAIN_B, seed=args.seed)[0].epoch())
    for name, (cfg_r, steps) in runs.items():
        train_b, val_b = make_loaders(*corpora, TRAIN_B, seed=args.seed)
        trainer = tr.Trainer(cfg_r, tcfg, train_b, val_b, device=dev)
        feats = tr.batch_features(*trainer._to_device(first), cfg_r)[:3]
        fwd, bwd = ((tf.frame_fwd, tf.frame_bwd) if cfg_r.fused_loss
                    else (tf.frame_core_fwd, tf.frame_core_bwd))
        ref = None
        if name == "f32 fused":
            with plain_frames():
                ref_m, ref_g = tr.loss_and_grads(
                    trainer.params, cfg_r, tcfg,
                    schedules.train_params_at(0, tcfg), step_gen(), *feats)
            ref = ({k: v.item() for k, v in ref_m.items()},
                   global_norm(ref_g).item())
            del ref_g
        elif name == "f32 logits out":
            ref = tr.eval_metrics(trainer.params, cfg, tcfg, 0, step_gen(),
                                  *trainer._to_device(first))
            ref = ({k: v.item() for k, v in ref.items()}, None)
        reset_counts(counted)
        trainer.train_steps(steps)
        if name == "f32 fused":
            trainer.eval_epoch()
        torch.cuda.synchronize()
        got, py = counts(counted), python_steps(trainer)
        want = {fwd.__name__: T * (py + (name == "f32 fused") * len(val_b)),
                bwd.__name__: T * py, tf.weight_grads.__name__: T * py}
        print(f"  {name}: launches in {steps} steps ({py} run by Python)"
              f"{' + an eval batch' if name == 'f32 fused' else ''}: {got}")
        check(got == dict({k: 0 for k in got}, **want),
              f"stretch {name} launches {got}, expected {want}")
        for i, m in enumerate(trainer.history):
            check(all(np.isfinite(v) for v in m.values()),
                  f"stretch {name} step {i + 1} {m}")
        m1 = trainer.history[0]
        res = {"launches": got, "step1_loss": m1["loss"],
               "step_ms": [s * 1e3 for s in trainer.step_seconds]}
        if name == "f32 fused":
            err = max(rel(m1[k], ref[0][k]) for k in dv.METRIC_NAMES)
            norm_err = rel(trainer.grad_norms[0], ref[1])
            print(f"  {name} step 1 vs the plain path on the card: loss "
                  f"{m1['loss']!r} vs {ref[0]['loss']!r}; 11 metrics max "
                  f"rel err {err:.3g}; grad norm rel err {norm_err:.3g}")
            check(err <= LOSS_RTOL, f"stretch step 1 metrics rel err {err}")
            check(norm_err <= NORM_RTOL,
                  f"stretch step 1 grad norm rel err {norm_err}")
            res.update(step1_metric_rel_err=err,
                       step1_grad_norm_rel_err=norm_err,
                       profile=profile_step(trainer))
            f32_m1 = m1
        elif name == "f32 logits out":
            err = max(rel(m1[k], ref[0][k]) for k in dv.METRIC_NAMES)
            print(f"  {name} step 1 vs the fused mode on the same batch, "
                  f"noise and weights: 11 metrics max rel err {err:.3g}")
            check(err <= MODES_RTOL, f"stretch logits-out vs fused step 1 "
                  f"rel err {err}")
            res["step1_vs_fused_rel_err"] = err
        else:
            err = max(rel(m1[k], f32_m1[k]) for k in dv.METRIC_NAMES)
            print(f"  {name} step 1 vs the f32 step on the same batch, "
                  f"noise and weights: 11 metrics max rel err {err:.3g}")
            check(BF16_LOSS_RTOL < err <= BF16_VS_F32_RTOL,
                  f"stretch bf16 vs f32 step 1 rel err {err}: not within "
                  f"{BF16_VS_F32_RTOL}, or within {BF16_LOSS_RTOL} (the "
                  "gate could not tell bf16 from f32)")
            res["step1_vs_f32_rel_err"] = err
        print(f"  {name} step ms: " + " ".join(
            f"{v:.1f}" for v in res["step_ms"]))
        out[name] = res
        del trainer
    torch.cuda.empty_cache()
    out["envelope"] = measure_envelope(cfg, corpora, args.seed, dev)
    phase("stretch training", t0)
    return out


def pianotree_serving_phase(args, dev, counted, rng) -> dict:
    """The pianotree texture encoder served at canonical width on random
    weights from ``--seed``: the detrended grid made on the card,
    ``Sampler.encode`` with it (fixed batch 16, the last chunk partial)
    against the unchunked encode, the ``disentangle_vae`` workflows with
    ``dt_x`` through K4 (once each) against the same on the CPU plain path,
    and the Sampler's workflows refusing the model."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ModelConfig(), txt_encoder="pianotree")
    K4 = full_decoder.decode_grid_full
    params = dv.init_params(cfg, seed=args.seed, device="cpu")
    raw = segments(rng, PT_SERVE_ROWS)
    shift = np.arange(PT_SERVE_ROWS, dtype=np.int32) % 12 - 6
    feats = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        _, c, pr_mat, dt_x = tr.batch_features(
            *(torch.as_tensor(a, device=device)
              for a in (raw.pr, raw.chord, shift)), cfg)
        feats[key] = (pr_mat, c, dt_x)
    check(torch.equal(feats["card"][2].cpu(), feats["cpu"][2]),
          "the detrended grid on the card differs from the CPU's")
    sampler = Sampler(params, cfg, fixed_batch=16, device=dev)
    chunked = sampler.encode(*feats["card"])
    whole = Sampler(params, cfg, device=dev).encode(*feats["card"])
    enc_err = max((a - b).abs().max().item() for da, db in zip(chunked, whole)
                  for a, b in zip(da, db))
    print(f"  Sampler.encode with dt_x, {PT_SERVE_ROWS} rows in chunks of "
          f"16 vs unchunked: max|diff| {enc_err:.3g}")
    check(enc_err <= STATE_ATOL, f"chunked pianotree encode {enc_err}")
    n = PT_CPU_ROWS
    g = lambda dev_: torch.Generator(device=dev_).manual_seed(args.seed)
    workflows = {
        "swap": lambda p, pm, c, d, dv_: dv.swap(
            p, cfg, pm[:n], pm[n:2 * n], c[:n], c[n:2 * n], True, False,
            dt_x1=d[:n], dt_x2=d[n:2 * n]),
        "inference": lambda p, pm, c, d, dv_: dv.inference(
            p, cfg, pm[:n], c[:n], sample=False, dt_x=d[:n]),
        "posterior_sample": lambda p, pm, c, d, dv_: dv.posterior_sample(
            p, cfg, g(dv_), pm[:n], c[:n], scale=0.0, dt_x=d[:n]),
        "interp": lambda p, pm, c, d, dv_: torch.as_tensor(dv.interp(
            p, cfg, pm[:1], c[:1], pm[1:2], c[1:2], interp_rhy=True,
            int_count=n, dt_x1=d[:1], dt_x2=d[1:2]))}
    p_dev = params_to(params, dev)
    out = {}
    for name, fn in workflows.items():
        reset_counts(counted)
        got = fn(p_dev, *feats["card"], dev)
        torch.cuda.synchronize()
        launched = counts(counted)
        want = fn(params, *feats["cpu"], torch.device("cpu"))
        ag = float((got.cpu() == want).float().mean())
        print(f"  disentangle_vae.{name} with dt_x: grid {tuple(got.shape)},"
              f" launches {launched}; agreement with the CPU plain path "
              f"{ag:.6f}")
        check(launched[K4.__name__] == 1 and sum(launched.values()) == 1,
              f"pianotree {name} launches {launched}")
        check(ag >= AGREE, f"pianotree {name} vs the CPU plain path {ag}")
        out[name] = {"agreement": ag, "launches": launched}
    pm = feats["card"][0][:2].cpu().numpy()
    cc = feats["card"][1][:2].cpu().numpy()
    for name, call in (("swap", lambda: sampler.swap(pm, pm, cc, cc, True,
                                                      True)),
                       ("interp", lambda: sampler.interp(pm, cc, pm, cc))):
        try:
            call()
        except ValueError as e:
            check(f"disentangle_vae.{name}" in str(e), str(e))
        else:
            check(False, f"Sampler.{name} served a pianotree model")
    print("  the Sampler's workflows refuse the pianotree model, naming "
          "the disentangle_vae function that takes dt_x")
    phase("pianotree serving", t0)
    return out


def reference_checkpoint_phase(args, cfg, dev, counted, models: str,
                               tmp: str) -> dict:
    """The training run's checkpoint and the random weights' (saved by
    ``serving_daemon_phase`` at ``tmp/random``) to a reference ``.pt`` and
    back (``cli.convert_checkpoint``): the same bits; each converted
    checkpoint served by ``cli.serve`` in this process gives its source
    checkpoint's bytes. The run's weights decode eos at every first slot,
    so its served files hold few notes; the random weights' hold notes in
    every file, which the gate requires. A pianotree ``.pt`` is
    detected."""
    t0 = time.perf_counter()
    d = os.path.join(tmp, "interop")
    os.makedirs(d)
    files = daemon_inputs(args.seed, tmp)
    out = {}
    for weights, src_ck in (("run", os.path.join(models, "disvae_final")),
                            ("random", os.path.join(tmp, "random"))):
        ref, conv, back = (os.path.join(d, f"{weights}_{n}")
                           for n in ("ref.pt", "converted", "back.pt"))
        for argv in (["--to-torch", ref, "--checkpoint", src_ck],
                     ["--from-torch", ref, "--out", conv],
                     ["--to-torch", back, "--checkpoint", conv]):
            captured(lambda: cli_convert.main(argv))
        a, b = (torch.load(p, map_location="cpu", weights_only=True)
                for p in (ref, back))
        same_pt = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                                 for k in a)
        src, dst = (ckpt.load_state(p)["params"] for p in (src_ck, conv))
        same_params = list(src) == list(dst) and all(
            torch.equal(src[k], dst[k]) for k in src)
        print(f"  {weights} weights: {len(a)} reference tensors; .pt -> "
              f"checkpoint -> .pt the same bits: {same_pt}; the converted "
              f"params equal the source's: {same_params}")
        check(same_pt and same_params,
              f"reference checkpoint round trip ({weights} weights)")

        served = lambda tag, *f: os.path.join(d, f"served_{weights}_{tag}",
                                              *f)
        for tag, path in (("source", src_ck), ("converted", conv)):
            os.makedirs(served(tag))
            reqs = daemon_requests(files, 8, served(tag))
            lines = "".join(json.dumps(r) + "\n" for r, _ in reqs.values())
            buf = io.StringIO()
            cli_serve.main(["--checkpoint", path, "--fixed-batch", "16"],
                           stdin=io.StringIO(lines), stdout=buf)
            replies = [json.loads(x) for x in buf.getvalue().splitlines()]
            check(sum(1 for r in replies if r.get("ok")) == len(reqs),
                  f"cli.serve on the {weights} {tag} checkpoint: {replies}")
        outs = sorted(os.listdir(served("source")))
        read = lambda tag, f: open(served(tag, f), "rb").read()
        same = [read("source", f) == read("converted", f) for f in outs]
        notes = [sum(len(t.notes) for t in MidiFile.read(
            served("converted", f)).tracks) for f in outs]
        print(f"  cli.serve on the converted {weights} checkpoint: "
              f"{len(outs)} MIDI files ({sum(notes)} notes, fewest in a "
              f"file {min(notes)}), byte-equal to the source "
              f"checkpoint's: {sum(same)}")
        check(len(outs) >= len(reqs) and all(same),
              f"the converted {weights} checkpoint's MIDI bytes")
        if weights == "random":
            check(min(notes) > 0, "a served file of the random weights "
                  "holds no notes: the byte gate would be trivial")
        out[weights] = {"reference_tensors": len(a),
                        "round_trip_same_bits": same_pt,
                        "served_files_equal": sum(same),
                        "served_notes": sum(notes)}

    pt_cfg = dataclasses.replace(cfg, txt_encoder="pianotree")
    pt_ref = os.path.join(d, "pianotree.pt")
    save_reference_checkpoint(pt_ref, dv.init_params(pt_cfg, seed=1,
                                                     device=dev))
    _, text = captured(lambda: cli_convert.main(
        ["--from-torch", pt_ref, "--out", os.path.join(d, "pt_ck")]))
    check("pianotree texture variant" in text, "pianotree .pt detection")
    phase("reference checkpoint", t0)
    return out


def demo_tree_files(k: int) -> dict:
    """{relative path: track names or None} that the demo tree of a k x k
    grid holds, after the reference demo tree's structure."""
    d1, d2p, d2q, d3, d4 = (
        "1_compositional_style_transfer",
        "2_texture_variation/posterior_sampling",
        "2_texture_variation/prior_sampling", "3_acc_arrangement",
        "chord_prog_interpolation")
    figs = ["A_original", "B_original", "Achd_Btxt", "Bchd_Atxt"]
    files = {f"{d1}/swap_{i}_{j}.mid": [f"chd{i}_txt{j}"]
             for i in range(k) for j in range(k)}
    files[f"{d1}/swap_all.mid"] = [f"swap_{i}_{j}" for i in range(k)
                                   for j in range(k)]
    files[f"{d1}/16bar_style_transfer/all.mid"] = figs
    files.update({f"{d1}/16bar_style_transfer/{f}.mid": [f] for f in figs})
    files.update({f"{d2p}/original.mid": ["original"], **{
        f"{d2p}/post_sample_{s}.mid": ["posterior"] for s in range(3)}})
    for n in range(1, min(4, k)):
        files[f"{d2p}/more_examples/sample{n}/original.mid"] = ["original"]
        files[f"{d2p}/more_examples/sample{n}/post_sample_0.mid"] = [
            "posterior"]
    files[f"{d2q}/C-Am-F-G.mid"] = ["C-Am-F-G"]
    files.update({f"{d2q}/more_examples/{p}.mid": [p]
                  for p in ("Am-D7-G", "G-F-Eb", "F-Bb-F")})
    files.update({f"{d2q}/prior_sample_{s}.mid": ["prior"]
                  for s in range(2)})
    files[f"{d3}/arrangement_given_texture.mid"] = ["melody",
                                                    "arranged_acc"]
    for f in ("fig_generation_given2bar.mid",
              "more_examples/sample1_given2bar.mid",
              "more_examples/sample1_given4bar.mid",
              "more_examples/long_generation/sample1_given4bar.mid"):
        files[f"{d3}/{f}"] = None
    files[f"{d4}/interp_chd.mid"] = ["chord_interp"]
    for pa, pb in (("C-Am-F-G", "Eb-Cm-Ab-Bb"), ("Am-Dm-G-C", "C-F-G-C"),
                   ("Db-G-Cm", "C-D-G")):
        files[f"{d4}/{pa}_to_{pb}.mid"] = [f"{pa}_to_{pb}"]
        files[f"{d4}/{pb}_to_{pa}.mid"] = [f"{pb}_to_{pa}"]
    return files


def demo_tree_phase(args, counted, models: str, tmp: str) -> dict:
    """``cli.make_demos --k 4`` on the card from the training run's
    checkpoint and from the random weights' (``tmp/random``): K4 only,
    counted; the tree against the reference's structure
    (``demo_tree_files``: its files and each file's tracks by name, in
    order) and every file parsing with the port's reader. The run's weights
    decode eos at every first slot, so a track may hold no notes: the
    reader drops such a track and the gate counts it in the header. The
    random weights decode a note at every slot: there the track names must
    equal the structure's exactly and every track but the melody must hold
    notes."""
    t0 = time.perf_counter()
    K4 = full_decoder.decode_grid_full.__name__
    want = demo_tree_files(DEMO_K)
    result = {}
    for weights, ck in (("run", os.path.join(models, "disvae_final")),
                        ("random", os.path.join(tmp, "random"))):
        out = os.path.join(tmp, f"demo_out_{weights}")
        reset_counts(counted)
        captured(lambda: cli_make_demos.main(
            ["--checkpoint", ck, "--k", str(DEMO_K), "--out", out]))
        torch.cuda.synchronize()
        launched = counts(counted)
        written = sorted(os.path.relpath(os.path.join(dp, f), out)
                         for dp, _, fs in os.walk(out) for f in fs)
        missing = sorted(set(want) - set(written))
        notes, bad = 0, []
        for rel in written:
            path = os.path.join(out, rel)
            mf = MidiFile.read(path)
            notes += sum(len(t.notes) for t in mf.tracks)
            with open(path, "rb") as f:
                chunks = struct.unpack_from(">4sIHHH", f.read(14))[3]
            names, expect = [t.name for t in mf.tracks], want.get(rel)
            if weights == "run":
                ok = expect is None or (chunks == 1 + len(expect) and names
                                        == [n for n in expect if n in names])
            else:
                # no track dropped, and the named ones as the structure says
                ok = chunks == 1 + len(names) and all(
                    t.notes for t in mf.tracks if t.name != "melody") and (
                    rel not in want or (
                        names == expect if expect is not None
                        else names[-1:] == ["arranged_acc"]))
            if not ok:
                bad.append((rel, chunks, names))
        print(f"  {weights} weights: launches {launched}; {len(written)} "
              f"MIDI files ({notes} notes), all parse; of the reference "
              f"structure's {len(want)} files, missing {missing}, tracks "
              f"differ {bad[:3]}")
        check(launched[K4] > 0 and all(v == 0 for k, v in launched.items()
                                       if k != K4),
              f"the demo tree's launches ({weights} weights) {launched}")
        check(not missing and not bad,
              f"the demo tree's structure ({weights} weights)")
        check(any(f.startswith("1_compositional_style_transfer/"
                               "more_examples/swap_") for f in written),
              "more_examples grid")
        result[weights] = {"launches": launched, "files": len(written),
                           "notes": notes}
    phase("demo tree", t0)
    return result


# the phase "data parallel": a rank of part (b) and the phase itself


class RecordingOpt:
    """An optimizer stand-in that keeps the gradients a step hands it and
    updates nothing (so both modes of a case start from the same params)."""

    def __init__(self):
        self.grads = None

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]
        return global_norm(self.grads)


class RecordingAdam(Adam):
    """:class:`Adam` that keeps the gradients of its last step."""

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]
        return super().step(grads)


def trainable(params) -> list:
    leaves = tr.param_list(params)
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def timed(fn):
    """``fn()``'s result and its host ms, ending in a synchronize."""
    s0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - s0) * 1e3


def data_parallel_rank(rank: int, world: int, port: int, d: str) -> int:
    """One rank of the phase "data parallel" (b), a process of its own:
    joins the gloo group of ``world`` ranks on localhost:``port`` (all on
    this card, CUDA tensors), takes its rows of the global batch in
    ``d/inputs.pt`` and runs the data-parallel step with its zero latent
    noise and every coin on, exact and in the compat mode (gradients
    recorded, params unchanged), then ``DP_TIMED_STEPS`` timed steps with
    Adam and noise from its generator, counted. Writes ``d/rank<R>.pt``."""
    from pctd_tpu_torch.parallel import distributed as pdist
    from pctd_tpu_torch.parallel import mesh as pm

    inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    pdist.initialize(f"localhost:{port}", world, rank, "gloo")
    try:
        mesh = pm.make_mesh()
        torch.cuda.set_device(mesh.device)
        cfg = ModelConfig()
        tcfg = TrainConfig(batch_size=TRAIN_B, accum_steps=1,
                           seed=inputs["seed"])
        params = ckpt.params_of({"params": inputs["params"]}, mesh.device)
        leaves = trainable(params)
        rows = pm.shard_batch(mesh, *inputs["batch"])
        noise = dv.fixed_noise(cfg, rows[0].shape[0], mesh.device,
                               coins=True)
        out = {"device": str(mesh.device), "rows": rows[0].shape[0]}
        for exact in (True, False):
            opt = RecordingOpt()
            step = pm.make_parallel_train_step(cfg, tcfg, opt, mesh,
                                               exact_loss=exact)
            m, _ = step(params, 0, None, *rows, noise=noise)
            key = "exact" if exact else "compat"
            out[key] = m.cpu()
            if exact:
                out["grad_sums"] = torch.stack(
                    [g.double().sum() for g in opt.grads]).cpu()
                if rank == 0:
                    out["grads"] = [g.cpu() for g in opt.grads]
        torch.cuda.synchronize()
        counted = (tf.frame_fwd, tf.frame_bwd, tf.weight_grads)
        step = pm.make_parallel_train_step(cfg, tcfg, Adam(leaves, tcfg),
                                           mesh)
        gen = torch.Generator(device=mesh.device).manual_seed(
            pm.rank_seed(tcfg.seed, rank))
        reset_counts(counted)
        out["step_ms"] = [timed(lambda: step(params, i, gen, *rows))[1]
                          for i in range(DP_TIMED_STEPS)]
        out["launches"] = counts(counted)
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
        print(f"rank {rank}: {out['rows']} rows on {out['device']}, "
              f"launches in {DP_TIMED_STEPS} steps {out['launches']}, "
              f"step ms {[round(t, 2) for t in out['step_ms']]}",
              flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def scaled_grad_err(got, want) -> float:
    """The largest of max|got - want| / (1 + max|want|) over tensors."""
    return max(((a.float() - b.float()).abs().max()
                / (1 + b.float().abs().max())).item()
               for a, b in zip(got, want))


@contextlib.contextmanager
def demo_decodes(calls: list):
    """Inside this context every ``Sampler.decode`` appends (z_chd, z_rhy,
    grid) to ``calls``; the method is restored on exit."""
    route = Sampler.decode

    def recorded(self, z_chd, z_rhy):
        grid = route(self, z_chd, z_rhy)
        calls.append((self._tensor(z_chd), self._tensor(z_rhy), grid))
        return grid

    Sampler.decode = recorded
    try:
        yield
    finally:
        Sampler.decode = route


def data_parallel_phase(args, cfg, dev, counted, tmp: str) -> dict:
    """The data-parallel path on the card. (a) A process group of one rank
    over NCCL in this process: 3 steps at B=128, f32, CE fused in, through
    K1/K2a/K2b; step 1 (zero latent noise, every coin on) bit-equal to the
    single-device step in metrics, gradients, norm and updated params; 32
    K1, K2a and K2b launches a step. (b) Two ranks on this card over gloo
    (NCCL takes one rank a device), spawned after the build, 64 rows each
    of the same 128: the exact loss within LOSS_RTOL of the single-process
    loss on all 128 rows, the averaged gradients within the step-1 bar
    (norm NORM_RTOL, each tensor GRAD_TOL x (1 + max|ref|)), both ranks the
    same bits, the compat mode's loss the mean of the two halves' losses;
    each rank's launches and step times. (c) ``cli.serve --data-parallel``
    in this process: the seven request kinds of 8 windows on the random
    weights, replies and files byte-equal to the run without the flag,
    ``"devices": 1``. (d) ``cli.make_demos --frame-decoder pallas`` on the
    random weights: K3 only, 32 launches a 16-row chunk of its decodes,
    the K4 tree's files; where a grid differs from K4's, each
    differing row's first difference a near-tie."""
    from pctd_tpu_torch.parallel import distributed as pdist
    from pctd_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    spec = cfg.pianotree
    T = spec.num_step
    out = {}
    K1, K2a, K2b = (f.__name__ for f in (tf.frame_fwd, tf.frame_bwd,
                                         tf.weight_grads))
    K4, K3 = (full_decoder.decode_grid_full.__name__,
              ar_decoder.frame_decode.__name__)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)

    # (a) world size 1 over NCCL, in this process
    tcfg = TrainConfig(batch_size=TRAIN_B, accum_steps=1, seed=args.seed)
    params0 = dv.init_params(cfg, seed=args.seed, device=dev)
    corpus = segments(np.random.RandomState(args.seed + 16), 64)
    b = next(make_loaders(corpus, corpus, TRAIN_B, seed=args.seed)[0]
             .epoch())
    batch = (b["pr"], b["chord"], b["shift"])
    noise = dv.fixed_noise(cfg, TRAIN_B, dev, coins=True)
    ref_p = copy.deepcopy(params0)
    ref_leaves = trainable(ref_p)
    x, c, pr_mat, _ = tr.batch_features(
        *(torch.as_tensor(a, device=dev) for a in batch), cfg)
    ref_m, ref_g = tr.loss_and_grads(ref_p, cfg, tcfg,
                                     schedules.train_params_at(0, tcfg),
                                     None, x, c, pr_mat, noise=noise)
    ref_m = tr.stacked(ref_m).detach()
    ref_g = [g.detach().clone() for g in ref_g]
    ref_norm = Adam(ref_leaves, tcfg).step(ref_g)
    halves = []
    for h in range(2):
        part = slice(h * TRAIN_B // 2, (h + 1) * TRAIN_B // 2)
        total, _ = dv.loss(params0, cfg, x[part], c[part], pr_mat[part],
                           dv.fixed_noise(cfg, TRAIN_B // 2, dev,
                                          coins=True),
                           beta=schedules.train_params_at(0, tcfg)["beta"])
        halves.append(total.item())
    pdist.initialize_local("nccl")
    try:
        mesh = pm.make_mesh()
        check(mesh.world == 1 and mesh.device.type == "cuda"
              and torch.distributed.get_backend() == "nccl",
              f"world-1 mesh {mesh}")
        par_p = copy.deepcopy(params0)
        opt = RecordingAdam(trainable(par_p), tcfg)
        step = pm.make_parallel_train_step(cfg, tcfg, opt, mesh)
        rows = pm.shard_batch(mesh, *batch)
        gen = torch.Generator(device=dev).manual_seed(
            pm.rank_seed(tcfg.seed, mesh.rank))
        reset_counts(counted)
        (m1, norm1), ms1 = timed(lambda: step(par_p, 0, None, *rows,
                                              noise=noise))
        same = {"metrics": torch.equal(m1, ref_m),
                "grads": all(torch.equal(a, b_)
                             for a, b_ in zip(opt.grads, ref_g)),
                "norm": torch.equal(norm1, ref_norm),
                "params": all(torch.equal(a, b_) for a, b_ in zip(
                    tr.param_list(par_p), ref_leaves))}
        step_ms = [ms1] + [timed(lambda: step(par_p, i, gen, *rows))[1]
                           for i in (1, 2)]
        got = counts(counted)
    finally:
        torch.distributed.destroy_process_group()
    want = {k: 0 for k in got}
    want.update({K1: 3 * T, K2a: 3 * T, K2b: 3 * T})
    print(f"  (a) world size 1 over NCCL on {mesh.device}: step 1 vs the "
          f"single-device step, bit-equal: {same}; loss {m1[0].item()!r}; "
          f"launches in 3 steps {got}; step ms "
          f"{[round(t, 2) for t in step_ms]}")
    check(all(same.values()), f"world-1 step 1 is not bit-equal: {same}")
    check(got == want, f"world-1 launches {got}, expected {want}")
    out["world1"] = {"bit_equal": same, "launches": got, "step_ms": step_ms,
                     "loss": m1[0].item()}

    # (b) two ranks on this card over gloo, spawned after the build
    d = os.path.join(tmp, "dp_ranks")
    os.makedirs(d)
    torch.save({"params": {n: t.detach().cpu() for n, t in
                           named_leaves(params0).items()},
                "batch": batch, "seed": args.seed},
               os.path.join(d, "inputs.pt"))
    port = pdist.free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    s0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "2", str(port), d], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=DP_RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - s0
    for r, (p, text) in enumerate(zip(procs, texts)):
        print("\n".join("  | " + ln for ln in text.splitlines()[-6:]))
        check(p.returncode == 0, f"data-parallel rank {r} exited "
              f"{p.returncode}")
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    exact = ranks[0]["exact"]
    metric_err = max(rel(a, b_) for a, b_ in zip(exact.tolist(),
                                                 ref_m.tolist()))
    norm_err = rel(global_norm(ranks[0]["grads"]).item(), ref_norm.item())
    grad_err = scaled_grad_err(ranks[0]["grads"], [g.cpu() for g in ref_g])
    compat_err = rel(ranks[0]["compat"][0].item(), float(np.mean(halves)))
    equal_ranks = (torch.equal(ranks[0]["exact"], ranks[1]["exact"])
                   and torch.equal(ranks[0]["compat"], ranks[1]["compat"])
                   and torch.equal(ranks[0]["grad_sums"],
                                   ranks[1]["grad_sums"]))
    print(f"  (b) 2 gloo ranks on {ranks[0]['device']}, {ranks[0]['rows']} "
          f"rows each ({ranks_s:.1f} s with start-up): exact loss "
          f"{exact[0].item()!r} vs the single process's {ref_m[0].item()!r}"
          f" (11 metrics max rel err {metric_err:.3g}); gradients: norm rel "
          f"err {norm_err:.3g}, max scaled err {grad_err:.3g}; compat loss "
          f"{ranks[0]['compat'][0].item()!r} vs the halves' mean "
          f"{float(np.mean(halves))!r} (rel err {compat_err:.3g}); ranks "
          f"bit-equal: {equal_ranks}")
    check(metric_err <= LOSS_RTOL, f"2-rank exact metrics rel err "
          f"{metric_err}")
    check(norm_err <= NORM_RTOL, f"2-rank gradient norm rel err {norm_err}")
    check(grad_err <= GRAD_TOL, f"2-rank gradients scaled err {grad_err}")
    check(compat_err <= LOSS_RTOL, f"2-rank compat loss rel err "
          f"{compat_err}")
    check(equal_ranks, "the two ranks' results differ")
    for r, rk in enumerate(ranks):
        want = {K1: DP_TIMED_STEPS * T, K2a: DP_TIMED_STEPS * T,
                K2b: DP_TIMED_STEPS * T}
        check(rk["launches"] == want, f"rank {r} launches {rk['launches']}")
    out["two_ranks"] = {
        "rows_each": ranks[0]["rows"], "metric_rel_err": metric_err,
        "grad_norm_rel_err": norm_err, "grad_scaled_err": grad_err,
        "compat_rel_err": compat_err, "seconds_with_start_up": ranks_s,
        "launches": [rk["launches"] for rk in ranks],
        "step_ms": [rk["step_ms"] for rk in ranks]}
    del ref_g, ranks

    # (c) the serving daemon with --data-parallel, in this process
    random_ck = os.path.join(tmp, "random")
    os.makedirs(os.path.join(tmp, "dp_serve"))
    files = daemon_inputs(args.seed, os.path.join(tmp, "dp_serve"))
    runs = []
    for flag in ([], ["--data-parallel"]):
        dst = os.path.join(tmp, "dp_serve", "dp" if flag else "one")
        os.makedirs(dst)
        reqs = daemon_requests(files, 8, dst)
        lines = [json.dumps(r) for r, _ in reqs.values()] + [
            json.dumps({"op": "quit"})]
        buf = io.StringIO()
        reset_counts(counted)
        cli_serve.main(["--checkpoint", random_ck, "--fixed-batch", "16",
                        *flag], stdin=io.StringIO("\n".join(lines) + "\n"),
                       stdout=buf)
        torch.cuda.synchronize()
        got = counts(counted)
        replies = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        ready = [r for r in replies if r.get("ready")][0]
        answers = [r for r in replies if "ok" in r]
        paths = [p for r in answers if "out" in r for p in (
            r["out"] if isinstance(r["out"], list) else [r["out"]])]
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
        check(all(r["ok"] for r in answers), f"daemon replies {answers}")
        runs.append({"devices": ready["devices"], "launches": got,
                     "answers": [{k: v for k, v in r.items()
                                  if k not in ("ms", "out")}
                                 for r in answers], "files": blobs})
    equal = (runs[0]["answers"] == runs[1]["answers"]
             and runs[0]["files"] == runs[1]["files"])
    print(f"  (c) serve --data-parallel: devices {runs[1]['devices']}, "
          f"{len(runs[1]['answers'])} replies, {len(runs[1]['files'])} "
          f"files, byte-equal to the run without the flag: {equal}; "
          f"launches {runs[1]['launches']} (without: "
          f"{runs[0]['launches']})")
    check(runs[1]["devices"] == 1 and runs[0]["devices"] == 1,
          "the ready line's device count")
    check(len(runs[1]["files"]) == 6 + DAEMON_INTERP,
          f"{len(runs[1]['files'])} files written")
    check(equal, "serve --data-parallel differs from serve")
    check(runs[0]["launches"] == runs[1]["launches"]
          and runs[1]["launches"][K4] > 0,
          f"serve launches {runs[0]['launches']} / {runs[1]['launches']}")
    out["serve"] = {"devices": runs[1]["devices"],
                    "launches": runs[1]["launches"], "byte_equal": equal}

    # (d) the demo tree through K3
    k4_tree = os.path.join(tmp, "demo_out_random")
    k3_tree = os.path.join(tmp, "demo_out_k3")
    calls = []
    reset_counts(counted)
    with demo_decodes(calls):
        captured(lambda: cli_make_demos.main(
            ["--checkpoint", random_ck, "--k", str(DEMO_K), "--out", k3_tree,
             "--frame-decoder", "pallas"]))
    torch.cuda.synchronize()
    got = counts(counted)
    chunks = sum(-(-len(zc) // cli_make_demos.FIXED_BATCH)
                 for zc, _, _ in calls)
    want = {k: 0 for k in got}
    want[K3] = T * chunks
    files_of = lambda root: sorted(
        os.path.relpath(os.path.join(dp, f), root)
        for dp, _, fs in os.walk(root) for f in fs)
    names = files_of(k3_tree)
    differ = []
    for rel_path in names:
        with open(os.path.join(k3_tree, rel_path), "rb") as f3, \
                open(os.path.join(k4_tree, rel_path), "rb") as f4:
            if f3.read() != f4.read():
                differ.append(rel_path)
    params, mcfg = ckpt.load_model(random_ck, cfg, args.seed, dev)
    k4_sampler = Sampler(params, mcfg, fixed_batch=16, device=dev)
    plain_k3 = Sampler(params, mcfg, frame_decoder="frame", device=dev)
    margins, rows_differ = [], 0
    for zc, zr, grid in calls:
        want_grid = k4_sampler.decode(zc, zr)
        if np.array_equal(grid, want_grid):
            continue
        hs = []
        with recorded_plain_frames(hs):
            plain_k3.decode(zc, zr)
        m_ = first_frame_margins(plain_k3.fw, spec, grid, want_grid, hs,
                                 dev)
        rows_differ += len(m_)
        margins += m_
    worst = max(margins, default=0.0)
    print(f"  (d) make_demos --frame-decoder pallas: launches {got} "
          f"({chunks} chunks of 16 rows); {len(names)} files, "
          f"{len(differ)} differ from the K4 tree's; {len(calls)} decode "
          f"calls, {rows_differ} rows differ from K4's grids, worst "
          f"first-difference margin {worst:.3g}")
    check(got == want, f"the K3 demo tree's launches {got}, expected {want}")
    check(names == files_of(k4_tree), "the K3 tree's files are not the "
          "K4 tree's")
    check(not differ or rows_differ > 0, f"files differ with equal grids: "
          f"{differ[:3]}")
    check(worst <= BF16_TIE, f"a K3 row's first difference from K4 is no "
          f"near-tie (margin {worst:.3g})")
    out["demo_k3"] = {"launches": got, "files": len(names),
                      "files_differ": len(differ), "rows_differ": rows_differ,
                      "worst_margin": worst}
    out["seconds"] = time.perf_counter() - t0
    phase("data parallel", t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-k1", default="",
                    help="JSON line of tools/k1_by_rows.py run on a checkout "
                         "of the per-row K1, printed beside the new K1")
    ap.add_argument("--dp-rank", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card",
              file=sys.stderr)
        return 2
    if args.dp_rank:
        rank, world, port, d = args.dp_rank
        return data_parallel_rank(int(rank), int(world), int(port), d)
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
    k2b_regs = {m.group(1): f"{m.group(3)}; {m.group(2)}"
                for m in re.finditer(
                    r"Compiling entry function '\S*?(wgrad_\w*?kernelI\w+?)"
                    r"EE.*\n.*\n\s*(.*spill loads)\n.*?(Used \d+ "
                    r"registers[^\n]*)", log)}
    print(f"  K2b registers: {k2b_regs}")
    k2a_regs = {m.group(1): f"{m.group(3)}; {m.group(2)}"
                for m in re.finditer(
                    r"Compiling entry function '\S*?(train_bwd_\w*?kernelI"
                    r"\w+?)EE.*\n.*\n\s*(.*spill loads)\n.*?(Used \d+ "
                    r"registers[^\n]*)", log)}
    print(f"  K2a registers: {k2a_regs}")
    check(len(k2a_regs) == 6, f"K2a: {len(k2a_regs)} of its 6 kernels (3 "
          "a storage type) in the build report")
    decode_regs = {m.group(1): f"{m.group(3)}; {m.group(2)}"
                   for m in re.finditer(
                       r"Compiling entry function '\S*?((?:frame|full)_group"
                       r"_kernelI\w+?)EE.*\n.*\n\s*(.*spill loads)\n.*?(Used "
                       r"\d+ registers[^\n]*)", log)}
    print(f"  row-group K3/K4 registers: {decode_regs}")
    k1_regs = {m.group(1): f"{m.group(3)}; {m.group(2)}"
               for m in re.finditer(
                   r"Compiling entry function '\S*?(train_fwd_group_kernel"
                   r"I\w+?)EE.*\n.*\n\s*(.*spill loads)\n.*?(Used \d+ "
                   r"registers[^\n]*)", log)}
    print(f"  row-group K1 registers: {k1_regs}")
    check(len(k1_regs) == 4, f"row-group K1: {len(k1_regs)} of its 4 "
          "instances (2 cluster sizes x 2 storage types) in the build report")
    k1_sass = sass_sizes(build.build()[0], r"train_fwd_group_kernel")
    print(f"  row-group K1 SASS instructions: {k1_sass}")
    decode_sass = sass_sizes(build.build()[0], r"(?:frame|full)_group_kernel")
    print(f"  row-group K3/K4 SASS instructions: {decode_sass}")
    check(len(decode_regs) == 6, f"row-group K3/K4: {len(decode_regs)} of "
          "their 6 instances (K3: 2 cluster sizes x 2 storage types; K4: 2 "
          "cluster sizes) in the build report")
    phase("build", t0)

    # 2b. the step graph at the conv step envelope, while the card holds
    # nothing else: a train epoch, an eval epoch, a train epoch again
    t0 = time.perf_counter()
    graph_at_envelope = envelope_epochs(cfg, args.seed, dev)
    phase("step graph at the envelope", t0)

    # 3. weights
    t0 = time.perf_counter()
    params = dv.init_params(cfg, seed=args.seed, device=dev)
    fw_of = lambda p: ar_decoder.folded_frame_weights(p["dec"], cfg)
    fw = fw_of(params)
    dims = build.decoder_dims(fw, spec)
    cw0 = tf.core_weights(params["dec"], cfg)
    d0 = tf.dims_of(cw0, spec)
    tw = build.train_weights(cw0, d0)
    k1_smem = {}
    for dt in (torch.float32, BF16):
        cwd = tf.CoreWeights(*(w.detach().to(dt) for w in cw0))
        for C in build.DECODE_CLUSTERS:
            info = build.k1_info(cwd, d0, C, dev)
            lay = tf.panel_layout(d0, C, dt)
            k1_smem[f"{dt} C={C}"] = info
            print(f"  row-group K1 {dt} at {C} blocks a cluster: shared "
                  f"memory {info[0]} B, {info[1]} clusters at once; panels "
                  f"{lay.size * cwd.w_hh.element_size()} B")
    for C in build.DECODE_CLUSTERS:
        print(f"  row-group K3 / K4 at {C} blocks a cluster (shared memory "
              f"B, clusters at once): "
              f"{build.decode_info(fw, dims, False, C, dev)} / "
              f"{build.decode_info(fw, dims, True, C, dev)}")
    k2a_smem = k2a_shared_memory(lib, tw)
    print("  K2a shared memory a block (f32): " + ", ".join(
        f"{k} {v}" for k, v in k2a_smem.items()))
    h_probe = torch.randn(128, cfg.dec_time_hidden, device=dev,
                          generator=gen) * 0.6
    sos_probe = ptd.decode_inputs(
        params["dec"], cfg, torch.zeros(128, cfg.z_dim, device=dev)).sos_emb
    biased = eos_variant(params, cfg, fw_of, h_probe, sos_probe)
    weight_sets = {"seed": (params, fw), "eos_biased": (biased,
                                                        fw_of(biased))}
    phase("weights", t0)

    # 4. K3 vs its plain version, at each batch and cluster size, and the
    # same bits over two launches
    t0 = time.perf_counter()
    k3_err, k3_agree = 0.0, 1.0
    for wname, (p, w) in weight_sets.items():
        for B in DECODE_B:
            h = torch.randn(B, cfg.dec_time_hidden, device=dev,
                            generator=gen) * 0.6
            sos = sos_probe[:1].expand(B, -1).contiguous()
            want = ar_decoder.frame_decode_plain(w, spec, h, sos)
            for C in build.DECODE_CLUSTERS:
                got = ar_decoder.frame_decode(w, spec, h, sos, cluster=C)
                again = ar_decoder.frame_decode(w, spec, h, sos, cluster=C)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ag = [agreement(got[i], want[i]) for i in (0, 1, 3)]
                rows = ((got[0] == want[0]).all(1) & (got[1] == want[1])
                        .flatten(1).all(1) & (got[3] == want[3]))
                err = (got[2] - want[2]).abs()[rows].max().item() \
                    if rows.any() else float("inf")
                hist = torch.bincount(got[3].long(), minlength=16).tolist()
                print(f"  K3 {wname} B={B} C={C}: agreement pitch/dur/len "
                      f"{ag}, summary max|err| {err:.3g} on "
                      f"{int(rows.sum())} rows; two launches bit-identical: "
                      f"{same}; lengths {hist}")
                check(min(ag) >= AGREE, f"K3 {wname} B={B} C={C} agreement "
                      f"{ag}")
                check(err <= SUMMARY_ATOL, f"K3 {wname} B={B} C={C} summary "
                      f"{err}")
                check(same, f"K3 {wname} B={B} C={C}: two launches differ")
                k3_err, k3_agree = max(k3_err, err), min(k3_agree, min(ag))
    phase("K3 vs plain", t0)

    # 4b. K3 in bf16 vs its plain version, on the folds of bf16-cast params
    t0 = time.perf_counter()
    cfg_b = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bf16_sets = {wname: ar_decoder.folded_frame_weights(
        cast_params(p["dec"], BF16), cfg_b)
        for wname, (p, _) in weight_sets.items()}
    sos_probe_b = ptd.decode_inputs(
        cast_params(params["dec"], BF16), cfg_b,
        torch.zeros(128, cfg.z_dim, device=dev, dtype=BF16)).sos_emb
    k3b_err, k3b_agree, k3b_margin = 0.0, 1.0, 0.0
    with decode_launch_dtypes() as seen:
        for wname, w in bf16_sets.items():
            for B in DECODE_B:
                h = (torch.randn(B, cfg.dec_time_hidden, device=dev,
                                 generator=gen) * 0.6).to(BF16)
                sos = sos_probe_b[:1].expand(B, -1).contiguous()
                want = ar_decoder.frame_decode_plain(w, spec, h, sos)
                hid, gi = ar_decoder.frame_projection(w, h)
                *_, pl, dl = ar_decoder.slot_chain_plain(w, spec, hid, gi,
                                                         logits=True)
                for C in build.DECODE_CLUSTERS:
                    got = ar_decoder.frame_decode(w, spec, h, sos, cluster=C)
                    again = ar_decoder.frame_decode(w, spec, h, sos,
                                                    cluster=C)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    check(got[2].dtype == BF16 and want[2].dtype == BF16,
                          "K3 bf16 summary is not bf16")
                    ag = [agreement(got[i], want[i]) for i in (0, 1, 3)]
                    dec_k = torch.cat([got[0][..., None], got[1]], -1)
                    dec_p = torch.cat([want[0][..., None], want[1]], -1)
                    rows = ((dec_k == dec_p).flatten(1).all(1)
                            & (got[3] == want[3]))
                    margins = root_margins(dec_k, dec_p, pl, dl)
                    worst = margins.max().item() if len(margins) else 0.0
                    a, b = got[2][rows].float(), want[2][rows].float()
                    err = (a - b).abs().max().item() if rows.any() \
                        else float("inf")
                    tol = BF16_SUMMARY_TOL * (1.0 + b.abs().max().item())
                    hist = torch.bincount(got[3].long(),
                                          minlength=16).tolist()
                    print(f"  K3 bf16 {wname} B={B} C={C}: agreement "
                          f"pitch/dur/len {ag}, {len(margins)} differing "
                          f"rows, worst first-difference margin {worst:.3g};"
                          f" summary max|err| {err:.3g} ({err / tol:.2f} of "
                          f"tol) on {int(rows.sum())} rows; two launches "
                          f"bit-identical: {same}; lengths {hist}")
                    check(min(ag) >= AGREE, f"K3 bf16 {wname} B={B} C={C} "
                          f"agreement {ag}")
                    check(worst <= BF16_TIE, f"K3 bf16 {wname} B={B} C={C}: "
                          f"a row's first differing decision is no near-tie "
                          f"of the plain version's logits (margin "
                          f"{worst:.3g})")
                    check(err <= tol, f"K3 bf16 {wname} B={B} C={C} summary "
                          f"{err} > {tol}")
                    check(same, f"K3 bf16 {wname} B={B} C={C}: two launches "
                          "differ")
                    k3b_err, k3b_agree = max(k3b_err, err), min(k3b_agree,
                                                                min(ag))
                    k3b_margin = max(k3b_margin, worst)
    print(f"  K3 bf16 launches by (entry point, dtypes at the call): "
          f"{launch_summary(seen)}")
    n_k3b = 2 * len(bf16_sets) * len(DECODE_B) * len(build.DECODE_CLUSTERS)
    check(sum(seen.values()) == n_k3b and all(
        k == "pctd_frame_decode_bf16" and v == {"torch.bfloat16"}
        for (k, v) in seen), f"a bf16 K3 launch received another dtype or "
        f"entry point: {launch_summary(seen)}")
    phase("K3 bf16 vs plain", t0)

    # 5. K4 vs its plain version, at each batch and cluster size, and the
    # same bits over two launches
    t0 = time.perf_counter()
    k4_err, k4_agree = 0, 1.0
    for wname, (p, w) in weight_sets.items():
        for B in DECODE_B:
            z = torch.randn(B, cfg.z_dim, device=dev, generator=gen)
            inputs = ptd.decode_inputs(p["dec"], cfg, z)
            want = full_decoder.decode_grid_full_plain(w, spec, *inputs)
            for C in build.DECODE_CLUSTERS:
                got = full_decoder.decode_grid_full(w, spec, *inputs,
                                                    cluster=C)
                again = full_decoder.decode_grid_full(w, spec, *inputs,
                                                      cluster=C)
                torch.cuda.synchronize()
                same = torch.equal(got, again)
                ag = agreement(got, want)
                err = (got - want).abs().max().item()
                eos = got[..., 0] == spec.pitch_eos
                lens = torch.where(eos.any(-1), eos.int().argmax(-1) + 1,
                                   spec.max_simu_note - 1)
                hist = torch.bincount(lens.flatten().long(),
                                      minlength=16).tolist()
                print(f"  K4 {wname} B={B} C={C}: grid agreement {ag:.6f}, "
                      f"max|err| {err}; two launches bit-identical: {same}; "
                      f"frame lengths {hist}")
                check(ag >= AGREE, f"K4 {wname} B={B} C={C} agreement {ag}")
                check(same, f"K4 {wname} B={B} C={C}: two launches differ")
                k4_err, k4_agree = max(k4_err, err), min(k4_agree, ag)
    phase("K4 vs plain", t0)

    # 6. K1 vs its plain version
    t0 = time.perf_counter()
    k1_err, k1_agree = 0.0, 1.0
    for wname, (p, _) in weight_sets.items():
        for B in K1_B:
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
                same = k1_same_bits(lambda: tf.frame_fwd(cw, spec, **inp,
                                                         stash=True))
            hist = torch.bincount(got[2].long(), minlength=16).tolist()
            print(f"  K1 {wname} B={B}: decisions agree on {ag:.6f} of "
                  f"rows; on those nums rel err {nums:.3g}, summary "
                  f"max|err| {summ:.3g}, hs max|err| {hs:.3g}; two launches "
                  f"bit-identical (stash included): {same}; lengths {hist}")
            check(same, f"K1 {wname} B={B}: two launches differ")
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
                same = k1_same_bits(lambda: tf.frame_core_fwd(
                    cw, spec, **core_inputs(inp), stash=True))
            torch.cuda.synchronize()
            check(same, f"K1 logits out {wname} B={B}: two launches differ")
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
                  f"logits' argmaxes; two launches bit-identical (stash "
                  f"included); max|err| " + ", ".join(errs)
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

    # 7d. K1 in bf16, both modes, vs its plain version
    t0 = time.perf_counter()
    k1b_err, k1bl_err = 0.0, 0.0
    pooled = collections.Counter()
    with launch_dtypes() as seen:
        for wname, (p, _) in weight_sets.items():
            for B in K1_B:
                cw, inp = to_bf16(*frame_case(p, cfg, B, gen))
                with torch.no_grad():
                    # loss mode
                    got = tf.frame_fwd(cw, spec, **inp, stash=True)
                    want = tf.frame_recon_plain(cw, spec, **inp)
                    # logits out (the same forward: its logits also give
                    # the loss mode's margins)
                    pitch, dur, summ_l, lens_l, dec_l, _ = tf.frame_core_fwd(
                        cw, spec, **core_inputs(inp), stash=False)
                    want_l = tf.frame_core_plain(cw, spec,
                                                 **core_inputs(inp))
                    same = (k1_same_bits(lambda: tf.frame_fwd(
                        cw, spec, **inp, stash=True)), k1_same_bits(
                        lambda: tf.frame_core_fwd(cw, spec,
                                                  **core_inputs(inp),
                                                  stash=True)))
                torch.cuda.synchronize()
                check(all(same), f"K1 bf16 {wname} B={B}: two launches "
                      f"differ (loss, logits out: {same})")
                check(got[1].dtype == BF16 and pitch.dtype == BF16
                      and dur.dtype == BF16 and summ_l.dtype == BF16,
                      "K1 bf16 outputs are not bf16")
                check(torch.equal(core_decisions(pitch, dur), dec_l),
                      f"K1 bf16 logits out {wname} B={B}: the logits' "
                      "argmaxes differ from the kernel's decisions")
                dec_p = torch.cat([want.pitch[..., None], want.bits], -1)
                stats, rows_of = [], {}
                for mode, dec_k, lens_k in (("loss", got[3], got[2]),
                                            ("logits out", dec_l, lens_l)):
                    slots = (dec_k == dec_p).all(-1)
                    rows_of[mode] = slots.all(1) & (lens_k == want.lengths)
                    margins = root_margins(dec_k, dec_p,
                                           want_l.pitch_logits,
                                           want_l.dur_logits)
                    worst = margins.max().item() if len(margins) else 0.0
                    check(worst <= BF16_TIE,
                          f"K1 bf16 {mode} {wname} B={B}: a row's first "
                          f"differing decision is no near-tie of the plain "
                          f"version's logits (margin {worst:.3g})")
                    slot_ag = slots.float().mean().item()
                    check(slot_ag >= BF16_SLOT_AGREE,
                          f"K1 bf16 {mode} {wname} B={B}: decided slots "
                          f"agree on {slot_ag}")
                    pooled["slots"] += slots.numel()
                    pooled["slots_agree"] += int(slots.sum())
                    pooled["rows"] += B
                    pooled["len_agree"] += int((lens_k == want.lengths)
                                               .sum())
                    stats.append(f"{mode}: slots {slot_ag:.6f}, lengths "
                                 f"{agreement(lens_k, want.lengths):.6f}, "
                                 f"{len(margins)} differing rows, worst "
                                 f"first-difference margin {worst:.3g}")
                rows, rows_l = rows_of["loss"], rows_of["logits out"]
                sub_ = {k: (v if k == "coins" else v[rows])
                        for k, v in inp.items()}
                with torch.no_grad():
                    nums_k = tf.frame_fwd(cw, spec, **sub_, stash=False)[0]
                    nums_p = tf.frame_recon_plain(cw, spec, **sub_).nums
                errs = []
                for name, a, b in (
                        ("nums", nums_k, nums_p),
                        ("summary", got[1][rows], want.summary[rows]),
                        ("hs", got[4].hs[:, rows], want.hs[:, rows]),
                        ("pitch logits", pitch[rows_l],
                         want_l.pitch_logits[rows_l]),
                        ("dur logits", dur[rows_l], want_l.dur_logits[rows_l]),
                        ("summary, logits out", summ_l[rows_l],
                         want_l.summary[rows_l])):
                    a, b = a.float(), b.float()
                    err = (a - b).abs().max().item()
                    tol = BF16_TOL * (1.0 + b.abs().max().item())
                    check(err <= tol, f"K1 bf16 {wname} B={B} {name}: "
                          f"max|err| {err} > {tol}")
                    errs.append(f"{name} {err:.3g} ({err / tol:.2f} of tol)")
                    if "logits" in name:
                        k1bl_err = max(k1bl_err, err)
                    else:
                        k1b_err = max(k1b_err, err)
                hist = torch.bincount(got[2].long(), minlength=16).tolist()
                print(f"  K1 bf16 {wname} B={B}: " + "; ".join(stats)
                      + "; on agreeing rows max|err| " + ", ".join(errs)
                      + f"; two launches bit-identical in both modes; "
                      f"lengths {hist}")
    pool_slots = pooled["slots_agree"] / pooled["slots"]
    pool_lens = pooled["len_agree"] / pooled["rows"]
    print(f"  K1 bf16, all cases: decided slots agree {pool_slots:.6f} of "
          f"{pooled['slots']}, lengths {pool_lens:.6f} of {pooled['rows']} "
          f"rows; launches by (kernel, dtypes at the call): "
          f"{launch_summary(seen)}")
    check(pool_slots >= BF16_POOL_AGREE and pool_lens >= BF16_LEN_AGREE,
          f"K1 bf16: pooled agreement slots {pool_slots}, lengths "
          f"{pool_lens}")
    check(all(v == {"torch.bfloat16"} for (_, v) in seen),
          f"a bf16 launch received another dtype: {launch_summary(seen)}")
    phase("K1 bf16 vs plain", t0)

    # 7e. K2 in bf16 (K2a + K2b), both modes, vs autograd of the plain
    # version
    t0 = time.perf_counter()
    k2ab_err = k2bb_err = 0.0
    with launch_dtypes() as seen:
        for wname, (p, _) in weight_sets.items():
            B = 128
            cw, inp = to_bf16(*frame_case(p, cfg, B, gen))
            with torch.no_grad():
                rows = k1_rows(cw, spec, inp)[0]
            inp = {k: (v if k == "coins" else v[rows])
                   for k, v in inp.items()}
            n = int(rows.sum())
            g_nums = torch.rand(1 + spec.dur_width, device=dev,
                                generator=gen)
            g_summ = torch.randn(n, 2 * cfg.dec_emb_hidden, device=dev,
                                 generator=gen).to(BF16)
            cots = (torch.randn(n, K - 1, P, device=dev,
                                generator=gen).to(BF16),
                    torch.randn(n, K - 1, spec.dur_width, 2, device=dev,
                                generator=gen).to(BF16), g_summ)
            for mode, got, want in (
                    ("loss", k2_grads(cw, spec, inp, g_nums, g_summ, False),
                     k2_grads(cw, spec, inp, g_nums, g_summ, True)),
                    ("logits out", core_grads(cw, spec, inp, cots, False),
                     core_grads(cw, spec, inp, cots, True))):
                torch.cuda.synchronize()
                names = list(tf.CoreWeights._fields) + ["d_frame_h",
                                                        "d_x_emb"]
                worst = []
                for name, a, b in zip(names, got, want):
                    check(a.dtype == BF16 and b.dtype == BF16,
                          f"K2 bf16 {name}: gradient dtype {a.dtype}")
                    a, b = a.float(), b.float()
                    err = (a - b).abs().max().item()
                    tol = BF16_GRAD_TOL * (1.0 + b.abs().max().item())
                    check(err <= tol, f"K2 bf16 {mode} {wname} {name}: "
                          f"max|err| {err} > {tol}")
                    worst.append((err / tol, name, err))
                    if name.startswith("d_"):
                        k2ab_err = max(k2ab_err, err)
                    else:
                        k2bb_err = max(k2bb_err, err)
                top = sorted(worst, reverse=True)[:3]
                print(f"  K2 bf16 {mode} {wname} B={n}: all 26 gradients "
                      f"within tolerance; closest to it: "
                      + ", ".join(f"{n_} {e:.3g} ({r:.2f} of tol)"
                                  for r, n_, e in top))
    print(f"  launches by (kernel, dtypes at the call): "
          f"{launch_summary(seen)}")
    check(all(v == {"torch.bfloat16"} for (_, v) in seen),
          f"a bf16 launch received another dtype: {launch_summary(seen)}")
    phase("K2 bf16 vs autograd of plain", t0)

    # 7f. K2a alone against frame_bwd_plain on the same K1 stash: f32 against
    # the plain version in f64 (the plain f32 path beside it, plain TF32 the
    # control that must miss the gate), bf16 against the bf16 plain
    # version, and two launches' bits
    t0 = time.perf_counter()
    k2a_gate = {}
    for B in K2A_GATE_B:
        for bf16 in (False, True):
            key = f"{'bf16' if bf16 else 'f32'} B={B}"
            r = k2a_gate_case(params, cfg, gen, B, bf16)
            k2a_gate[key] = r
            fmt = lambda d: max(d.values())
            worst = lambda d: max(d, key=d.get)
            if bf16:
                e = r["vs_plain"]
                print(f"  K2a bf16 B={B} vs frame_bwd_plain in bf16: "
                      f"{fmt(e):.3g} x (1 + max|plain|) at {worst(e)} (gate "
                      f"{BF16_GRAD_TOL}); two launches bit-identical: "
                      f"{r['bit_identical']}")
                check(fmt(e) <= BF16_GRAD_TOL, f"K2a bf16 B={B} vs plain "
                      f"{e}")
            else:
                e, p32, t32 = (r["vs_f64"], r["plain_f32_vs_f64"],
                               r["tf32_vs_f64"])
                print(f"  K2a f32 B={B} vs frame_bwd_plain in f64: "
                      f"{fmt(e):.3g} x (1 + max|ref|) at {worst(e)} (gate "
                      f"{K2A_F64_TOL}); the plain version in f32 "
                      f"{fmt(p32):.3g}; in TF32, the control, {fmt(t32):.3g}"
                      f" at {worst(t32)}; two launches bit-identical: "
                      f"{r['bit_identical']}")
                print("    by output (kernel / plain f32): " + ", ".join(
                    f"{n} {e[n]:.2e}/{p32[n]:.2e}" for n in e))
                check(fmt(e) <= K2A_F64_TOL, f"K2a f32 B={B} vs f64 {e}")
                check(fmt(t32) > K2A_F64_TOL, f"K2a B={B}: the TF32 control "
                      f"passes the f64 gate: {t32}")
            check(r["bit_identical"], f"K2a {key}: two launches differ")
            print(f"    K2a {r['ms']:.4f} ms (queued behind a sleep kernel: "
                  f"{r['queued']}), frame_bwd_plain {r['plain_ms']:.3f} ms "
                  "(CUDA events)")
    phase("K2a vs frame_bwd_plain", t0)

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
    serving, _ = serve_workflows(sampler, SIZES, rng, gen)
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
    # unchunked requests wider than the clusters the card holds at once:
    # one K4 launch of all the rows, against the fixed-batch sampler's grids
    wide = Sampler(params, cfg, device=dev)
    for n in WIDE_SIZES:
        pr1, c1 = requests(rng, n)
        before = full_decoder.decode_grid_full.launches
        times = []
        for _ in range(3):
            s0 = time.perf_counter()
            got = wide.swap(pr1, pr1, c1, c1, True, True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
        one = full_decoder.decode_grid_full.launches - before
        ag = float((got == sampler.swap(pr1, pr1, c1, c1, True, True)).mean())
        p50 = float(np.median(times)) * 1e3
        plan = build.plan_on_card(wide.fw, dims, n, True, dev)
        serving[f"swap_unchunked/{n}"] = {"p50_ms": p50,
                                          "segments_per_s": n / p50 * 1e3,
                                          "plan": plan._asdict()}
        print(f"  unchunked swap n={n}: p50 {p50:.2f} ms, {one} K4 "
              f"launches in 3 calls, plan {plan._asdict()}; agreement with "
              f"the fixed-batch grids {ag:.6f}")
        check(one == 3, f"unchunked swap n={n}: {one} K4 launches, not 3")
        check(ag >= AGREE, f"unchunked swap n={n} vs fixed-batch grids {ag}")
    launches["K4"] = full_decoder.decode_grid_full.launches
    phase("serving", t0)

    # 8b. serving in bf16 (compute_dtype="bfloat16"): the K3 route, the
    # main path of K3's bf16 mode, counted, with the dtypes at every launch
    t0 = time.perf_counter()
    try:
        Sampler(params, cfg_b, fixed_batch=128, device=dev)
    except NotImplementedError as e:
        print(f"  bf16 with the K4 route refused when the Sampler is built: "
              f"{str(e)[:90]}...")
    else:
        check(False, "a bf16 Sampler took the K4 route")
    b_sampler = Sampler(params, cfg_b, frame_decoder="frame",
                        fixed_batch=128, device=dev)
    check(b_sampler.fw.w_hh.dtype == BF16
          and b_sampler.fw.gi_d.dtype == torch.float32,
          "the bf16 Sampler's folds are not bf16 with f32 constants")
    check(not torch.backends.cuda.matmul
          .allow_bf16_reduced_precision_reduction,
          "the bf16 Sampler must keep cuBLAS partial sums in f32")
    b_sampler.swap(ref_pr, ref_pr, ref_c, ref_c, True, True)   # warm-up
    full_decoder.decode_grid_full.launches = 0
    ar_decoder.frame_decode.launches = 0
    with decode_launch_dtypes() as seen:
        serving_bf16, chunks = serve_workflows(b_sampler, SERVE_BF16_SIZES,
                                               rng, gen)
    launches_b = {"K3": ar_decoder.frame_decode.launches,
                  "K4": full_decoder.decode_grid_full.launches}
    print(f"  launches in {chunks} decode chunks of <= 128 rows: "
          f"{launches_b}; by (entry point, dtypes at the call) "
          f"{launch_summary(seen)}")
    check(launches_b == {"K3": spec.num_step * chunks, "K4": 0},
          f"bf16 serving launches {launches_b}, expected "
          f"{spec.num_step * chunks} K3 and no K4")
    check(all(k == "pctd_frame_decode_bf16" and v == {"torch.bfloat16"}
              for (k, v) in seen)
          and sum(seen.values()) == launches_b["K3"],
          f"a bf16 K3 launch received another dtype or entry point: "
          f"{launch_summary(seen)}")
    # the served swap at n=128 against the plain bf16 route on the card,
    # and against the f32 grids (the control: the gate tells them apart)
    pr_s, c_s = requests(rng, 128)
    via_b = b_sampler.swap(pr_s, pr_s, c_s, c_s, True, True)
    k3_before = ar_decoder.frame_decode.launches
    with plain_decode():
        via_plain = b_sampler.swap(pr_s, pr_s, c_s, c_s, True, True)
    check(ar_decoder.frame_decode.launches == k3_before,
          "the plain bf16 route launched K3")
    via_f32 = frame_sampler.swap(pr_s, pr_s, c_s, c_s, True, True)
    ag_plain = float((via_b == via_plain).mean())
    ag_f32 = float((via_b == via_f32).mean())
    print(f"  bf16 swap n=128: grid agreement with the plain bf16 route on "
          f"the card {ag_plain:.6f} (>= {AGREE}); with the f32 K3 route "
          f"{ag_f32:.6f} (the control, < 1)")
    check(ag_plain >= AGREE, f"bf16 served grids vs the plain bf16 route "
          f"{ag_plain}")
    check(ag_f32 < 1.0, "the bf16 swap equals the f32 swap: the gate cannot "
          "tell bf16 from f32")
    # the K3 route's swap at n=128 in f32 and bf16, in turns
    turns = {"f32": (frame_sampler, []), "bf16": (b_sampler, [])}
    for _ in range(TURNS):
        for name, (smp, ms) in turns.items():
            s0 = time.perf_counter()
            smp.swap(pr_s, pr_s, c_s, c_s, True, True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - s0) * 1e3)
    k3_turns = {k: float(np.median(ms)) for k, (_, ms) in turns.items()}
    print(f"  K3 route swap n=128 in turns, median of {TURNS}: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in k3_turns.items())
          + "; calls " + "; ".join(
              f"{k} " + " ".join(f"{v:.1f}" for v in ms)
              for k, (_, ms) in turns.items()))
    # one swap of each K3 route under the profiler (after a warm-up call)
    swap = lambda smp: (lambda: smp.swap(pr_s, pr_s, c_s, c_s, True, True))
    profile_call(swap(b_sampler), "bf16 swap n=128, warm-up")
    profiles = {"bf16": profile_call(swap(b_sampler), "bf16 swap n=128"),
                "f32": profile_call(swap(frame_sampler),
                                    "f32 K3-route swap n=128")}
    serving_bf16.update({"launches": launches_b, "profiles": profiles,
                         "swap128_vs_plain_bf16": ag_plain,
                         "swap128_vs_f32": ag_f32,
                         "k3_route_swap128_ms_in_turns": k3_turns})
    phase("serving (bf16)", t0)

    # 9. training: the main path, counted
    t0 = time.perf_counter()
    tcfg = TrainConfig(batch_size=TRAIN_B, accum_steps=1, seed=args.seed)
    corpora = (segments(rng, 64), segments(rng, 16))
    train_b, val_b = make_loaders(*corpora, TRAIN_B, seed=args.seed)
    trainer = tr.Trainer(cfg, tcfg, train_b, val_b, device=dev)
    # the same loader again, for the first batch the trainer will take
    first = next(make_loaders(*corpora, TRAIN_B, seed=args.seed)[0].epoch())
    x, c, pr_mat, _ = tr.batch_features(*trainer._to_device(first), cfg)
    k1_before = tf.frame_fwd.launches
    with plain_frames():
        ref_m, ref_g = tr.loss_and_grads(
            trainer.params, cfg, tcfg, schedules.train_params_at(0, tcfg),
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
    n_val, py = len(val_b), python_steps(trainer)
    print(f"  launches in {TRAIN_STEPS} train steps ({py} run by Python: "
          f"{trainer.step_captures} capture, {trainer.step_replays} "
          f"replays) + {n_val} eval batch(es): {train_launches}")
    T = spec.num_step
    check((trainer.step_captures, trainer.step_replays, py)
          == (1, TRAIN_STEPS - 1, 2),
          f"captures {trainer.step_captures}, replays "
          f"{trainer.step_replays}")
    check(train_launches == {"K1": T * (py + n_val), "K2a": T * py,
                             "K2b": T * py},
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
            lo_trainer.params, cfg_lo, tcfg,
            schedules.train_params_at(0, tcfg), step_gen(), x, c, pr_mat)
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
    n_val, py = len(lo_val_b), python_steps(lo_trainer)
    print(f"  launches in {LOGITS_STEPS} train steps ({py} run by Python) "
          f"+ {n_val} eval batch(es) with logits out: {lo_launches}; "
          f"loss-mode and decode kernels {others}")
    check(lo_launches == {"K1": T * (py + n_val), "K2a": T * py,
                          "K2b": T * py},
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

    # 9c. training in bf16 (compute_dtype="bfloat16") in each loss mode: the
    # main path of the bf16 mode of K1, K2a and K2b, counted, with the
    # dtypes at every launch recorded
    bf16_runs = {}
    for mode, fused in (("fused", True), ("logits out", False)):
        t0 = time.perf_counter()
        cfg_b = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                    fused_loss=fused)
        b_train, b_val = make_loaders(*corpora, TRAIN_B, seed=args.seed)
        b_trainer = tr.Trainer(cfg_b, tcfg, b_train, b_val, device=dev)
        fwd_k, bwd_k = ((tf.frame_fwd, tf.frame_bwd) if fused else
                        (tf.frame_core_fwd, tf.frame_core_bwd))
        k1_before = fwd_k.launches
        with plain_frames():
            b_ref_m, b_ref_g = tr.loss_and_grads(
                b_trainer.params, cfg_b, tcfg,
                schedules.train_params_at(0, tcfg), step_gen(), x, c,
                pr_mat)
        check(fwd_k.launches == k1_before,
              "the plain reference step launched K1")
        # building the bf16 Trainer pins cuBLAS to f32 partial sums;
        # PyTorch's default allows bf16 ones
        check(not torch.backends.cuda.matmul
              .allow_bf16_reduced_precision_reduction,
              "the bf16 train path must keep cuBLAS partial sums in f32")
        b_ref_m = {k: v.item() for k, v in b_ref_m.items()}
        b_ref_norm = global_norm(b_ref_g).item()
        del b_ref_g
        for f in counted:
            f.launches = 0
        with launch_dtypes() as seen:
            b_trainer.train_steps(BF16_STEPS)
            b_val_m = b_trainer.eval_epoch()
            torch.cuda.synchronize()
        b_launches = {"K1": fwd_k.launches, "K2a": bwd_k.launches,
                      "K2b": tf.weight_grads.launches}
        others = {f.__name__: f.launches for f in counted
                  if f not in (fwd_k, bwd_k, tf.weight_grads)}
        n_val, py = len(b_val), python_steps(b_trainer)
        print(f"  launches in {BF16_STEPS} bf16 train steps ({py} run by "
              f"Python) + {n_val} eval batch(es), {mode}: {b_launches}; "
              f"other frame and decode kernels {others}; by (kernel, dtypes "
              f"at the call) {launch_summary(seen)}")
        check(b_launches == {"K1": T * (py + n_val), "K2a": T * py,
                             "K2b": T * py},
              f"bf16 {mode} train launches {b_launches}")
        check(not any(others.values()),
              f"the bf16 {mode} path launched another kernel: {others}")
        check(all(v == {"torch.bfloat16"} for (_, v) in seen)
              and sum(seen.values()) == sum(b_launches.values()),
              f"bf16 {mode}: a launch received another dtype: "
              f"{launch_summary(seen)}")
        check(all(t.dtype == torch.float32 for t in b_trainer.leaves)
              and all(m.dtype == torch.float32
                      for m in b_trainer.opt.mu + b_trainer.opt.nu),
              "bf16 training: master params and Adam moments must be f32")
        for i, m in enumerate(b_trainer.history):
            print(f"  step {i + 1}: loss {m['loss']:.6f} recon "
                  f"{m['recon_loss']:.6f} kl {m['kl_loss']:.6f} chord "
                  f"{m['chord_loss']:.6f} grad norm "
                  f"{b_trainer.grad_norms[i]:.6f} "
                  f"({b_trainer.step_seconds[i] * 1e3:.1f} ms)")
            check(all(np.isfinite(v) for v in m.values()),
                  f"bf16 step {i + 1} {m}")
        print(f"  val: loss {b_val_m['loss']:.6f}")
        check(all(np.isfinite(v) for v in b_val_m.values()),
              f"bf16 val {b_val_m}")
        b1 = b_trainer.history[0]
        f32_1 = (trainer if fused else lo_trainer).history[0]
        b_loss_err = max(rel(b1[k], b_ref_m[k]) for k in dv.METRIC_NAMES)
        b_norm_err = rel(b_trainer.grad_norms[0], b_ref_norm)
        vs_f32 = {k: rel(b1[k], f32_1[k]) for k in dv.METRIC_NAMES}
        print(f"  step 1 vs the plain path on the card (bf16): loss "
              f"{b1['loss']!r} vs {b_ref_m['loss']!r}; 11 metrics max rel "
              f"err {b_loss_err:.3g}; grad norm {b_trainer.grad_norms[0]!r} "
              f"vs {b_ref_norm!r} (rel err {b_norm_err:.3g})")
        print(f"  step 1 vs the f32 step on the same batch, noise and "
              f"weights: loss {b1['loss']!r} vs {f32_1['loss']!r}; rel err "
              "by metric " + ", ".join(f"{k} {v:.3g}"
                                       for k, v in vs_f32.items()))
        check(b_loss_err <= BF16_LOSS_RTOL,
              f"bf16 {mode} step 1 metrics rel err {b_loss_err}")
        check(b_norm_err <= BF16_NORM_RTOL,
              f"bf16 {mode} step 1 grad norm rel err {b_norm_err}")
        check(max(vs_f32.values()) <= BF16_VS_F32_RTOL,
              f"bf16 {mode} step 1 vs f32 {vs_f32}")
        # the control: the step-1 gate tells a bf16 step from an f32 one
        check(max(vs_f32.values()) > BF16_LOSS_RTOL,
              f"bf16 {mode} step 1 is within {BF16_LOSS_RTOL} of the f32 "
              f"step: {vs_f32}")
        b_step_ms = float(np.median(b_trainer.step_seconds[1:])) * 1e3
        bf16_runs[mode] = {
            "trainer": b_trainer, "launches": b_launches,
            "step_ms_median_2_to_n": b_step_ms,
            "segments_per_s": TRAIN_B / b_step_ms * 1e3,
            "steps": BF16_STEPS, "batch": TRAIN_B,
            "step1_metric_rel_err": b_loss_err,
            "step1_grad_norm_rel_err": b_norm_err,
            "step1_vs_f32_max_rel": max(vs_f32.values())}
        print(f"  bf16 {mode} train step (median of steps 2..{BF16_STEPS}): "
              f"{b_step_ms:.2f} ms, {TRAIN_B / b_step_ms * 1e3:.1f} "
              f"segments/s")
        phase(f"training (bf16, {mode})", t0)
    bf_fused = bf16_runs["fused"]["trainer"]
    bf_lo = bf16_runs["logits out"]["trainer"]
    b_modes_err = max(rel(bf_lo.history[0][k], bf_fused.history[0][k])
                      for k in dv.METRIC_NAMES)
    print(f"  bf16 step 1, logits out vs fused on the same batch, noise and "
          f"weights: 11 metrics max rel err {b_modes_err:.3g}")
    check(b_modes_err <= MODES_RTOL,
          f"bf16 logits-out vs fused step 1 metrics rel err {b_modes_err}")
    bf16_runs["logits out"]["step1_vs_fused_rel_err"] = b_modes_err

    # 9d-9h. the training run: the train CLI, resume, the evaluate CLI,
    # the pianotree texture encoder, the automatic accumulation; 9i. the
    # serving daemon on the run's checkpoints
    tmp = tempfile.mkdtemp(prefix="pctd_run_")
    try:
        training_run, run_dir = training_run_phases(args, cfg, dev, counted,
                                                    step_ms, tmp)
        models = os.path.join(run_dir, "models")
        serving_daemon = serving_daemon_phase(
            args, cfg, dev, counted, card, models, params, tmp)
        reference_ck = reference_checkpoint_phase(args, cfg, dev, counted,
                                                  models, tmp)
        demo_tree = demo_tree_phase(args, counted, models, tmp)
        data_parallel = data_parallel_phase(args, cfg, dev, counted, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 10. timing
    t0 = time.perf_counter()
    timing, plans = {}, {}
    for B in (128, 512):
        z = torch.randn(B, cfg.z_dim, device=dev, generator=gen)
        inputs = ptd.decode_inputs(params["dec"], cfg, z)
        h = torch.randn(B, cfg.dec_time_hidden, device=dev,
                        generator=gen) * 0.6
        sos = inputs.sos_emb
        fw_b = bf16_sets["seed"]
        h_b = h.to(BF16)
        sos_b = sos_probe_b[:1].expand(B, -1).contiguous()
        # the row-group kernels, each queued behind a sleep kernel, twice
        # in turns (the per-row kernels they replaced were timed by
        # tools/decode_by_rows.py, which git show c1278ea recovers)
        new = {"K3": lambda: ar_decoder.frame_decode(fw, spec, h, sos),
               "K3 bf16": lambda: ar_decoder.frame_decode(fw_b, spec, h_b,
                                                          sos_b),
               "K4": lambda: full_decoder.decode_grid_full(fw, spec,
                                                           *inputs)}
        turns = {k: [] for k in new}
        for _ in range(2):
            for k, fn in new.items():
                q, ok = queued_ms(fn, DECODE_REPS[k])
                check(ok, f"{k} B={B}: the host did not enqueue the timed "
                      "calls within the sleep kernel")
                turns[k].append(q)
        k3, k3b, k4 = (float(np.mean(turns[k]))
                       for k in ("K3", "K3 bf16", "K4"))
        k3p = cuda_ms(lambda: ar_decoder.frame_decode_plain(fw, spec, h,
                                                            sos), 3)
        k4p = cuda_ms(lambda: full_decoder.decode_grid_full_plain(
            fw, spec, *inputs), 1)
        k3bp = cuda_ms(lambda: ar_decoder.frame_decode_plain(fw_b, spec, h_b,
                                                             sos_b), 3)
        timing[B] = {"K3": (k3, k3p, *bound_ms(*frame_work(fw, spec, B))),
                     "K4": (k4, k4p, *bound_ms(*full_work(fw, spec, B))),
                     "K3 bf16": (k3b, k3bp,
                                 *frame_bound_bf16(fw_b, spec, B))}
        plans[B] = {k: build.plan_on_card(fw_b if "bf16" in k else fw, dims,
                                          B, k == "K4", dev)._asdict()
                    for k in new}
        print(f"  B={B} (queued, two turns): " + "; ".join(
                  f"{k} {v[0]:.4f} / {v[1]:.4f} ms"
                  for k, v in turns.items()))
        print(f"  B={B}: plain K3 {k3p:.3f} ms, K3 bf16 {k3bp:.3f}, K4 "
              f"{k4p:.3f}; plans {plans[B]}")
        for name, (ms, pms, bms, by) in timing[B].items():
            print(f"  B={B} {name} bound {bms:.4f} ms ({by}), "
                  f"{bms / ms:.3%} of it")

    W, EH2 = spec.dur_width, 2 * cfg.dec_emb_hidden
    k2a_autograd = {}
    k1_queued = []
    for B in (128, 512):
        cw, inp = frame_case(params, cfg, B, gen)
        inp["coins"].zero_()    # training's steady state: every coin 0
        d = tf.dims_of(cw, spec)
        fwd = lambda: tf.frame_fwd(cw, spec, **inp, stash=True)
        _, _, lens, _, st = fwd()
        d_nums = torch.rand(1 + W, device=dev, generator=gen)
        d_summ = torch.randn(B, EH2, device=dev, generator=gen)
        bwd = lambda: tf.frame_bwd(cw, spec, inp["frame_h"], inp["coins"],
                                   inp["gt_pitch"], inp["gt_dur"], lens, st,
                                   d_nums, d_summ)
        k1, q1 = queued_ms(fwd, K1_REPS)
        k2a = queued_ms(bwd, K2A_REPS)[0]
        with torch.no_grad():
            k1p = cuda_ms(lambda: tf.frame_recon_plain(cw, spec, **inp), 2)
        k2p = cuda_ms(lambda: tf.frame_bwd_plain(
            cw, spec, inp["frame_h"], inp["coins"], inp["gt_pitch"],
            inp["gt_dur"], lens, st, d_nums, d_summ), 2)
        k2_autograd = {"K2a": plain_backward_ms(cw, spec, inp,
                                                (d_nums, d_summ), 2)}
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
        k1l, q2 = queued_ms(fwd_lo, K1_REPS)
        k2al = queued_ms(bwd_lo, K2A_REPS)[0]
        with torch.no_grad():
            k1lp = cuda_ms(lambda: tf.frame_core_plain(
                cw, spec, **core_inputs(inp)), 2)
        k2lp = cuda_ms(lambda: tf.frame_bwd_plain(
            cw, spec, inp["frame_h"], inp["coins"], None, None, lens_lo,
            st_lo, None, d_summ, *cots_lo[:2]), 2)
        k2_autograd["K2a logits"] = plain_backward_ms(cw, spec, inp, cots_lo,
                                                      2, logits=True)
        (f1l, b1l), (f2al, b2al) = train_frame_work(cw, spec, B, logits=True)
        timing[B].update({
            "K1": (k1, k1p, *bound_ms(f1, b1)),
            "K2a": (k2a, k2p, *bound_ms(f2a, b2a, PEAK_3XTF32)),
            "K1 logits": (k1l, k1lp, *bound_ms(f1l, b1l)),
            "K2a logits": (k2al, k2lp, *bound_ms(f2al, b2al, PEAK_3XTF32))})
        print(f"  B={B}: K1 {k1:.3f} ms (plain {k1p:.3f}), K2a {k2a:.4f} ms "
              f"(queued; frame_bwd_plain {k2p:.3f}, autograd of the plain "
              f"frame {k2_autograd['K2a']:.3f})")
        print(f"  B={B}: logits out: K1 {k1l:.3f} ms (plain {k1lp:.3f}), K2a "
              f"{k2al:.4f} ms (frame_bwd_plain {k2lp:.3f}, autograd "
              f"{k2_autograd['K2a logits']:.3f})")
        # the same work in bf16 (weights, frame_h, x_emb rounded)
        cwb, inpb = to_bf16(cw, inp)
        d_summ_b = d_summ.to(BF16)
        fwd_b = lambda: tf.frame_fwd(cwb, spec, **inpb, stash=True)
        _, _, lens_b, _, st_b = fwd_b()
        bwd_b = lambda: tf.frame_bwd(cwb, spec, inpb["frame_h"],
                                     inpb["coins"], inpb["gt_pitch"],
                                     inpb["gt_dur"], lens_b, st_b, d_nums,
                                     d_summ_b)
        k1b, q3 = queued_ms(fwd_b, K1_REPS)
        k2ab = queued_ms(bwd_b, K2A_REPS)[0]
        with torch.no_grad():
            k1bp = cuda_ms(lambda: tf.frame_recon_plain(cwb, spec, **inpb), 2)
        k2bp = cuda_ms(lambda: tf.frame_bwd_plain(
            cwb, spec, inpb["frame_h"], inpb["coins"], inpb["gt_pitch"],
            inpb["gt_dur"], lens_b, st_b, d_nums, d_summ_b), 2)
        k2_autograd["K2a bf16"] = plain_backward_ms(cwb, spec, inpb,
                                                    (d_nums, d_summ_b), 2)
        fwd_lb = lambda: tf.frame_core_fwd(cwb, spec, **core_inputs(inpb),
                                           stash=True)
        pitch_b, dur_b, _, lens_lb, _, st_lb = fwd_lb()
        cots_lb = (torch.randn(pitch_b.shape, device=dev,
                               generator=gen).to(BF16),
                   torch.randn(dur_b.shape, device=dev,
                               generator=gen).to(BF16), d_summ_b)
        bwd_lb = lambda: tf.frame_core_bwd(cwb, spec, inpb["frame_h"],
                                           inpb["coins"], lens_lb, st_lb,
                                           *cots_lb)
        k1blo, q4 = queued_ms(fwd_lb, K1_REPS)
        k1_queued.append(q1 and q2 and q3 and q4)
        k2ablo = queued_ms(bwd_lb, K2A_REPS)[0]
        with torch.no_grad():
            k1blp = cuda_ms(lambda: tf.frame_core_plain(
                cwb, spec, **core_inputs(inpb)), 2)
        k2blp = cuda_ms(lambda: tf.frame_bwd_plain(
            cwb, spec, inpb["frame_h"], inpb["coins"], None, None, lens_lb,
            st_lb, None, d_summ_b, *cots_lb[:2]), 2)
        k2_autograd["K2a bf16 logits"] = plain_backward_ms(
            cwb, spec, inpb, cots_lb, 2, logits=True)
        (f1b, b1b), (f2ab, b2ab) = train_frame_work(cwb, spec, B)
        (f1lb, b1lb), (f2alb, b2alb) = train_frame_work(cwb, spec, B,
                                                        logits=True)
        peak = PEAK_BF16_FLOPS
        timing[B].update({
            "K1 bf16": (k1b, k1bp, *bound_ms(f1b, b1b, peak)),
            "K2a bf16": (k2ab, k2bp, *bound_ms(f2ab, b2ab, PEAK_3XBF16)),
            "K1 bf16 logits": (k1blo, k1blp, *bound_ms(f1lb, b1lb, peak)),
            "K2a bf16 logits": (k2ablo, k2blp,
                                *bound_ms(f2alb, b2alb, PEAK_3XBF16))})
        k2a_autograd[B] = k2_autograd
        print(f"  B={B} bf16: K1 {k1b:.3f} ms (plain {k1bp:.3f}), K2a "
              f"{k2ab:.4f} ms (frame_bwd_plain {k2bp:.3f}, autograd "
              f"{k2_autograd['K2a bf16']:.3f}); logits out: K1 {k1blo:.3f} "
              f"ms (plain {k1blp:.3f}), K2a {k2ablo:.4f} ms "
              f"(frame_bwd_plain {k2blp:.3f}, autograd "
              f"{k2_autograd['K2a bf16 logits']:.3f})")
        rates = {"K1": "67 TFLOP/s f32", "K2a": "3xTF32, 165 TFLOP/s",
                 "K1 bf16": "bf16 tensor peak",
                 "K2a bf16": "3xbf16, 329.7 TFLOP/s"}
        for name in ("K1", "K2a", "K1 logits", "K2a logits", "K1 bf16",
                     "K2a bf16", "K1 bf16 logits", "K2a bf16 logits"):
            ms, pms, bms, by = timing[B][name]
            print(f"  B={B} {name} bound {bms:.4f} ms ({by}, "
                  f"{rates[name.replace(' logits', '')]}), {bms / ms:.3%} "
                  "of it")
        del st, st_lo, st_b, st_lb
    check(all(k1_queued), "K1: the host did not enqueue the timed calls "
          "within the sleep kernel")
    opt_ms = optimizer_ms(trainer, 5)
    print(f"  optimizer step (clip + Adam, all parameters): {opt_ms:.3f} ms")
    profile = profile_step(trainer)
    training.update({"optimizer_ms": opt_ms, "profile": profile})
    print("  with logits out:")
    training_lo["profile"] = profile_step(lo_trainer)
    print("  bf16, fused:")
    bf16_runs["fused"]["profile"] = profile_step(bf_fused)
    # the loss modes' and dtypes' train steps in turns (host clock, each
    # step ends in a host read of its metrics)
    turns = {"fused": (trainer, []), "logits_out": (lo_trainer, []),
             "bf16_fused": (bf_fused, []), "bf16_logits_out": (bf_lo, [])}
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
    training_bf16 = {k.replace(" ", "_"): {n: v for n, v in r.items()
                                           if n != "trainer"}
                     for k, r in bf16_runs.items()}
    phase("timing", t0)

    # 10a. K1 by phase: the row-group K1 whole (the plan's cluster size and
    # the other) and each phase alone, queued behind a sleep kernel, at
    # B=128 and 512 in both storage types and modes, every coin 0; one SM's
    # bulk-copy rate from L2 (the floor under K1's weight ring); and the
    # parent's per-row K1 (tools/k1_by_rows.py on the parent's checkout)
    # beside, where its JSON is given
    t0 = time.perf_counter()
    k1_phases = {}
    for B in (128, 512):
        cw, inp = frame_case(params, cfg, B, gen)
        inp["coins"].zero_()
        for bf16 in (False, True):
            cwx, inpx = to_bf16(cw, inp) if bf16 else (cw, inp)
            for logits in (False, True):
                key = (f"{'bf16' if bf16 else 'f32'} "
                       f"{'logits' if logits else 'loss'} B={B}")
                r = k1_by_phase(cwx, spec, inpx, B, logits)
                check(all(q for _, q in r.values()), f"K1 {key}: the host did "
                      "not enqueue the timed calls within the sleep kernel")
                k1_phases[key] = {k: ms for k, (ms, _) in r.items()}
                print(f"  K1 {key} (ms a launch, queued): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in k1_phases[key].items()))
    k1_stream = l2_stream_rates(dev)
    print("  L2 -> shared memory by bulk copies, 4 stages of 16 KB: "
          + ", ".join(f"{k} {v:.1f} GB/s a block" for k, v in
                      k1_stream.items()))
    parent_k1 = {}
    if args.parent_k1:
        with open(args.parent_k1) as f:
            parent_k1 = json.loads(f.read().strip().splitlines()[-1])
        for key, res in parent_k1.items():
            if key.startswith(("f32", "bf16")) and "coins=zero" in key:
                mine = k1_phases.get(key.replace(" coins=zero", ""), {})
                new_ms = next((v for k, v in mine.items() if "plan" in k),
                              None)
                # the parent's plan: 1 row a block at B=128, 4 at B=512
                was = res["R=1" if "B=128" in key else "R=4"][0]
                print(f"  parent's per-row K1 {key}: " + ", ".join(
                    f"{k} {v[0]:.4f}" for k, v in res.items())
                    + (f"; this K1 (plan) {new_ms:.4f} ms, the parent's "
                       f"plan / this {was / new_ms:.3f}x" if new_ms else ""))
    training["k1_by_phase_ms"] = k1_phases
    training["l2_stream_gbs"] = k1_stream
    phase("K1 by phase", t0)

    # 10b. K2b by task: its time on each reduction alone and on all of them,
    # its gates (f64 reference, bf16 ulps, with a control that each must
    # refuse, bit identity), its device time from the profiled train steps,
    # the mma.sync ceilings on its bound, and a train step with K2b and one
    # with wgrad_plain in its place, in turns
    t0 = time.perf_counter()
    k2b = {"mma_ceilings_tflops": mma_ceilings(dev)}
    print("  mma.sync issue-rate ceilings (register operands, 32 warps an "
          "SM): " + ", ".join(f"{k} {v:.1f} TFLOP/s"
                             for k, v in k2b["mma_ceilings_tflops"].items())
          + f" (data sheet: tf32 {PEAK_TF32_FLOPS / 1e12:.0f}, bf16 "
          f"{PEAK_BF16_FLOPS / 1e12:.0f})")
    for B in (128, 512):
        for bf16 in (False, True):
            key = "K2b bf16" if bf16 else "K2b"
            r = k2b_case(wgrad_inputs(params, cfg, gen, B, bf16), bf16)
            k2b[f"{key} B={B}"] = r
            timing[B][key] = (r["ms"], r["plain_ms"], *r["bound"])
            print(f"  {key} B={B}: {r['ms']:.4f} ms (queued behind a sleep "
                  f"kernel: {r['queued_behind_sleep']}; CUDA events alone "
                  f"{r['ms_cuda_events']:.4f} ms), wgrad_plain "
                  f"{r['plain_ms']:.4f} ms (CUDA events alone "
                  f"{r['plain_ms_cuda_events']:.4f}), below it: "
                  f"{r['ms'] < r['plain_ms']}; bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, "
                  f"{'3xbf16' if bf16 else '3xTF32'} rate), "
                  f"{r['bound'][0] / r['ms']:.2%} of it")
            print("    by task (ms alone, queued; N, I, O, bias; slices): "
                  + ", ".join(f"{n} {v:.4f} {tuple(sh)} {r['slices'][n]}"
                              for (n, v), sh in
                              zip(r["per_task_ms"].items(), r["tasks"])))
            print(f"    plan: {r['items']} items of <= {r['item_chunks_max']} "
                  f"chunks of {tf.WG_CHUNK} samples, f32 workspace "
                  f"{r['workspace_bytes']} bytes")
            print(f"    vs f64: {r['vs_f64']:.3g} x (1 + max|ref|) (gate "
                  f"{WGRAD_F64_TOL}); wgrad_plain f32 {r['plain_vs_f64']:.3g}"
                  + ("" if bf16 else f"; single-pass TF32 control "
                     f"{r['tf32_vs_f64']:.3g}")
                  + (f"; vs wgrad_plain in bf16 ulps: {r['ulps']}; the "
                     f"control (dY rounded to TF32): {r['control_ulps']}"
                     if bf16 else "")
                  + f"; vs wgrad_plain {r['vs_plain']:.3g}; two launches "
                  f"bit-identical: {r['bit_identical']}")
    # K2b's device time a launch from torch.profiler, in the profiled f32
    # and bf16 fused steps at B=128 (T launches a step, each its pass 1
    # and its slice sum)
    for key, prof in (("K2b B=128", training["profile"]),
                      ("K2b bf16 B=128", bf16_runs["fused"]["profile"])):
        if not prof["measured"]:
            k2b[key]["profiler_ms"] = None
            continue
        seen = prof["kernel_count"].get("K2b", 0)
        check(seen == 2 * T, f"{key}: the profiled step saw {seen} K2b "
              f"kernels, expected {2 * T} (two a launch)")
        k2b[key]["profiler_ms"] = prof["kernel_ms"]["K2b"] / T
        print(f"  {key}: profiler device time {k2b[key]['profiler_ms']:.4f}"
              f" ms a launch ({seen} kernels over {T} launches in the "
              f"profiled step) beside {k2b[key]['ms']:.4f} ms queued")
    for name, r in k2b.items():
        if not name.startswith("K2b"):
            continue
        bf16 = "bf16" in name
        check(r["queued_behind_sleep"], f"{name}: the host did not enqueue "
              "the timed calls within the sleep kernel")
        check(r["bit_identical"], f"{name}: two launches differ")
        check(r["vs_plain"] <= (BF16_GRAD_TOL if bf16 else GRAD_TOL),
              f"{name} vs its plain version {r['vs_plain']}")
        if bf16:
            check(r["ulps"]["over_one_outside_f32_gate"] == 0,
                  f"{name}: elements over one bf16 ulp from wgrad_plain miss "
                  f"the f32 gate too: {r['ulps']}")
            check(r["control_ulps"]["over_one_outside_f32_gate"] > 0,
                  f"{name}: the control (dY rounded to TF32) passes the "
                  f"bf16 gate: {r['control_ulps']}")
        else:
            check(r["vs_f64"] <= WGRAD_F64_TOL,
                  f"{name} vs f64 {r['vs_f64']} > {WGRAD_F64_TOL}")
            check(r["tf32_vs_f64"] > WGRAD_F64_TOL,
                  f"{name}: the single-pass TF32 control "
                  f"{r['tf32_vs_f64']} is within the f64 gate")
    # the f32 fused train step with K2b and with wgrad_plain, in turns,
    # both run eagerly (a step graph's replay runs K2b whatever the route),
    # and the main path's step, a replay, beside them
    step_turns = {"K2b": [], "wgrad_plain": [], "replay": []}
    stream = trainer.batches()
    tf.weight_grads.launches = 0
    for _ in range(TURNS):
        step_turns["K2b"].append(eager_step_ms(trainer, next(stream)))
        with plain_wgrad():
            step_turns["wgrad_plain"].append(
                eager_step_ms(trainer, next(stream)))
        trainer.train_step(next(stream))
        step_turns["replay"].append(trainer.step_seconds[-1] * 1e3)
    check(tf.weight_grads.launches == T * TURNS,
          f"K2b launches in the turns {tf.weight_grads.launches}")
    k2b["step_ms_in_turns"] = {k: float(np.median(v))
                               for k, v in step_turns.items()}
    print(f"  f32 fused train step in turns, median of {TURNS}: "
          + ", ".join(f"{k} {v:.2f} ms"
                      for k, v in k2b["step_ms_in_turns"].items())
          + "; steps " + "; ".join(f"{k} " + " ".join(f"{v:.1f}" for v in ms)
                                   for k, ms in step_turns.items()))
    with plain_wgrad():
        batch = next(trainer.batches())
        k2b["profile_wgrad_plain"] = profile_call(
            lambda: eager_step_ms(trainer, batch), "step")
    training["k2b"] = k2b
    phase("K2b by task", t0)

    # 10c. K2a by phase: all of it, each of its kernels alone, and each of
    # the two chains that share the chain kernel alone, queued behind a
    # sleep kernel, at B=128 and 512 in both storage types (loss mode; a
    # phase alone reads what the launch before it left), the chains also at
    # each cluster size; and K2a's kernels in the profiled steps (three a
    # launch)
    t0 = time.perf_counter()
    k2a_phases = {}
    ph = build.K2A_PHASES
    chains = ph["note"] | ph["summary"]
    variants = {"all": {}, "slots (2b)": dict(phases=ph["slots"]),
                "chains (2a + 2c)": dict(phases=chains),
                "note chain (2c)": dict(phases=ph["note"]),
                "summary chain (2a)": dict(phases=ph["summary"]),
                "proj (2d)": dict(phases=ph["proj"]),
                **{f"chains C={c}": dict(phases=chains, cluster=c)
                   for c in K2A_CLUSTERS}}
    for B in (128, 512):
        for bf16 in (False, True):
            key = f"{'bf16' if bf16 else 'f32'} B={B}"
            r = k2a_launch_ms(spec, k2a_case(params, cfg, gen, B, bf16),
                              variants)
            check(all(q for _, q in r.values()), f"K2a {key}: the host did "
                  "not enqueue the timed calls within the sleep kernel")
            k2a_phases[key] = {k: ms for k, (ms, _) in r.items()}
            print(f"  K2a {key} (ms a launch, queued): " + ", ".join(
                f"{k} {v:.4f}" for k, v in k2a_phases[key].items()))
    for key, prof in (("f32 fused", training["profile"]),
                      ("f32 logits out", training_lo["profile"]),
                      ("bf16 fused", bf16_runs["fused"]["profile"])):
        if not prof["measured"]:
            continue
        seen = prof["kernel_count"].get("K2a", 0)
        print(f"  profiled {key} step: {seen} K2a kernels over {T} launches,"
              f" {prof['kernel_ms']['K2a']:.3f} ms")
        check(seen == 3 * T, f"{key}: the profiled step saw {seen} K2a "
              f"kernels, expected {3 * T} (three a launch)")
    training["k2a_by_phase_ms"] = k2a_phases
    training["k2a_vs_plain"] = k2a_gate
    phase("K2a by phase", t0)

    # 10d. K3/K4 by phase: the row-group kernels whole and each phase
    # launched alone (a phase alone reads zeros where the ones before it
    # would have written; "barriers": the slot chain's cluster barriers
    # alone), queued behind a sleep kernel, at B=128 and 512 in clusters
    # of 8 and of 16, and at B=16, one group: its cluster alone on the card
    t0 = time.perf_counter()
    decode_phases = {}
    fw_b = bf16_sets["seed"]
    for B in (16, 128, 512):
        z = torch.randn(B, cfg.z_dim, device=dev, generator=gen)
        inputs = ptd.decode_inputs(params["dec"], cfg, z)
        h = torch.randn(B, cfg.dec_time_hidden, device=dev,
                        generator=gen) * 0.6
        cases = {"K3": (fw, [h, inputs.sos_emb]),
                 "K3 bf16": (fw_b, [h.to(BF16), inputs.sos_emb.to(BF16)]),
                 "K4": (fw, list(inputs))}
        for C in build.DECODE_CLUSTERS:
            for key, (w, ins) in cases.items():
                full = key == "K4"
                variants = {"all": build.PHASES_ALL, **{
                    n: b for n, b in build.DECODE_PHASES.items()
                    if full or n != "time"}}
                if full:   # K4's phases: the whole, its time GRU, its
                    # duration chains and its summaries alone
                    variants = {n: variants[n] for n in ("all", "time",
                                                         "dur", "summary")}
                name = (build.FULL_ENTRY if full
                        else build.FRAME_ENTRY)[w.w_hh.dtype]
                res = {}
                for n, bits in variants.items():
                    outs = phase_outputs(key, w, spec, B, dev)
                    ms, ok = queued_ms(lambda: build.launch(
                        name, w, build.decoder_dims(w, spec), B,
                        [*ins, *outs], phases=bits, cluster=C),
                        DECODE_REPS[key])
                    check(ok, f"{key} {n} B={B} C={C}: the host did not "
                          "enqueue the timed calls within the sleep kernel")
                    res[n] = ms
                info = build.decode_info(w, build.decoder_dims(w, spec),
                                         full, C, dev)
                decode_phases[f"{key} B={B} C={C}"] = res
                print(f"  {key} B={B} C={C} (ms a launch, queued; shared "
                      f"memory {info[0]} B, {info[1]} clusters at once): "
                      + ", ".join(
                          f"{k} {v:.4f}" for k, v in res.items()))
    phase("K3/K4 by phase", t0)

    # 10b. the 32-bar stretch (num_step=128): serving through K4 and the K3
    # route, training through K1/K2a/K2b with its step envelope; the
    # pianotree texture encoder served with the detrended grid
    stretch_serving = stretch_serving_phase(args, dev, counted, gen, rng)
    stretch_training = stretch_training_phase(args, dev, counted)
    pianotree_serving = pianotree_serving_phase(args, dev, counted, rng)

    # 11. kernels
    rows = []
    src = "pctd_tpu_torch/ops/kernels/csrc/decoder.cu"
    sizes = (f"at B = {', '.join(map(str, DECODE_B))} in clusters of "
             f"{' and '.join(map(str, build.DECODE_CLUSTERS))} blocks; the "
             "same bits over two launches")
    for name, fn, err, ag, tol in (
            ("K3 frame_group_kernel", "pctd_tpu/ops/pallas/ar_decoder.py:238",
             k3_err, k3_agree,
             f"pitch/dur/length agreement >= {AGREE}; summary max|err| "
             f"<= {SUMMARY_ATOL} on agreeing rows; {sizes}"),
            ("K4 full_group_kernel", "pctd_tpu/ops/pallas/full_decoder.py:59",
             k4_err, k4_agree,
             f"grid agreement >= {AGREE} (max_abs_err: largest int "
             f"difference of a grid cell); {sizes}")):
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
    ms, pms, bms, by = timing[128]["K3 bf16"]
    rows.append({"name": "K3 frame_group_kernel (bf16)", "route": "cuda",
                 "source": "pctd_tpu_torch/ops/kernels/csrc/decoder.cu "
                           "(instantiated in csrc/decoder_bf16.cu)",
                 "replaces": "pctd_tpu/ops/pallas/ar_decoder.py:238",
                 "launches": launches_b["K3"], "max_abs_err": k3b_err,
                 "agreement": k3b_agree, "worst_tie_margin": k3b_margin,
                 "tolerance": f"pitch/dur/length agreement >= {AGREE}, each "
                 f"row's first differing decision a near-tie (margin <= "
                 f"{BF16_TIE}); summary max|err| <= {BF16_SUMMARY_TOL} x "
                 f"(1 + max|plain|) on agreeing rows; {sizes}",
                 "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                 "bound_peak": "h_time products at the dense bf16 989 "
                 "TFLOP/s, the f32-operand products at 67 TFLOP/s",
                 "library_ms": None, "batch": 128,
                 "ms_b512": timing[512]["K3 bf16"][0],
                 "plain_ms_b512": timing[512]["K3 bf16"][1]})
    # the row-group decode kernels: queued times, the plan, the phases
    # alone, the build report, the launches of the daemon's counted requests
    for row in rows:
        key = "K3 bf16" if "bf16" in row["name"] else row["name"][:2]
        if key in serving_daemon["launches"]:
            row["daemon_launches"] = serving_daemon["launches"][key]
        row.update({
            "ms_source": "CUDA events over launches queued behind a sleep "
                         "kernel (device time, host launch hidden)",
            "bound_ms_b512": timing[512][key][2],
            "plan": plans[128][key], "plan_b512": plans[512][key],
            "by_phase_ms": {k: v for k, v in decode_phases.items()
                            if k.rsplit(" B=", 1)[0] == key},
            "registers": {k: v for k, v in decode_regs.items()
                          if k.startswith("full" if key == "K4"
                                          else "frame")},
            "sass_instructions": {k: v for k, v in decode_sass.items()
                                  if k.startswith("full" if key == "K4"
                                                  else "frame")}})
    tsrc = "pctd_tpu_torch/ops/kernels/csrc/train_frame.cu"
    for key, name, fn, err, tol in (
            ("K1", "K1 train_fwd_group_kernel",
             "pctd_tpu/ops/pallas/train_frame.py:289", k1_err,
             f"decisions agree on >= {AGREE} of rows; on those, nums rel "
             f"err <= {NUMS_RTOL}, summary and hs max|err| <= {STATE_ATOL}"),
            ("K2a", K2A_NAME,
             "pctd_tpu/ops/pallas/train_frame.py:736", k2a_err,
             f"d_frame_h, d_x_emb max|err| <= {GRAD_TOL} x (1 + max|plain|)"
             " vs autograd of the plain version; every output and cotangent"
             f" <= {K2A_F64_TOL} x (1 + max|ref|) vs frame_bwd_plain in f64 "
             "(plain TF32 must miss it); the same bits over two launches"),
            ("K2b", "K2b wgrad_kernel",
             "pctd_tpu/ops/pallas/train_frame.py:736", max(k2b_err, k2bl_err),
             f"24 weight grads max|err| <= {GRAD_TOL} x (1 + max|plain|) "
             "vs autograd of the plain version, in both modes"),
            ("K1 logits", "K1 train_fwd_group_kernel (logits out)",
             "pctd_tpu/ops/pallas/train_frame.py:289", k1l_err,
             "decisions and lengths equal the plain version's on every row "
             "and the logits' argmaxes; logits and summary max|err| <= "
             f"{CORE_TOL} x (1 + max|plain|)"),
            ("K2a logits", K2A_NAME + " (logits out)",
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
    b_fused_l = bf16_runs["fused"]["launches"]
    b_lo_l = bf16_runs["logits out"]["launches"]
    for key, name, fn, err, launches_, tol in (
            ("K1 bf16", "K1 train_fwd_group_kernel (bf16)",
             "pctd_tpu/ops/pallas/train_frame.py:289", k1b_err,
             b_fused_l["K1"],
             f"every row's first differing decision a near-tie (margin <= "
             f"{BF16_TIE}); decided slots agree >= {BF16_SLOT_AGREE} a "
             f"case, >= {BF16_POOL_AGREE} pooled, lengths >= "
             f"{BF16_LEN_AGREE} pooled; on agreeing rows nums, summary, hs "
             f"max|err| <= {BF16_TOL} x (1 + max|plain|)"),
            ("K2a bf16", K2A_NAME + " (bf16)",
             "pctd_tpu/ops/pallas/train_frame.py:736", k2ab_err,
             b_fused_l["K2a"],
             f"d_frame_h, d_x_emb max|err| <= {BF16_GRAD_TOL} x (1 + "
             "max|plain|) vs autograd of the plain version, both modes; "
             f"every output and cotangent <= {BF16_GRAD_TOL} x (1 + "
             "max|plain|) vs frame_bwd_plain in bf16"),
            ("K2b bf16", "K2b wgrad_kernel (bf16)",
             "pctd_tpu/ops/pallas/train_frame.py:736", k2bb_err,
             b_fused_l["K2b"] + b_lo_l["K2b"],
             f"24 weight grads max|err| <= {BF16_GRAD_TOL} x (1 + "
             "max|plain|) vs autograd of the plain version, both modes"),
            ("K1 bf16 logits",
             "K1 train_fwd_group_kernel (bf16, logits out)",
             "pctd_tpu/ops/pallas/train_frame.py:289", k1bl_err,
             b_lo_l["K1"],
             f"as K1 bf16; the logits' argmaxes equal the decisions; on "
             f"agreeing rows logits and summary max|err| <= {BF16_TOL} x "
             "(1 + max|plain|)"),
            ("K2a bf16 logits", K2A_NAME + " (bf16, logits out)",
             "pctd_tpu/ops/pallas/train_frame.py:736", k2ab_err,
             b_lo_l["K2a"],
             f"d_frame_h, d_x_emb max|err| <= {BF16_GRAD_TOL} x (1 + "
             "max|plain|) vs autograd of the plain version, both modes")):
        ms, pms, bms, by = timing[128][key]
        rows.append({"name": name, "route": "cuda", "source": tsrc,
                     "replaces": fn, "launches": launches_,
                     "max_abs_err": err, "tolerance": tol, "ms": ms,
                     "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                     "bound_peak": "bf16 dense tensor 989 TFLOP/s",
                     "library_ms": None, "batch": 128,
                     "ms_b512": timing[512][key][0],
                     "plain_ms_b512": timing[512][key][1]})
    # K1: timed queued behind a sleep kernel with every coin 0, by phase,
    # the plan, and the parent's per-row K1 where given
    for row in rows:
        if row["name"].startswith("K1"):
            bf16 = "bf16" in row["name"]
            mode = "logits" if "logits" in row["name"] else "loss"
            key = f"{'bf16' if bf16 else 'f32'} {mode}"
            dt = BF16 if bf16 else torch.float32
            row.update({
                "ms_source": "CUDA events over launches queued behind a "
                             "sleep kernel (device time, host launch "
                             "hidden), every teacher coin 0",
                "bound_ms_b512": timing[512][row["name"].split()[0] + (
                    " bf16" if bf16 else "") + (
                    " logits" if mode == "logits" else "")][2],
                "by_phase_ms": k1_phases[f"{key} B=128"],
                "by_phase_ms_b512": k1_phases[f"{key} B=512"],
                "plan": build.k1_plan_on_card(
                    tf.CoreWeights(*(w.detach().to(dt) for w in cw0)), d0,
                    128, dev)._asdict(),
                "shared_memory": {k: v for k, v in k1_smem.items()
                                  if k.startswith(str(dt))},
                "registers": {k: v for k, v in k1_regs.items()
                              if ("bfloat16" in k) == bf16},
                "sass_instructions": k1_sass,
                "l2_stream_gbs_a_block": k1_stream,
                "parent_per_row_ms": {
                    k: {r: v[0] for r, v in res.items()}
                    for k, res in parent_k1.items()
                    if k.startswith(key) and "coins=zero" in k} or None,
                "same_bits_over_two_launches": True})
    # K2a: timed queued behind a sleep kernel, its plain version
    # frame_bwd_plain (autograd of the plain frame beside it), its bound at
    # the fastest f32-accurate product rate
    for row in rows:
        if row["name"].startswith("K2a"):
            key = "K2a" + ("" if "(" not in row["name"] else " " + " ".join(
                w for w in ("bf16", "logits") if w in row["name"]))
            bf16 = "bf16" in key
            row.update({
                "plain": "frame_bwd_plain (CUDA events)",
                "autograd_ms": k2a_autograd[128][key],
                "autograd_ms_b512": k2a_autograd[512][key],
                "bound_peak": ("3xbf16, 989 / 3 TFLOP/s" if bf16
                               else "3xTF32, 495 / 3 TFLOP/s"),
                "bound_ms_b512": timing[512][key][2],
                "ms_source": "CUDA events over launches queued behind a "
                             "sleep kernel (device time, host launch hidden)",
                "by_phase_ms": k2a_phases[
                    f"{'bf16' if bf16 else 'f32'} B=128"],
                "by_phase_ms_b512": k2a_phases[
                    f"{'bf16' if bf16 else 'f32'} B=512"],
                "vs_plain_gate": {k: max(max(v.get("vs_f64", {}).values(),
                                             default=0.0),
                                         max(v.get("vs_plain", {}).values(),
                                             default=0.0))
                                  for k, v in k2a_gate.items()
                                  if ("bf16" in k) == bf16},
                "registers": k2a_regs, "shared_memory": k2a_smem})
    # K2b: the library yardstick is wgrad_plain (one cuBLAS X^T dY and a
    # column sum a task), its bound the 3xTF32 (bf16: 3xbf16) rate
    for row in rows:
        if row["name"].startswith("K2b"):
            key = "K2b bf16" if "bf16" in row["name"] else "K2b"
            r128, r512 = k2b[f"{key} B=128"], k2b[f"{key} B=512"]
            row.update({
                "library_ms": r128["plain_ms"],
                "library": "wgrad_plain: torch X^T @ dY and dY.sum(0) a "
                           "task (cuBLAS), 16 tasks; timed as K2b",
                "bound_peak": ("3xbf16, 989 / 3 TFLOP/s" if "bf16" in key
                               else "3xTF32, 495 / 3 TFLOP/s"),
                "mma_ceilings_tflops": k2b["mma_ceilings_tflops"],
                "ms_source": "CUDA events over launches queued behind a "
                             "sleep kernel (device time, host launch hidden)",
                "profiler_ms": r128["profiler_ms"],
                "ms_cuda_events": r128["ms_cuda_events"],
                "plain_ms_cuda_events": r128["plain_ms_cuda_events"],
                "per_task_ms": r128["per_task_ms"],
                "bound_ms_b512": r512["bound"][0],
                "ms_cuda_events_b512": r512["ms_cuda_events"],
                "vs_f64": max(r128["vs_f64"], r512["vs_f64"]),
                "workspace_bytes": r128["workspace_bytes"],
                "workspace_bytes_b512": r512["workspace_bytes"],
                "registers": k2b_regs})
    # launches of the stretch: a 128-row chunk (K4 once, the K3 route 128
    # times), a train step (K1, K2a, K2b 128 times); K4's time at T=128
    st = {k: v["launches"] for k, v in stretch_training.items()
          if k != "envelope"}
    for row in rows:
        name = row["name"]
        mode = ("bf16 fused" if "bf16" in name and "logits" not in name
                else "f32 logits out" if "logits" in name
                and "bf16" not in name else "f32 fused"
                if "bf16" not in name else None)
        if name.startswith("K4"):
            row.update(launches_stretch=stretch_serving["launches"]["K4"],
                       ms_t128=stretch_serving["k4_ms"],
                       plain_ms_t128=stretch_serving["k4_plain_ms"],
                       bound_ms_t128=stretch_serving["k4_bound_ms"])
        elif name.startswith("K3"):
            row["launches_stretch_chunk"] = stretch_serving["launches"][
                "K3 bf16" if "bf16" in name else "K3 f32"]
        elif mode is not None:
            fused = "logits" not in mode
            fn = {"K1": tf.frame_fwd if fused else tf.frame_core_fwd,
                  "K2a": tf.frame_bwd if fused else tf.frame_core_bwd,
                  "K2b": tf.weight_grads}[name.split()[0]]
            row["launches_stretch"] = st[mode][fn.__name__]
    # launches of the data-parallel path: K1/K2a/K2b (f32, CE fused in) in
    # the world-1 steps and on each gloo rank; K3 in the demo tree
    dp_fn = {"K1": tf.frame_fwd, "K2a": tf.frame_bwd, "K2b": tf.weight_grads}
    for row in rows:
        key = row["name"].split()[0]
        if key in dp_fn and "(" not in row["name"]:
            fn = dp_fn[key].__name__
            row["launches_data_parallel"] = {
                "world1_nccl_3_steps": data_parallel["world1"]["launches"][
                    fn],
                f"gloo_ranks_{DP_TIMED_STEPS}_steps": [
                    r[fn] for r in data_parallel["two_ranks"]["launches"]]}
        elif row["name"] == "K3 frame_group_kernel":
            row["launches_demo_k3"] = data_parallel["demo_k3"]["launches"][
                ar_decoder.frame_decode.__name__]
    print(json.dumps({"serving": serving, "serving_bf16": serving_bf16,
                      "training": training,
                      "training_logits_out": training_lo,
                      "training_bf16": training_bf16,
                      "training_run": training_run,
                      "serving_daemon": serving_daemon,
                      "reference_checkpoint": reference_ck,
                      "demo_tree": demo_tree,
                      "stretch_serving": stretch_serving,
                      "stretch_training": stretch_training,
                      "pianotree_serving": pianotree_serving,
                      "data_parallel": data_parallel,
                      "graph_at_envelope": graph_at_envelope,
                      "card": card}))
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
