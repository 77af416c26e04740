"""Time K1, the teacher-forced frame forward, on one CUDA card, beside the
L2 bytes its blocks read, in the same cases on the per-row kernel and on
the row-group kernel that replaced it.

Cases: B = 128 and 512, float32 and bfloat16, loss mode and logits out,
with the stash, the teacher coins all 0 (training's steady state: the
coin rate falls to ~3e-7 by step 2) and mixed; canonical-width random
weights (seed 0). Each launch is queued behind a sleep kernel
(``utils/cuda_timing.queued_ms``). The script times what the checkout it
runs in has:

- the per-row K1 (``train_fwd_kernel``, a block of R rows streaming every
  weight from L2 once a frame for them; the checkout's
  ``build.launch_train_fwd`` takes ``rows=R``), at R = 1, 2 and 4, with
  the weight bytes its ceil(B / R) blocks read: per frame ``w_t2n``,
  ``w_ih_frame`` and ``w_hh`` once, each of 15 slots ``w_ih_tok``,
  ``w_pitch``, ``w_dhid``, ``w_dhh`` and ``w_dout`` five times each, and
  14 more ``w_hh``, and 16 times both summary directions' ``we_ih`` and
  ``we_hh``;
- or the row-group K1 (``train_fwd_group_kernel``: a cluster of C blocks a
  group of 16 rows), in clusters of 8 and of 16, and the plan's pick (the
  row groups, or the per-row kernel where the groups would run in waves),
  with the bytes the row groups' clusters read: once a frame the
  projection's weights and the panels' duration and summary weights, and each slot the chain
  panels (``w_ih_tok``, ``w_pitch``, ``w_dhid[:NH]``, ``w_hh``); and, where
  the tree has ``csrc/l2_stream.cu``, one SM's bulk-copy rate from L2 into
  shared memory (the floor under a slot's weight stream), alone and with
  a block on every SM.

Run it from the root of a checkout, e.g. the parent of the row-group
redesign unpacked with ``git archive`` into a git-ignored directory:

    PYTHONPATH=. python3 <path>/pctd_tpu_torch/tools/k1_by_rows.py

It times with ``utils/cuda_timing.py`` of its own tree, loaded by path.
Prints the card's name and power limit, a line a case and, last, one JSON
object of {case: {variant: [ms, queued, L2 GB]}}; exits nonzero without a
card.
"""
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

REPS = 10          # launches a timing averages
STREAM_PANEL = 600 * 1024   # bytes of a block's probe panel (K1's ~575 KB)


def _cuda_timing():
    """``utils/cuda_timing.py`` of this script's own tree (the checkout on
    the path may predate it)."""
    path = Path(__file__).resolve().parents[1] / "utils" / "cuda_timing.py"
    spec = importlib.util.spec_from_file_location("cuda_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_row_bytes(cw, B: int, R: int) -> float:
    """Weight bytes the per-row blocks read from L2 for one launch."""
    es = lambda n: getattr(cw, n).numel() * cw.w_hh.element_size()
    frame = (es("w_t2n") + es("w_ih_frame") + 15 * es("w_hh")
             + 15 * (es("w_ih_tok") + es("w_pitch") + es("w_dhid")
                     + 5 * (es("w_dhh") + es("w_dout")))
             + 16 * (es("we_ih") + es("we_hh")))
    return math.ceil(B / R) * frame


def group_bytes(cw, d, B: int) -> float:
    """Weight bytes the row-group clusters read from L2 for one launch."""
    es = lambda n: getattr(cw, n).numel() * cw.w_hh.element_size()
    dhid_h = d.NH * d.DH * cw.w_hh.element_size()
    frame = (es("w_t2n") + es("w_ih_frame") + es("w_hh")
             + 15 * (es("w_ih_tok") + es("w_pitch") + dhid_h + es("w_hh"))
             + es("w_dhid") - dhid_h + es("w_dhh") + es("w_dout")
             + es("we_ih") + es("we_hh"))
    return math.ceil(B / 16) * frame


def frame_case(cfg, B, gen, coins):
    """Decoder weights and one frame's inputs (loss-mode targets too)."""
    spec = cfg.pianotree
    K, W, P = spec.max_simu_note, spec.dur_width, spec.pitch_range
    dev = gen.device
    rn = lambda *s: torch.randn(s, device=dev, generator=gen)
    ri = lambda hi, *s: torch.randint(0, hi, s, device=dev, generator=gen,
                                      dtype=torch.int32)
    inp = dict(frame_h=rn(B, cfg.dec_time_hidden) * 0.6,
               x_emb=rn(B, K, cfg.note_emb_size) * 0.5,
               coins=ri(2, K - 1), gt_pitch=ri(P + 1, B, K - 1),
               gt_dur=ri(3, B, K - 1, W))
    if coins == "zero":
        inp["coins"].zero_()
    return inp


def stream_rates(build, queued_ms, dev) -> dict:
    """One SM's bulk-copy rate from L2 into shared memory (GB/s), through
    4 stages of 16 and of 32 KB: one block alone, and a block on every SM
    (8 distinct panels, as K1's clusters of 8 read)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = torch.zeros(8 * STREAM_PANEL // 4, device=dev)
    out = {}
    for stage in (16384, 32768):
        for blocks in (1, sms):
            sink = torch.empty(blocks * 256, device=dev)
            reps = 20
            ms, q = queued_ms(lambda: build.launch_l2_stream(
                src, blocks, STREAM_PANEL, 8, stage, 4, reps, sink), 3)
            gbs = STREAM_PANEL * reps / (ms * 1e-3) / 1e9
            out[f"stage={stage} blocks={blocks}"] = [ms, q, gbs]
            print(f"L2 -> shared stream, 4 stages of {stage} B, {blocks} "
                  f"block(s): {gbs:.1f} GB/s a block, {gbs * blocks:.1f} "
                  f"GB/s in all (queued: {q})", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_by_rows: no CUDA device", file=sys.stderr)
        return 2
    queued_ms = _cuda_timing().queued_ms
    from pctd_tpu_torch.config import ModelConfig
    from pctd_tpu_torch.models import disentangle_vae as dv
    from pctd_tpu_torch.ops.kernels import build
    from pctd_tpu_torch.ops.kernels import train_frame as tf

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.build()
    per_row = hasattr(build, "rows_per_block")
    print("kernel:", "per-row train_fwd_kernel" if per_row
          else "row-group train_fwd_group_kernel", flush=True)
    dev = torch.device("cuda")
    cfg = ModelConfig()
    spec = cfg.pianotree
    params = dv.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cw32 = tf.CoreWeights(*(w.detach().contiguous()
                            for w in tf.core_weights(params["dec"], cfg)))
    out = {}
    if not per_row and hasattr(build, "launch_l2_stream"):
        out["l2_stream"] = stream_rates(build, queued_ms, dev)
    for B in (128, 512):
        for coins in ("zero", "mixed"):
            inp32 = frame_case(cfg, B, gen, coins)
            for dt in (torch.float32, torch.bfloat16):
                cw = tf.CoreWeights(*(w.to(dt) for w in cw32))
                inp = {k: (v.to(dt) if v.is_floating_point() else v)
                       for k, v in inp32.items()}
                d = tf.dims_of(cw, spec)
                S, W = d.K - 1, d.W
                st = tf.new_stash(d, B, dev, dt)
                i32 = dict(dtype=torch.int32, device=dev)
                common = [torch.empty(B, 2 * d.EH, dtype=dt, device=dev),
                          torch.empty(B, **i32),
                          torch.empty(B, S, 1 + W, **i32)]
                ins = [inp["coins"], inp["frame_h"], inp["x_emb"]]
                for logits in (False, True):
                    if logits:
                        tensors = [*ins,
                                   torch.empty(B, S, d.P, dtype=dt,
                                               device=dev),
                                   torch.empty(B, S, W, 2, dtype=dt,
                                               device=dev), *common]
                    else:
                        tensors = [*ins, inp["gt_pitch"], inp["gt_dur"],
                                   torch.empty(B, 1 + W, device=dev),
                                   *common]
                    case = (f"{'bf16' if dt == torch.bfloat16 else 'f32'} "
                            f"{'logits' if logits else 'loss'} coins={coins}"
                            f" B={B}")
                    res = {}
                    if per_row:
                        for r in (1, 2, 4):
                            ms, q = queued_ms(
                                lambda r=r: build.launch_train_fwd(
                                    cw, d, B, tensors, st, rows=r,
                                    logits=logits), REPS)
                            res[f"R={r}"] = [ms, q,
                                             per_row_bytes(cw, B, r) / 1e9]
                    else:
                        plan = build.k1_plan_on_card(cw, d, B, dev)
                        pick = (f"C={plan.C}" if plan.C else f"R={plan.R}")
                        for name, c, r in (("C=8", 8, 0), ("C=16", 16, 0),
                                           (f"plan ({pick})", plan.C,
                                            plan.R)):
                            ms, q = queued_ms(
                                lambda c=c, r=r: build.launch_train_fwd(
                                    cw, d, B, tensors, st, logits=logits,
                                    cluster=c, rows=r), REPS)
                            gb = (group_bytes(cw, d, B) if c else
                                  per_row_bytes(cw, B, r))
                            res[name] = [ms, q, gb / 1e9]
                    out[case] = res
                    print(case, ", ".join(
                        f"{k} {ms:.4f} ms (queued: {q}; L2 {gb:.2f} GB, "
                        f"{gb / ms:.2f} TB/s)"
                        for k, (ms, q, gb) in res.items()), flush=True)
                del st
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
