"""Time the per-row decode kernels K3 and K4 by rows a block, on one CUDA
card, beside the L2 bytes each configuration reads.

The per-row kernels (``frame_kernel`` and ``full_kernel`` of
``csrc/decoder.cu`` before the row-group redesign) give each block R batch
rows and stream every weight from L2 once a frame for them. This script
times K3 (float32 and bfloat16) and K4 at R = 1, 2 and 4 rows a block and at
B = 128 and 512, each launch queued behind a sleep kernel, on
canonical-width random weights (seed 0), and prints beside each time the
bytes of weights its blocks read from L2: ceil(B / R) blocks, each reading
per frame ``w_frame`` once, ``w_hh`` 16 times, ``w_slot`` 15 times,
``w_dcomb`` 75 times and the summary's four matrices 16 times (K4 also
``wt_hh`` and ``wt_tok`` once), at the storage type's size. The per-row
kernels have no switch that runs one of their phases alone; the one share
that two launches separate is K4's time GRU and frame loop, K4 / 32 - K3.

The package no longer has the per-row kernels, so the script runs from the
root of a checkout of a commit that has them as its decode kernels (entry
points ``pctd_frame_decode``, ``pctd_frame_decode_bf16`` and
``pctd_full_decode``, launched by that checkout's ``build.launch`` with
``rows=R``), such as the parent of the row-group redesign unpacked with
``git archive`` into a git-ignored directory:

    PYTHONPATH=. python3 <path>/pctd_tpu_torch/tools/decode_by_rows.py

It times with ``utils/cuda_timing.py`` of its own tree, loaded by path.
Prints the card's name and power limit, a line a case and one JSON object
of {case: {"R=r": [ms, queued, L2 GB]}}; exits nonzero without a card.
"""
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

REPS = {"K3": 20, "K3 bf16": 20, "K4": 3}   # launches a timing averages
#: the per-row kernels' entry points in the checkout that has them
ENTRY = {"K3": "pctd_frame_decode", "K3 bf16": "pctd_frame_decode_bf16",
         "K4": "pctd_full_decode"}


def _cuda_timing():
    """``utils/cuda_timing.py`` of this script's own tree (the checkout on
    the path may predate it)."""
    path = Path(__file__).resolve().parents[1] / "utils" / "cuda_timing.py"
    spec = importlib.util.spec_from_file_location("cuda_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def l2_bytes(fw, dims, B: int, R: int, full: bool) -> float:
    """Weight bytes the per-row blocks read from L2 for one launch."""
    es = lambda t: t.numel() * t.element_size()
    frame = (es(fw.w_frame) + 16 * es(fw.w_hh) + 15 * es(fw.w_slot)
             + 75 * es(fw.w_dcomb) + 16 * (es(fw.we_ih) + es(fw.we_hh)))
    if full:
        frame = dims.T * (frame + es(fw.wt_hh) + es(fw.wt_tok))
    return math.ceil(B / R) * frame


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_by_rows: no CUDA device", file=sys.stderr)
        return 2
    queued_ms = _cuda_timing().queued_ms
    from pctd_tpu_torch.config import ModelConfig
    from pctd_tpu_torch.models import disentangle_vae as dv
    from pctd_tpu_torch.models import pianotree_decoder as ptd
    from pctd_tpu_torch.ops.kernels import ar_decoder, build
    from pctd_tpu_torch.utils.precision import cast_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.build()
    dev = torch.device("cuda")
    cfg = ModelConfig()
    cfg_b = dataclasses.replace(cfg, compute_dtype="bfloat16")
    spec = cfg.pianotree
    params = dv.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fws = {"K3": ar_decoder.folded_frame_weights(params["dec"], cfg)}
    fws["K4"] = fws["K3"]
    fws["K3 bf16"] = ar_decoder.folded_frame_weights(
        cast_params(params["dec"], torch.bfloat16), cfg_b)
    dims = build.decoder_dims(fws["K3"], spec)
    S = spec.max_simu_note - 1
    out = {}
    for B in (128, 512):
        z = torch.randn(B, cfg.z_dim, device=dev, generator=gen)
        inputs = ptd.decode_inputs(params["dec"], cfg, z)
        h = torch.randn(B, cfg.dec_time_hidden, device=dev,
                        generator=gen) * 0.6
        for key in ("K3", "K3 bf16", "K4"):
            fw = fws[key]
            if key == "K4":
                grid = torch.empty((B, spec.num_step, S, 1 + spec.dur_width),
                                   dtype=torch.int32, device=dev)
                tensors = [*inputs, grid]
            else:
                dt = fw.w_hh.dtype
                tensors = [h.to(dt), inputs.sos_emb.to(dt),
                           torch.empty((B, S), dtype=torch.int32, device=dev),
                           torch.empty((B, S, spec.dur_width),
                                       dtype=torch.int32, device=dev),
                           torch.empty((B, 2 * dims.EH), dtype=dt,
                                       device=dev),
                           torch.empty((B,), dtype=torch.int32, device=dev)]
            case = f"{key} B={B}"
            out[case] = {}
            for r in (1, 2, 4):
                ms, queued = queued_ms(
                    lambda r=r: build.launch(ENTRY[key], fw, dims, B,
                                             tensors, rows=r), REPS[key])
                gb = l2_bytes(fw, dims, B, r, key == "K4") / 1e9
                out[case][f"R={r}"] = [ms, queued, gb]
            print(case, ", ".join(
                f"{k} {ms:.4f} ms (queued: {q}; L2 {gb:.2f} GB, "
                f"{gb / ms:.2f} TB/s)" for k, (ms, q, gb) in
                out[case].items()), flush=True)
        k3, k4 = out[f"K3 B={B}"], out[f"K4 B={B}"]
        print(f"K4 B={B}: time GRU and frame loop a frame, K4 / "
              f"{spec.num_step} - K3: " + ", ".join(
                  f"{k} {k4[k][0] / spec.num_step - k3[k][0]:.4f} ms"
                  for k in k3), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
