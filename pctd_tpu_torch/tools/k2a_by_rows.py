"""Time the per-row K2a by rows a block, on one CUDA card.

The per-row K2a (one block ran the whole reverse chain of R batch rows, one
transposed matrix-vector product at a time) was replaced by the phase
kernels of ``csrc/train_frame.cu``; its launcher took ``rows=R``. This
script times that kernel at R = 1, 2 and 4 rows a block, at B = 128 and
512, in float32 and bfloat16, loss mode, each launch queued behind a sleep
kernel, on canonical-width random weights (seed 0). It runs against a
checkout that still has the per-row kernel: from the root of such a
checkout,

    PYTHONPATH=. python3 <path>/pctd_tpu_torch/tools/k2a_by_rows.py

with that checkout's ``chip_smoke.py`` helpers (``frame_case``,
``to_bf16``, ``queued_ms``) and its ``build.launch_train_bwd``. Prints the
card's name and power limit, a line a case and one JSON object of
{case: {"R=r": [ms, queued]}}; exits nonzero without a card.
"""
import json
import subprocess
import sys

import torch

REPS = 10   # launches a timing averages


def main() -> int:
    if not torch.cuda.is_available():
        print("k2a_by_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pctd_tpu_torch.config import ModelConfig
    from pctd_tpu_torch.models import disentangle_vae as dv
    from pctd_tpu_torch.ops.kernels import build
    from pctd_tpu_torch.ops.kernels import train_frame as tf

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.build()
    dev = torch.device("cuda")
    cfg = ModelConfig()
    spec = cfg.pianotree
    params = dv.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for B in (128, 512):
        for bf16 in (False, True):
            cw, inp = cs.frame_case(params, cfg, B, gen)
            if bf16:
                cw, inp = cs.to_bf16(cw, inp)
            dt = cw.w_hh.dtype
            with torch.no_grad():
                lens, st = tf.frame_fwd(cw, spec, **inp, stash=True)[2::2]
            d = tf.dims_of(cw, spec)
            d_nums = torch.rand(1 + d.W, device=dev, generator=gen)
            d_summ = torch.randn(B, 2 * d.EH, device=dev,
                                 generator=gen).to(dt)
            ct = tf.new_cotangents(d, B, dev)
            tensors = [inp["coins"], inp["gt_pitch"], inp["gt_dur"], lens,
                       d_nums, d_summ,
                       torch.empty(B, d.TH, device=dev, dtype=dt),
                       torch.empty(B, d.K, d.E, device=dev, dtype=dt)]
            key = f"{'bf16' if bf16 else 'f32'} B={B}"
            out[key] = {f"R={r}": cs.queued_ms(
                lambda r=r: build.launch_train_bwd(cw, d, B, tensors, st, ct,
                                                   rows=r), REPS)
                for r in (1, 2, 4)}
            print(key, ", ".join(f"{k} {ms:.4f} ms (queued: {q})"
                                 for k, (ms, q) in out[key].items()),
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
