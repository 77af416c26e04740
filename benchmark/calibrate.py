"""Read the numbers that set a cell's limits, in one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --controls 3 [--seconds 3]

For each seed: the program's run at the cell's own size and load (its
set-up, a window of ``--seconds``, then the comparison with the plain
reference), printed as one JSON line ``{"seed", "program": {number:
value}}``. For the first ``--controls`` seeds also the lower-precision
control (the reference in TF32 in the program's place) and, for a
training cell, the planted faults (``half_batch``, ``token``,
``unchanged``), under ``"control"``. With ``--look`` (training cells)
also each step's loss gap, the leaves that read worst, and the smallest
margin between the best and the second logit of any argmax decision the
reference's decode fed back in each step, under ``"look"``. The lower
reading of a number is the largest the program gives over the seeds; its
upper reading the smallest the control (and each fault that reads ten
times the lower or more) gives.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def look(drv) -> dict:
    """Where a training cell's numbers come from: each step's loss gap,
    the worst leaves of the first gradient and of the change, and the
    reference's nearest argmax tie in each step."""
    import numpy as np
    from benchmark.reference import train as ref_train
    out = ref_train.train_steps(drv.p0, drv.w, drv.settings, drv.batches,
                                drv.noise_seed, drv.device, watch=True)
    norm = lambda d: {k: float(v.double().norm()) for k, v in d.items()}

    def worst(prog, ref):
        med = float(np.median(list(ref.values())))
        gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref}
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    delta = lambda p: norm({k: p[k] - drv.p0[k] for k in p})
    return {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in
                               zip(drv.losses, out.losses)],
            "grad_worst": worst(norm(drv.g1), norm(out.first_grads)),
            "change_worst": worst(delta(drv.p_after), delta(out.params)),
            "nearest_tie": out.margins}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    mod = harness.load_module("traffic", cell.mix["driver"])
    dev = torch.device(args.device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = mod.Driver(cell, seed, dev)
        drv.setup()
        run = harness.RunRecord(cell, args.seconds)
        run.window_t0 = time.perf_counter()
        drv.run_window(run)
        drv.release()
        harness.free_device_memory()
        t1 = time.perf_counter()
        line = {"seed": seed, "program": {
            k: v for k, (v, _) in drv.check().items()},
            "failed": sum(not r.ok for r in run.requests),
            "sent": len(run.requests) or sum(e.steps for e in run.epochs)}
        t2 = time.perf_counter()
        if args.look and cell.mix["driver"] == "train":
            line["look"] = look(drv)
        if i < args.controls:
            c = drv.control(emulate=dev.type != "cuda")
            line["control"] = c
        line["seconds"] = {"run": t1 - t0, "check": t2 - t1,
                           "control": time.perf_counter() - t2}
        print(json.dumps(line), flush=True)
        del drv
        harness.free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
