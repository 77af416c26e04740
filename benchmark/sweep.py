"""Find the highest arrival rate a serving cell's program sustains, by a
sweep on the card, in one process:

    python3 benchmark/sweep.py --workload <cell> --rates 8,10,12 \
        [--seconds 20] [--seed 1]

For each rate (requests a second, evenly spaced) one window of the
cell's mix: printed as one JSON line with the requests answered, the
answered and offered rates, the median and 95th-percentile latency, and
the queue wait of the window's last request (a backlog that grows
through the window means the rate is above what the program sustains).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    drv = harness.load_module("traffic", cell.mix["driver"]).Driver(
        cell, args.seed, torch.device("cuda"))
    drv.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        drv.mix["rate_per_s"] = rate
        run = harness.RunRecord(cell, args.seconds)
        run.window_t0 = time.perf_counter()
        drv.run_window(run)
        lat = np.array([(r.t1 - r.arrival) * 1e3 for r in run.requests])
        last = run.requests[-1]
        print(json.dumps({
            "rate_per_s": rate, "answered": len(run.requests),
            "answered_per_s": len(run.requests) / run.window_s,
            "segments_per_s": sum(r.segments for r in run.requests)
            / run.window_s,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "last_wait_ms": (last.t0 - last.arrival) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
