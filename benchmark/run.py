"""Run one cell of the benchmark once on this machine's card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (end-to-end
metrics with ``--trace 0``, per-layer metrics with ``--trace 1``) and the
numbers compared with the plain reference, each beside its limit, as the
last lines of standard error. Exits with 2, printing no result, when the
machine has fewer CUDA cards than the cell asks for.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    spec = harness.load_json("workloads", args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < spec["chips"]):
        print(f"{args.workload} needs {spec['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
