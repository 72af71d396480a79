"""Read the control (or a fault) of a cell on the card, at the cell's size.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 5 \
        [--fault lazy_reduction] [--fault none]

runs the cell once a seed and a fault, in this one process, with the timed
path broken underneath as ``lcbench/faults.py`` says ("none": the program as
it is), and prints each run's numbers compared, one JSON line a run.  The
benchmark's own runs never run it: it is how the limits in PERF.md were
read.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", action="append", default=None)
    args = ap.parse_args(argv)
    root = os.getcwd()
    sys.path[:0] = [str(HERE), root]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from lcbench.harness import run_cell
    spec = json.loads(Path(root, "BENCHMARK.json").read_text())
    device = torch.device("cuda", 0)
    for fault in args.fault or ["lazy_reduction"]:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res = run_cell(spec, HERE, args.workload, seed, args.seconds, False, device,
                           lambda: time.perf_counter() - t0,
                           fault=None if fault == "none" else fault)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "correct": res["correct"], "attempted": res["attempted"],
                              "failed": res["failed"], "checks": res["checks"],
                              "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
            del res
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
