#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one CUDA card.

Run from the root of a checkout on a machine with a card:

    python3 chip_profile.py

It commits 2^20 ft255 coefficients (Ligero rho=1/4, as chip_smoke.py's
main path), then times commit, prove and verify RUNS times each after two
warm-ups (synchronised wall clock; every run is printed, then the median,
min and max), and profiles one more call of each: device kernel time and
busy share from torch.profiler (``utils/profiling.py kernel_events``), the
host's hottest functions from cProfile (which inflates host time).  With
LCPC_TRACE_DIR set, one more call of each is traced into
``$LCPC_TRACE_DIR/chip_profile_<step>/`` as a Chrome trace
(``utils/profiling.py trace``).  The last line is a JSON summary.

The port imports nothing of the JAX package, so the process runs with
glibc malloc's defaults: the reference's allocator tuning (its package
``__init__``) never runs here.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

SEED = 20261016
RUNS = 10


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from chip_smoke import card_line, random_limbs
    from lcpc_proof_of_storage_tpu_torch import LigeroEncoding, Transcript, commit, prove, verify
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import kernel_events, trace

    card = card_line()
    print(f"card: {card}", flush=True)

    dev = torch.device("cuda", 0)
    spec = FT255
    p = spec.modulus
    length = 1 << 20
    enc = LigeroEncoding.new(length, spec, rho=(1, 4))
    n_rows, npr, _ = enc.get_dims(length)
    rng = np.random.default_rng(SEED)
    coeffs = torch.from_numpy(random_limbs(rng, (length,), spec)).to(dev)
    comm = commit(coeffs, enc, device=dev)
    root = comm.get_root().root
    x = 987654321
    xr = pow(x, npr, p)
    outer = [pow(xr, i, p) for i in range(n_rows)]
    inner = [pow(x, j, p) for j in range(npr)]

    def tr():
        t = Transcript(b"chip_profile")
        t.append_message(b"polycommit", root)
        return t

    proof = prove(comm, outer, enc, tr())
    steps = {"commit": lambda: commit(coeffs, enc, device=dev),
             "prove": lambda: prove(comm, outer, enc, tr()),
             "verify": lambda: verify(root, outer, inner, proof, enc, tr(), device=dev)}
    summary = {"card": card, "steps": {}}
    for name, fn in steps.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(walls)
        print(f"== {name} [{card}]: wall ms median {med:.3f}, min {min(walls):.3f}, "
              f"max {max(walls):.3f} over {RUNS} runs: "
              + " ".join(f"{w:.3f}" for w in walls), flush=True)

        kern = kernel_events(fn, runs=1)
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        n_kern = sum(e.count for e in kern)
        print(f"   device: {dev_ms:.3f} ms in {n_kern} kernels, busy {dev_ms / med:.1%} of "
              f"the median wall", flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"     {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:70]}",
                  flush=True)

        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        st = pstats.Stats(pr)
        top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
        print("   host (cProfile, own time):", flush=True)
        for (fname, line, func), (_, ncalls, tt, _, _) in top:
            print(f"     {tt * 1e3:8.3f} ms  x{ncalls:<6d} {Path(fname).name}:{line} {func}",
                  flush=True)
        with trace(f"chip_profile_{name}"):
            fn()

        summary["steps"][name] = {"wall_ms": walls, "median_ms": med, "device_ms": dev_ms,
                                  "kernels": n_kern, "busy": dev_ms / med}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
