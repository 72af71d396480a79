"""A copy of the benchmark at sizes the CPU runs in seconds, for the tests.

The copy holds every file of ``benchmark/`` unchanged, two more
configurations (Ligero and Brakedown over ft255 at 2^14 and 2^13) and a
BENCHMARK.json whose cells are the real ones, and the held-back
``ligero-2e28-cpv`` (``fixtures/held_back_cpv.json``), on those
configurations.  Runs
go through ``lcbench.harness.run_cell`` on the CPU, which skips run.py's
look for a card and drives the rest of a run: the program's plain PyTorch
paths, the window, the metrics and the reference's check.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
if str(REPO) not in sys.path:
    sys.path.insert(1, str(REPO))

TINY = {"ligero_rho4_ft255_2e28": ("ligero_tiny", 14), "brakedown_sdig3_ft255_2e25": ("brakedown_tiny", 13)}


def tiny_tree(tmp: Path) -> dict:
    """Copy the benchmark under tmp and add the tiny cells; returns the
    BENCHMARK.json written there."""
    from reference import brakedown, field, ligero
    shutil.copytree(BENCH, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    held = json.loads((BENCH / "tests" / "fixtures" / "held_back_cpv.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        spec[key] += held[key]
    F = field.FIELDS["ft255"]
    for cfg in list(spec["configs"]):
        name, log2 = TINY[cfg["name"]]
        body = json.loads((REPO / cfg["file"]).read_text())
        body["log2_coeffs"] = log2
        code = (ligero.dims(1 << log2, F, tuple(body["rho"])) if body["system"] == "ligero"
                else brakedown.dims(1 << log2, F, brakedown.CODES[body["code"]]))
        body["dims"] = list(code)
        path = f"benchmark/configs/{name}.json"
        (tmp / path).write_text(json.dumps(body))
        spec["configs"].append(dict(cfg, name=name, file=path))
    for wl in list(spec["workloads"]):
        spec["workloads"].append(dict(wl, name=wl["name"] + "-tiny",
                                      config=TINY[wl["config"]][0]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [w + "-tiny" for w in m["workloads"]]
    write_spec(tmp, spec)
    return spec


def write_spec(tmp: Path, spec: dict) -> None:
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


def run(tmp: Path, workload: str, seed: int = 2**31 + 11, seconds: float = 0.2,
        trace: bool = False, fault: str | None = None) -> dict:
    import torch
    from lcbench.harness import run_cell
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    t0 = time.perf_counter()
    return run_cell(spec, tmp / "benchmark", workload, seed, seconds, trace,
                    torch.device("cpu"), lambda: time.perf_counter() - t0, fault=fault)
