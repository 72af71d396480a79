"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything a cell is made of is found by name: ``configs/<config>.json``
(the deployment), ``systems/<system>.py`` (how the program is called for
it), ``reference/<system>.py`` (the plain reference of its code),
``traffic/<traffic>.json`` (what the closed loop sends) and
``metrics/<metric>.py`` (one reader a metric, loaded by its path: metric
names hold dots).  The program under test is
``lcpc_proof_of_storage_tpu_torch``; nothing here imports the JAX package.

A traffic file is data: ``{"why": ..., "setup": [calls], "cycle": [calls]}``.
The set-up calls run once before the warm-up and stand for the whole run (a
commitment made there is what the cycles prove against); the cycle's calls
run in order, again and again, through the window.  A call ``<name>`` is the
program's method ``call_<name>``: ``commit``, ``prove`` and ``verify`` here,
more in a ``Program`` class that ``systems/<system>.py`` may define.  A
``reference/<system>.py`` that defines ``judge`` replaces ``checks.judge``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import random
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from reference import proof as proof_ref
from reference.field import FIELDS

from . import checks
from .trace import Tracer

TRANSCRIPT_LABEL = b"lcpc-benchmark"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def import_part(bench_dir: Path, package: str, name: str):
    """``<package>.<name>`` as found under this benchmark's folder (a
    system or its reference, by the configuration's ``system``)."""
    pkg = importlib.import_module(package)
    where = str(bench_dir / package)
    if where not in list(pkg.__path__):
        pkg.__path__.append(where)
    return importlib.import_module(f"{package}.{name}")


def _module_name(name: str) -> str:
    return "lcbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its files loaded."""
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def load(cls, spec: dict, bench_dir: Path, workload: str) -> "Cell":
        wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
        if wl is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
        root = bench_dir.parent
        config = json.loads((root / cfg_entry["file"]).read_text())
        traffic = json.loads((bench_dir / "traffic" / f"{wl['traffic']}.json").read_text())

        def mine(metrics):
            return [m for m in metrics if workload in m.get("workloads", [workload])]
        return cls(workload, config, traffic, mine(spec["end_to_end"]), mine(spec["per_layer"]))


@dataclass
class Op:
    name: str
    t0: float
    t1: float
    ok: bool
    cpu: float = 0.0        # the calling thread's CPU seconds


@dataclass
class Run:
    """What a run measured: the metrics' readers read this."""
    cell: Cell
    dims: tuple[int, int, int]
    limbs: int
    repr_bytes: int
    coeff_bits: int
    setup_s: float
    window: tuple[float, float] = (0.0, 0.0)
    ops: list[Op] = field(default_factory=list)
    phases: dict[str, tuple[float, int]] = field(default_factory=dict)
    trace: object = None
    ref: object = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def durations(self, op: str) -> list[float]:
        return [o.t1 - o.t0 for o in self.ops if o.name == op and o.ok]

    @property
    def coeffs_per_commit(self) -> int:
        return 1 << self.config["log2_coeffs"]


TRAFFIC_KEYS = {"why", "setup", "cycle"}


def check_traffic(traffic: dict, program_cls: type) -> None:
    """Refuses a traffic file with a key the loop does not read, a call the
    program does not have, or a call before the call it needs."""
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic has keys the loop does not read: {sorted(unknown)}")
    if not traffic.get("cycle"):
        raise ValueError("traffic has no cycle")
    seen: set[str] = set()
    for call in list(traffic.get("setup", [])) + list(traffic["cycle"]):
        if not callable(getattr(program_cls, "call_" + call, None)):
            raise ValueError(f"traffic names a call the program does not have: {call!r}")
        need = program_cls.NEEDS.get(call)
        if need and need not in seen:
            raise ValueError(f"traffic calls {call!r} before any {need!r}")
        seen.add(call)


class Program:
    """The program under test set up for one configuration: its encoding on
    the device, the benchmark's own coefficients made there from the seed,
    and the calls the traffic makes (``call_<name>``).  The last commitment
    stands until the next commit: a prove proves against its root, a verify
    checks the last proof."""

    transcript_label = TRANSCRIPT_LABEL
    NEEDS = {"prove": "commit", "verify": "prove"}

    def __init__(self, config: dict, device: torch.device, seed: int, system):
        from lcpc_proof_of_storage_tpu_torch import serialize_proof
        from lcpc_proof_of_storage_tpu_torch.fields import FIELDS as PORT_FIELDS
        self.config = config
        self.device = device
        self.system = system
        self.spec = PORT_FIELDS[config["field"]]
        self.field = FIELDS[config["field"]]
        t0 = time.perf_counter()
        self.enc = self.system.encoding(config, self.spec, device)
        self.dims = self.enc.get_dims(1 << config["log2_coeffs"])
        sync(device)
        t1 = time.perf_counter()
        self.coeffs = make_coeffs(seed, 1 << config["log2_coeffs"], self.spec.modulus,
                                  self.spec.num_limbs16, self.system.COEFF_DTYPE, device)
        sync(device)
        self.setup_parts = {"encoding": t1 - t0, "coefficients": time.perf_counter() - t1}
        self.comm = None
        self.root = None
        self._kept = None
        self._serialize = serialize_proof

    def shapes(self) -> tuple:
        return (*self.dims, self.enc.get_n_col_opens(), self.enc.get_n_degree_tests())

    def commit(self) -> bytes:
        self.comm = self.root = None         # the previous commitment goes first
        self.comm = self.system.commit(self.coeffs, self.enc, self.device, self.config)
        self.root = self.comm.get_root().root
        return self.root

    def call_commit(self, loop: "Loop", rec: dict) -> None:
        rec["root"] = loop.timed("commit", self.commit)

    def call_prove(self, loop: "Loop", rec: dict) -> None:
        n_rows, npr, _ = self.dims
        st = loop.state
        st["x"] = rec["x"] = x = loop.points.randrange(1, self.spec.modulus)
        st["outer"], st["inner"] = proof_ref.point_tensors(x, n_rows, npr, self.field)
        st["proof"] = rec["proof"] = loop.timed("prove", self.prove, self.root, st["outer"])

    def call_verify(self, loop: "Loop", rec: dict) -> None:
        st = loop.state
        rec["x"] = st["x"]
        rec["value"] = loop.timed("verify", self.verify, self.root, st["outer"], st["inner"],
                                  st["proof"])

    def prove(self, root: bytes, outer: list[int]):
        from lcpc_proof_of_storage_tpu_torch import prove
        return prove(self.comm, outer, self.enc, self.transcript(root))

    def verify(self, root: bytes, outer: list[int], inner: list[int], proof) -> int:
        from lcpc_proof_of_storage_tpu_torch import verify
        return verify(root, outer, inner, proof, self.enc, self.transcript(root),
                      device=self.device)

    @staticmethod
    def transcript(root: bytes):
        from lcpc_proof_of_storage_tpu_torch import Transcript
        tr = Transcript(TRANSCRIPT_LABEL)
        tr.append_message(b"polycommit", root)
        return tr

    def proof_bytes(self, proof) -> bytes:
        return self._serialize(proof, self.spec)

    def kept_matrix(self) -> torch.Tensor:
        """The last commitment's encoded matrix, (n_rows, n_cols, L) limbs on
        the device."""
        return self._kept if self.comm is None else self.comm.comm

    def coeff_matrix(self) -> torch.Tensor:
        """The benchmark's coefficients as the (n_rows, n_per_row, L) matrix,
        zero-padded."""
        n_rows, npr, _ = self.dims
        c = self.coeffs
        pad = n_rows * npr - c.shape[0]
        if pad:
            c = torch.cat([c, c.new_zeros((pad, c.shape[1]))])
        return c.reshape(n_rows, npr, -1)

    def release(self) -> None:
        """Free what the reference does not read: everything of the last
        commitment but its encoded matrix."""
        if self.comm is not None:
            self._kept = self.comm.comm
            self.comm = None


def make_coeffs(seed: int, n: int, modulus: int, L: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """n field elements drawn on the device from the seed, as (n, L) 16-bit
    limbs (int16 bit patterns or int32 values), each below p: every limb
    uniform, the top one below p's top limb."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, L), dtype=dtype, device=device)
    if dtype == torch.int16:
        out.random_(-(1 << 15), 1 << 15, generator=gen)
    else:
        out.random_(0, 1 << 16, generator=gen)
    out[:, L - 1].random_(0, modulus >> (16 * (L - 1)), generator=gen)
    return out


@contextlib.contextmanager
def _annotate(name: str, on: bool):
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def mirrored_phases(on: bool):
    """While tracing, the program's phase spans are also profiler
    annotations (``phase.<actor>.<leg>``)."""
    if not on:
        yield
        return
    import lcpc_proof_of_storage_tpu_torch.core.commit as core
    orig = core._phase

    @contextlib.contextmanager
    def both(bottleneck, actor="client"):
        with orig(bottleneck, actor), torch.profiler.record_function(
                f"phase.{actor}.{bottleneck}"):
            yield
    core._phase = both
    try:
        yield
    finally:
        core._phase = orig


def _phase_snapshot() -> dict[str, tuple[float, int]]:
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import GLOBAL_PHASES
    return {f"{a}/{b}": (t, GLOBAL_PHASES.counts[(a, b)])
            for (a, b), t in GLOBAL_PHASES.totals.items()}


class Loop:
    """The closed loop of one client: the traffic's set-up calls once, then
    cycles of its calls in order, the next cycle starting when the last call
    returned.

    Each cycle of a window keeps its root, point and evaluation; of the
    proofs only one is kept for the check, that of a cycle drawn from the
    seed before the window (the last one, where the window ends first), so
    the heap does not grow with the window."""

    KEEP_WITHIN = 8

    def __init__(self, program: Program, traffic: dict, seed: int):
        check_traffic(traffic, type(program))
        self.program = program
        self.setup_calls = list(traffic.get("setup", []))
        self.calls = list(traffic["cycle"])
        self.seed = seed
        self.points = random.Random(seed * 2 + 1)      # evaluation points from the seed
        self.keep = random.Random(seed * 5 + 3).randrange(self.KEEP_WITHIN)
        self.traced = False
        self.state: dict = {}                           # what a call leaves for the next
        self.ops: list[Op] = []
        self.standing: dict = {}                        # what the set-up calls made
        self.cycles: list[dict] = []                    # the windows' cycles
        self._last_proof = None

    def _calls(self, calls: list[str], rec: dict) -> None:
        for call in calls:
            getattr(self.program, "call_" + call)(self, rec)
            if not self.ops[-1].ok:
                break

    def setup(self) -> None:
        """The set-up calls, then one warm-up cycle: every kernel built and
        every shape of the window warmed.  Neither is measured."""
        self._calls(self.setup_calls, self.standing)
        if any(not o.ok for o in self.ops):
            raise RuntimeError("a set-up call of the traffic failed")
        self.standing.pop("proof", None)
        self.warm()

    def warm(self) -> None:
        """One cycle at points of its own, not measured."""
        points, self.points = self.points, random.Random(self.seed ^ 0x5EED)
        self._calls(self.calls, {})
        self.points = points
        if any(not o.ok for o in self.ops):
            print("a warm-up cycle failed; the window runs all the same", file=sys.stderr)
        self.ops = []

    def cycle(self) -> None:
        rec: dict = {}
        self._calls(self.calls, rec)
        proof = rec.pop("proof", None)
        if proof is not None:
            if len(self.cycles) == self.keep:
                rec["proof"] = proof
            self._last_proof = (rec, proof)
        self.cycles.append(rec)

    def timed(self, name: str, fn, *args):
        t0, c0 = time.perf_counter(), time.thread_time()
        ok = True
        try:
            with _annotate(f"bench.{name}", self.traced):
                out = fn(*args)
        except Exception as exc:            # a failed call counts, the loop goes on
            print(f"{name} failed: {type(exc).__name__}: {exc}", file=sys.stderr)
            out, ok = None, False
        self.ops.append(Op(name, t0, time.perf_counter(), ok, time.thread_time() - c0))
        return out

    def run(self, seconds: float, traced: bool) -> tuple[tuple[float, float], list[Op]]:
        """One window: cycles until `seconds` have passed; returns its span
        and its calls."""
        self.traced, first = traced, len(self.ops)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            self.cycle()
            if time.perf_counter() >= deadline:
                t1 = time.perf_counter()
                break
        self.traced = False
        if self._last_proof and not any("proof" in c for c in self.cycles):
            rec, proof = self._last_proof
            rec["proof"] = proof
        self._last_proof = None
        return (t0, t1), self.ops[first:]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


UNTRACED_SOURCES = ("host_clock", "program_span")


def run_cell(spec: dict, bench_dir: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, setup_clock, fault: str | None = None) -> dict:
    """One run; returns the result object (without printing it) and the
    numbers compared, under "checks".

    A --trace 0 run measures one window, untraced, and reports the cell's
    end-to-end metrics.  A --trace 1 run reports its per-layer metrics: those
    read from the host's clock or the program's spans from an untraced window
    (the profiler's cost a launch would be in them), then those read from the
    device trace from a traced window of the same length."""
    cell = Cell.load(spec, bench_dir, workload)
    t_start = setup_clock()
    system = import_part(bench_dir, "systems", cell.config["system"])
    program = getattr(system, "Program", Program)(cell.config, device, seed, system)
    ref_mod = import_part(bench_dir, "reference", cell.config["system"])
    ref = ref_mod.Code(cell.config, FIELDS[cell.config["field"]])
    shapes = {"program": program.shapes(),
              "reference": (*ref.dims, ref.n_col_opens, ref.n_degree_tests),
              "configuration": (*cell.config["dims"], cell.config["n_col_opens"],
                                cell.config["n_degree_tests"])}
    if len(set(shapes.values())) != 1:
        raise RuntimeError(f"dims, column openings and degree tests differ: {shapes}")
    if fault:
        from . import faults
        faults.apply(fault, program)

    loop = Loop(program, cell.traffic, seed)
    loop.setup()                              # builds the kernels, warms every shape
    sync(device)
    # what set-up made stays: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    # a second warm-up cycle after the collection, so that the window's
    # first cycle finds the heap as a cycle leaves it (without it, the first
    # prove of a window read 6-20% above its run's median on an H100)
    loop.warm()
    sync(device)
    setup_s = setup_clock()
    parts = dict(program.setup_parts, before=t_start)
    parts["traffic set-up and warm-up"] = setup_s - t_start - sum(program.setup_parts.values())
    print("set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in parts.items()), file=sys.stderr)

    def window(traced: bool) -> Run:
        run = Run(cell, program.dims, program.spec.num_limbs16, program.spec.repr_bytes,
                  16 if program.system.COEFF_DTYPE == torch.int16 else 32, setup_s, ref=ref)
        before = _phase_snapshot()
        tracer = Tracer()
        with (tracer.window(lambda: sync(device)) if traced else contextlib.nullcontext()), \
                mirrored_phases(traced):
            run.window, run.ops = loop.run(seconds, traced)
        sync(device)
        after = _phase_snapshot()
        run.phases = {k: (t - before.get(k, (0.0, 0))[0], n - before.get(k, (0.0, 0))[1])
                      for k, (t, n) in after.items() if n > before.get(k, (0.0, 0))[1]}
        run.trace = tracer.trace
        report_window(run, loop.calls, "traced" if traced else "untraced")
        return run

    metrics_of = cell.per_layer if trace else cell.end_to_end
    runs: dict[str, Run] = {}
    if not trace or any(m["source"] in UNTRACED_SOURCES for m in metrics_of):
        runs["untraced"] = window(False)
    if trace:
        runs["traced"] = window(True)
    gc.unfreeze()
    # the process's peak so far: set-up and windows, before the reference runs
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    metrics = {}
    for m in metrics_of:
        run = runs.get("untraced" if m["source"] in UNTRACED_SOURCES else "traced")
        reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                             _module_name(m["name"]))
        value = reader.read(run) if run is not None else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ops = [o for r in runs.values() for o in r.ops]
    attempted = len(ops)
    failed = sum(not o.ok for o in ops)
    program.release()
    judge = getattr(ref_mod, "judge", checks.judge)
    numbers = judge(program, ref, [loop.standing] + loop.cycles, seed)
    correct = failed == 0 and all(v <= lim for _, v, lim in numbers)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": device_info(device, peak)}
    if trace:
        tr = runs["traced"].trace
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return result


def report_window(run: Run, calls: list[str], what: str) -> None:
    """Each call's latencies in the window, on standard error: quartiles,
    and the share of their wall time the calling thread spent on a CPU."""
    for name in dict.fromkeys(calls):
        ops = [o for o in run.ops if o.name == name and o.ok]
        if not ops:
            continue
        d = sorted(o.t1 - o.t0 for o in ops)
        q = statistics.quantiles(d, n=4) if len(d) > 1 else [d[0]] * 3
        cpu = sum(o.cpu for o in ops) / sum(d)
        line = (f"window ({what}): {name} x{len(d)}, ms min {d[0] * 1e3:.1f} q1 {q[0] * 1e3:.1f} "
                f"median {q[1] * 1e3:.1f} q3 {q[2] * 1e3:.1f} max {d[-1] * 1e3:.1f}, "
                f"on a CPU {cpu * 100:.0f}%")
        if len(ops) <= 64:
            line += ", in order " + " ".join(f"{(o.t1 - o.t0) * 1e3:.0f}" for o in ops)
        print(line, file=sys.stderr)


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}
