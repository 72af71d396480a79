"""Observability: phase spans, each kernel's speed of light, timing, traces.

Counterpart of ``lcpc_proof_of_storage_tpu/utils/profiling.py`` (the
reference client's ``benchmark{bottleneck=disk|cpu|network}`` spans,
networking/client.rs:61-81, and its criterion/pprof flamegraphs):

- ``phase(...)`` spans accumulate wall time per (actor, bottleneck).  The
  server wraps each handler in one, the client its disk, cpu and network
  legs, ``core/commit.py`` prove and verify their protocol legs, and the CLI
  prints the report with ``-vv``;
- ``trace(name)`` records a ``torch.profiler`` Chrome trace when
  ``LCPC_TRACE_DIR`` is set;
- every hand-written kernel has a cost function of its shapes and field
  (the bytes it must move, its 32-bit integer operations), so a measured
  time reads as a fraction of the card's bound whatever implements it;
- ``bench_kernel``, ``wall_ms`` and ``device_ms`` time a call on the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


# -- phase spans ------------------------------------------------------------

class PhaseRecorder:
    """Accumulates wall time per (actor, bottleneck) phase."""

    def __init__(self):
        self.totals: dict[tuple[str, str], float] = defaultdict(float)
        self.counts: dict[tuple[str, str], int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, bottleneck: str, actor: str = "client"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[(actor, bottleneck)] += dt
            self.counts[(actor, bottleneck)] += 1

    def report(self) -> dict:
        return {
            f"{actor}/{bottleneck}": {
                "seconds": round(t, 4),
                "count": self.counts[(actor, bottleneck)],
            }
            for (actor, bottleneck), t in sorted(self.totals.items())
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


GLOBAL_PHASES = PhaseRecorder()
phase = GLOBAL_PHASES.phase


# -- torch.profiler traces --------------------------------------------------

@contextlib.contextmanager
def trace(name: str = "trace"):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written as a Chrome trace into ``$LCPC_TRACE_DIR/<name>/`` when
    that variable is set; a no-op otherwise."""
    trace_dir = os.environ.get("LCPC_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    out = os.path.join(trace_dir, name)
    os.makedirs(out, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


# -- speed-of-light models --------------------------------------------------

@dataclass(frozen=True)
class ChipModel:
    """A card's peak rates: bytes a second of device memory, and 32-bit
    integer operations a second (a multiply-add counted as two)."""
    name: str
    hbm_gbps: float
    int32_iops: float


#: NVIDIA's data sheet for the H100 SXM part at its 700 W limit, not a
#: measurement: 3.35 TB/s of HBM3, and 67 T float32 operations/s from 128
#: FP32 lanes an SM, of which the Hopper architecture whitepaper gives half
#: (64 INT32 lanes an SM) to 32-bit integers: 33.5 T operations/s.  A card
#: set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs slower.
H100 = ChipModel("NVIDIA H100 SXM 80GB, 700 W data sheet", 3350.0, 33.5e12)

#: 32-bit adds, xors and rotates of one BLAKE3 compression
BLAKE3_OPS = 800


@dataclass
class KernelCost:
    """What one kernel call must do: its 32-bit integer operations, and the
    bytes it must move (each input read once, each output written once).
    Operations are counted in 32-bit words: a product of two W-word field
    elements is W^2 multiply-adds (2 W^2 operations), whatever digit width
    the kernel itself multiplies in."""
    name: str
    int_ops: float
    bytes_moved: float

    def bound_ms(self, chip: ChipModel = H100) -> tuple[float, str]:
        """(the least milliseconds the card could take, "bytes" or
        "operations": which of the two bounds it)."""
        t_bytes = self.bytes_moved / (chip.hbm_gbps * 1e9) * 1e3
        t_ops = self.int_ops / chip.int32_iops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def speed_of_light_s(self, chip: ChipModel = H100) -> float:
        return self.bound_ms(chip)[0] / 1e3

    def report(self, measured_s: float, chip: ChipModel = H100) -> dict:
        ms, by = self.bound_ms(chip)
        sol = ms / 1e3
        return {
            "kernel": self.name,
            "measured_ms": round(measured_s * 1e3, 3),
            "speed_of_light_ms": round(ms, 3),
            "fraction_of_sol": round(sol / measured_s, 3) if measured_s else None,
            "bound": "compute" if by == "operations" else "memory",
        }


def dit_ops(count: int, s0: int, s1: int, W: int) -> int:
    """Operations of the radix-2 DIT stages s0 .. s1-1 on `count` values in
    runs of at least 2^s1: a butterfly is a modular add and subtract (~8 W
    operations) and, unless its twiddle is 1, one Montgomery product of
    W-word values (2 W^2 multiply-adds, ~4 W^2 operations).  At stage s one
    butterfly in 2^s has the twiddle 1: all of stage 0, half of stage 1."""
    half = count // 2
    return sum(half * 8 * W + (half - (count >> (s + 1))) * 4 * W * W for s in range(s0, s1))


def ntt_cost(batch: int, n: int, L: int, stages: int, scale: bool = False) -> KernelCost:
    """K1 (the forward NTT's passes), K4 (the inverse, with `scale`) and
    K1's large-stage entry: a (batch, n, L) limb array read once and written
    once; the last `stages` DIT stages of a 2^log_n transform (the stages
    pruned by a zero tail are the first ones); the inverse's scale one more
    product a value."""
    W, log_n = L // 2, n.bit_length() - 1
    ops = dit_ops(batch * n, log_n - stages, log_n, W) + (batch * n * 4 * W * W if scale else 0)
    return KernelCost(f"ntt_b{batch}_n{n}_L{L}", ops, 2 * batch * n * L * 4)


def tile_cost(count: int, L: int, s0: int, s1: int, in_limbs: bool, out_limbs: bool,
              n_diag: int = 0, diag_ones: int = 0) -> KernelCost:
    """KT (the four-step's passes and the fused tile): its `count` values
    read once and written once (16-bit limbs as int32, or W words each), the
    diagonal twiddles of one row (n_diag values, of which diag_ones are 1)
    read once; the stages s0 .. s1-1 (dit_ops), the prologue one Montgomery
    product a value whose twiddle is not 1."""
    W = L // 2
    nbytes = count * 4 * ((L if in_limbs else W) + (L if out_limbs else W)) + n_diag * W * 4
    ops = dit_ops(count, s0, s1, W)
    if n_diag:
        ops += (count - count // n_diag * diag_ones) * 4 * W * W
    return KernelCost(f"tile_{count}_L{L}_s{s0}-{s1}", ops, nbytes)


def modmul_cost(elems: int, L: int, b_rows: int) -> KernelCost:
    """KM, a * b mod p over `elems` values of L limbs, b of `b_rows` rows
    (elems, or 1 broadcast): a, b and the output once; a Montgomery product
    a value by one broadcast row in Montgomery form (and one to form it),
    two a value otherwise."""
    W = L // 2
    ops = (elems + 1) * 4 * W * W if b_rows == 1 else elems * 8 * W * W
    return KernelCost(f"modmul_{elems}_L{L}_b{b_rows}", ops, (2 * elems + b_rows) * L * 4)


def hash_columns_cost(n_rows: int, n_cols: int, repr_bytes: int) -> KernelCost:
    """K2's leaves: the (n_rows, n_cols) limbs read once, the digests written
    once; a compression a 64-byte block of each column message (32 zero
    bytes and the column's reprs) and a parent a chunk but one."""
    L = (repr_bytes + 1) // 2
    msg = 32 + n_rows * repr_bytes
    return KernelCost(f"hash_{n_rows}x{n_cols}",
                      n_cols * (-(-msg // 64) + -(-msg // 1024) - 1) * BLAKE3_OPS,
                      n_rows * n_cols * L * 4 + n_cols * 32)


def merkle_tree_cost(np2: int) -> KernelCost:
    """K2's tree: the np2 leaves read once, the np2 - 1 parents written
    once, a compression each."""
    return KernelCost(f"merkle_tree_{np2}", (np2 - 1) * BLAKE3_OPS, (2 * np2 - 1) * 32)


def chunk_cvs_cost(n_rows: int, n_cols: int, repr_bytes: int) -> KernelCost:
    """K2's chunk CVs of one row batch past the first: the (n_rows, n_cols)
    limbs read once, each column's chunk CVs written once; a compression a
    64-byte block of each column's slice of the stream."""
    L = (repr_bytes + 1) // 2
    msg = n_rows * repr_bytes
    return KernelCost(f"chunk_cvs_{n_rows}x{n_cols}", n_cols * -(-msg // 64) * BLAKE3_OPS,
                      n_rows * n_cols * L * 4 + n_cols * -(-msg // 1024) * 32)


def merge_cvs_cost(n_cols: int, chunks: int) -> KernelCost:
    """K2's merge: every column's `chunks` CVs read once, its digest written
    once; a parent compression a chunk but one."""
    return KernelCost(f"merge_cvs_{n_cols}x{chunks}", n_cols * (chunks - 1) * BLAKE3_OPS,
                      n_cols * chunks * 32 + n_cols * 32)


def collapse_cost(n_rows: int, n_per_row: int, L: int, T: int, bits: int = 32,
                  acc: bool = False) -> KernelCost:
    """K3 (int32 coefficients) and K3p (16-bit ones, `bits` = 16, with an
    accumulator where `acc`): the coefficients read once, the T tensors of
    n_rows values once, the T outputs of n_per_row values written once (and
    the accumulator read once); T n_rows n_per_row products of W-word
    values, 2 W^2 operations each."""
    W = L // 2
    nbytes = (n_rows * n_per_row * L * bits // 8
              + (T * n_rows + T * n_per_row * (2 if acc else 1)) * L * 4)
    return KernelCost(f"collapse_{n_rows}x{n_per_row}_T{T}", 2 * T * n_rows * n_per_row * W * W,
                      nbytes)


def expander_cost(batch: int, levels: list[tuple[int, int, int]], L: int) -> KernelCost:
    """K5's calls of one encode of `batch` rows, `levels` the (rows, cols,
    used slots) of each level's gather table: each level's input and output
    read or written once, its used slots (a column index and W words) once,
    its counts and row order once; 2 W^2 operations a slot product."""
    W = L // 2
    nbytes = ops = 0
    for rows, cols, used in levels:
        nbytes += (batch * cols + batch * rows) * L * 4 + used * (4 + 4 * W) + rows * 8
        ops += batch * used * W * W * 2
    return KernelCost(f"expander_b{batch}_{len(levels)}levels", ops, nbytes)


# -- timing on the card -----------------------------------------------------

def bench_kernel(fn, runs: int = 20) -> float:
    """Mean device milliseconds of fn() over `runs` back-to-back runs between
    two CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def wall_ms(fn, runs: int = 3, warmup: int = 1) -> float:
    """Median host-clock milliseconds of fn() over `runs` synchronised runs
    after `warmup` runs (for steps with host and device work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_events(fn, runs: int = 20) -> list:
    """torch.profiler's averages of the CUDA kernels of `runs` calls of
    fn(), after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, runs: int = 20) -> tuple[float, float]:
    """(device milliseconds, kernels) a call of fn(): the kernel events
    torch.profiler records over `runs` calls after one warm-up."""
    kern = kernel_events(fn, runs)
    return (sum(e.self_device_time_total for e in kern) / 1e3 / runs,
            sum(e.count for e in kern) / runs)
