"""The benchmark's yardstick for kernels: peak rates and cost functions.

A frozen copy of the cost model of the program's ``utils/profiling.py``
(each kernel's bytes, each input read once and each output written once,
and its 32-bit integer operations, as functions of shapes alone), kept here
so that a change to the program cannot move the yardstick it is measured
by.  ``tests/test_bench_costs.py`` pins each function to the program's at
the cells' shapes.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    """Peak rates: HBM bytes a second, 32-bit integer operations a second
    (a multiply-add counted as two)."""
    name: str
    hbm_bytes_s: float
    int32_ops_s: float


#: NVIDIA's H100 SXM data sheet at its 700 W limit: 3.35 TB/s of HBM3.  The
#: 32-bit integer rate is an assumed peak, not a data-sheet line: 64 INT32
#: lanes of an SM's 128 (the Hopper whitepaper) at the rate of the 67 T
#: float32 operations a second, so 33.5 T.  A card set below 700 W runs slower.
H100 = Chip("NVIDIA H100 SXM 80GB, 700 W data sheet", 3.35e12, 33.5e12)

BLAKE3_OPS = 800


@dataclass(frozen=True)
class Cost:
    name: str
    int_ops: float
    bytes_moved: float

    def bound_s(self, chip: Chip = H100) -> tuple[float, str]:
        """(least seconds the card could take, "bytes" or "operations")."""
        tb = self.bytes_moved / chip.hbm_bytes_s
        to = self.int_ops / chip.int32_ops_s
        return (tb, "bytes") if tb >= to else (to, "operations")


def dit_ops(count: int, s0: int, s1: int, W: int) -> int:
    half = count // 2
    return sum(half * 8 * W + (half - (count >> (s + 1))) * 4 * W * W for s in range(s0, s1))


def ntt_cost(batch: int, n: int, L: int, stages: int, scale: bool = False) -> Cost:
    W, log_n = L // 2, n.bit_length() - 1
    ops = dit_ops(batch * n, log_n - stages, log_n, W) + (batch * n * 4 * W * W if scale else 0)
    return Cost(f"ntt_b{batch}_n{n}_L{L}", ops, 2 * batch * n * L * 4)


def hash_columns_cost(n_rows: int, n_cols: int, repr_bytes: int) -> Cost:
    L = (repr_bytes + 1) // 2
    msg = 32 + n_rows * repr_bytes
    return Cost(f"hash_{n_rows}x{n_cols}",
                n_cols * (-(-msg // 64) + -(-msg // 1024) - 1) * BLAKE3_OPS,
                n_rows * n_cols * L * 4 + n_cols * 32)


def merkle_tree_cost(np2: int) -> Cost:
    return Cost(f"merkle_tree_{np2}", (np2 - 1) * BLAKE3_OPS, (2 * np2 - 1) * 32)


def chunk_cvs_cost(n_rows: int, n_cols: int, repr_bytes: int) -> Cost:
    L = (repr_bytes + 1) // 2
    msg = n_rows * repr_bytes
    return Cost(f"chunk_cvs_{n_rows}x{n_cols}", n_cols * -(-msg // 64) * BLAKE3_OPS,
                n_rows * n_cols * L * 4 + n_cols * -(-msg // 1024) * 32)


def merge_cvs_cost(n_cols: int, chunks: int) -> Cost:
    return Cost(f"merge_cvs_{n_cols}x{chunks}", n_cols * (chunks - 1) * BLAKE3_OPS,
                n_cols * chunks * 32 + n_cols * 32)


def collapse_cost(n_rows: int, n_per_row: int, L: int, T: int, bits: int = 32,
                  acc: bool = False) -> Cost:
    W = L // 2
    nbytes = (n_rows * n_per_row * L * bits // 8
              + (T * n_rows + T * n_per_row * (2 if acc else 1)) * L * 4)
    return Cost(f"collapse_{n_rows}x{n_per_row}_T{T}", 2 * T * n_rows * n_per_row * W * W,
                nbytes)


def expander_cost(batch: int, levels: list[tuple[int, int, int]], L: int) -> Cost:
    W = L // 2
    nbytes = ops = 0
    for rows, cols, used in levels:
        nbytes += (batch * cols + batch * rows) * L * 4 + used * (4 + 4 * W) + rows * 8
        ops += batch * used * W * W * 2
    return Cost(f"expander_b{batch}_{len(levels)}levels", ops, nbytes)


def sum_bounds(costs: list[Cost], chip: Chip = H100) -> tuple[float, str]:
    """Seconds of a set of kernel calls at their bounds, and which bound
    holds most of them."""
    total = {"bytes": 0.0, "operations": 0.0}
    for c in costs:
        s, by = c.bound_s(chip)
        total[by] += s
    return total["bytes"] + total["operations"], max(total, key=total.get)
