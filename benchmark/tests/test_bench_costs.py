"""The yardstick's frozen cost functions equal the program's cost model
(``utils/profiling.py``) at the cells' shapes, and the Brakedown levels the
yardstick derives from the reference's dimensions are the program's tables."""

from __future__ import annotations

import functools

import pytest

import bench_fixture  # noqa: F401  (puts the benchmark on sys.path)
from lcbench import costs
from lcpc_proof_of_storage_tpu_torch.utils import profiling as prog
from reference import brakedown, field

F = field.FIELDS["ft255"]


def _levels(n_per_row: int):
    pre, post = brakedown.level_dims(n_per_row, F, brakedown.CODES["sdig3"])
    return [(m, n, n * d) for n, m, d in pre + post]


CASES = {
    "K1 ligero 2^28 commit": ("ntt_cost", (2048, 1 << 19, 16, 17)),
    "K1 one batch": ("ntt_cost", (32, 1 << 19, 16, 17)),
    "chunk CVs ligero 2^28": ("chunk_cvs_cost", (2048, 1 << 19, 32)),
    "merge ligero 2^28": ("merge_cvs_cost", (1 << 19, 65)),
    "tree ligero 2^28": ("merkle_tree_cost", (1 << 19,)),
    "leaves brakedown 2^25": ("hash_columns_cost", (143, 357697, 32)),
    "tree brakedown 2^25": ("merkle_tree_cost", (1 << 19,)),
    "K3 ligero 2^28 prove": ("collapse_cost", (2048, 131072, 16, 2, 16)),
    "K5 brakedown 2^25": ("expander_cost", (143, _levels(235172), 16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frozen_cost_equals_program(case):
    name, args = CASES[case]
    mine = getattr(costs, name)(*args)
    theirs = getattr(prog, name)(*args)
    assert (mine.int_ops, mine.bytes_moved) == (theirs.int_ops, theirs.bytes_moved)
    s, by = mine.bound_s()
    ms, by2 = theirs.bound_ms()
    assert by == by2 and s * 1e3 == pytest.approx(ms, rel=1e-12)


@functools.lru_cache(maxsize=None)
def _program_levels(n_per_row: int):
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
    enc = ex.ExpanderEncoder.build(n_per_row, 0, FT255, ex.SDIG_CODE_3)
    return [(t.rows, t.cols, int(t.counts.sum())) for t in (*enc.pre, *enc.post)]


@pytest.mark.parametrize("n_per_row", [10393, 235172])
def test_expander_levels_are_the_programs(n_per_row):
    assert _levels(n_per_row) == _program_levels(n_per_row)
