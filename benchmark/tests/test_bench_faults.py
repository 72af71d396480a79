"""The comparison that decides ``correct``: a sound run passes it, and the
control and every fault the cells can have fail it.

Each run drives a whole cell on the CPU at a tiny size (``bench_fixture``):
the window, the metrics and the reference's check, with the timed path
broken underneath by ``lcbench.faults``.  The control leaves the codewords
unreduced where a kernel that skips its last conditional subtraction would
(the configurations guarantee canonical reprs); the faults leave out half of
an encode's rows, alter a value where the encode produces it, alter the
proof's evaluation row, and alter the evaluation verify returns.  A step
that returns its state unchanged and the exchange between chips have no
counterpart here: a commit keeps no state across calls, and every cell runs
on one card.
"""

from __future__ import annotations

import pytest

import bench_fixture


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    bench_fixture.tiny_tree(tmp)
    return tmp


@pytest.mark.parametrize("workload", ["ligero-2e28-commit-tiny", "brakedown-2e25-commit-tiny",
                                      "ligero-2e28-cpv-tiny"])
def test_sound_run_is_correct(tree, workload):
    res = bench_fixture.run(tree, workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload,fault,caught_by", [
    ("ligero-2e28-commit-tiny", "lazy_reduction", "noncanonical"),
    ("brakedown-2e25-commit-tiny", "lazy_reduction", "noncanonical"),
    ("ligero-2e28-commit-tiny", "half_rows", "codeword_cols_wrong"),
    ("brakedown-2e25-commit-tiny", "half_rows", "codeword_cols_wrong"),
    ("ligero-2e28-commit-tiny", "altered_value", "codeword_cols_wrong"),
    ("brakedown-2e25-commit-tiny", "altered_value", "codeword_cols_wrong"),
    ("ligero-2e28-cpv-tiny", "lazy_reduction", "noncanonical"),
    ("ligero-2e28-cpv-tiny", "altered_proof", "proof_bytes_wrong"),
    ("ligero-2e28-cpv-tiny", "altered_eval", "evals_wrong"),
])
def test_fault_is_not_correct(tree, workload, fault, caught_by):
    res = bench_fixture.run(tree, workload, fault=fault)
    assert not res["correct"]
    assert res["checks"][caught_by]["value"] > res["checks"][caught_by]["limit"], res["checks"]


def test_held_back_readers_read_the_cpv_mix(tree):
    """The readers kept for the held-back ``ligero-2e28-cpv`` cell: its
    end-to-end metrics, and in a traced run the ones read from the program's
    spans (its untraced window); the device-trace ones find no card here and
    stay out of the line."""
    res = bench_fixture.run(tree, "ligero-2e28-cpv-tiny")
    assert {"prove_ms", "verify_ms", "setup_s"} <= set(res["metrics"])
    assert all(res["metrics"][m]["value"] > 0 for m in ("prove_ms", "verify_ms"))
    traced = bench_fixture.run(tree, "ligero-2e28-cpv-tiny", trace=True)
    assert traced["correct"], traced["checks"]
    assert {"prove.collapse_ms", "verify.transcript_ms"} <= set(traced["metrics"])
    assert "collapse_roofline" not in traced["metrics"]
