"""A configuration, a system with calls of its own, a traffic mix and a
per-layer metric added as new files and new entries of BENCHMARK.json are
found and run, with no file of the benchmark edited; a traffic file the
loop cannot run as written is refused."""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest

import bench_fixture

FIXTURES = bench_fixture.BENCH / "tests" / "fixtures"
KINDS = ("configs", "systems", "reference", "traffic", "metrics")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _config(name):
    return {"name": name, "source": "a test fixture", "file": f"benchmark/configs/{name}.json",
            "reduced": [], "why": "a test fixture"}


def _cell(name, config, traffic):
    return {"name": name, "config": config, "traffic": traffic, "chips": 1,
            "why": "a test fixture"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny benchmark with the fixtures' files copied in beside its own
    and their entries added; returns (root, digests of the files that were
    there before)."""
    tmp = tmp_path_factory.mktemp("bench")
    spec = bench_fixture.tiny_tree(tmp)
    before = _digests(tmp)
    for kind in KINDS:
        for f in (FIXTURES / kind).iterdir():
            assert not (tmp / "benchmark" / kind / f.name).exists()
            shutil.copy(f, tmp / "benchmark" / kind / f.name)
    spec["configs"] += [_config("ligero_ft127_tiny"), _config("ligero_ft127_reread")]
    spec["workloads"] += [_cell("fixture-cell", "ligero_ft127_tiny", "commit_then_prove"),
                          _cell("fixture-audit", "ligero_ft127_tiny", "audit_queries"),
                          _cell("fixture-reread", "ligero_ft127_reread", "commit_reread")]
    by_name = {m["name"]: m for m in spec["end_to_end"]}
    by_name["commit_coeffs_per_s"]["workloads"] += ["fixture-cell", "fixture-reread"]
    by_name["prove_ms"]["workloads"].append("fixture-audit")
    by_name["verify_ms"]["workloads"].append("fixture-audit")
    spec["per_layer"].append({"name": "fixture.proofs_per_commit", "unit": "proofs",
                              "better": "higher", "source": "host_clock",
                              "layer": "a test fixture", "moves": "commit_coeffs_per_s",
                              "workloads": ["fixture-cell"]})
    bench_fixture.write_spec(tmp, spec)
    return tmp, before


def test_new_files_and_entries_run(tree):
    tmp, before = tree
    res = bench_fixture.run(tmp, "fixture-cell")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"commit_coeffs_per_s", "setup_s"}
    assert "proof_bytes_wrong" in res["checks"] and "evals_wrong" not in res["checks"]
    traced = bench_fixture.run(tmp, "fixture-cell", trace=True)
    assert traced["metrics"]["fixture.proofs_per_commit"]["value"] == 1.0
    after = _digests(tmp)
    assert {k: v for k, v in after.items() if k in before} == before
    assert json.loads((tmp / "BENCHMARK.json").read_text())["workloads"][-1]["name"] == \
        "fixture-reread"


def test_audit_mix_proves_against_a_standing_commitment(tree):
    """A commitment made by the traffic's set-up, then a window of prove and
    verify only: no commit is timed, every proof is against the set-up's
    root, and that root, a proof and the evaluations are checked."""
    tmp, _ = tree
    res = bench_fixture.run(tmp, "fixture-audit")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2 and res["attempted"] % 2 == 0
    assert set(res["metrics"]) == {"prove_ms", "verify_ms", "setup_s"}
    assert {"roots_wrong", "proof_bytes_wrong", "evals_wrong"} <= set(res["checks"])
    bad = bench_fixture.run(tmp, "fixture-audit", fault="altered_eval")
    assert bad["checks"]["evals_wrong"]["value"] > 0 and not bad["correct"]


def test_a_system_brings_calls_of_its_own(tree):
    tmp, _ = tree
    res = bench_fixture.run(tmp, "fixture-reread")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert "commit_coeffs_per_s" in res["metrics"]
    assert res["checks"]["rereads_differ"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("traffic,says", [
    ({"why": "x", "cycle": ["commit"], "clients": 4}, "keys the loop does not read"),
    ({"why": "x", "cycle": ["prove", "verify"]}, "before any 'commit'"),
    ({"why": "x", "setup": ["commit"], "cycle": ["verify"]}, "before any 'prove'"),
    ({"why": "x", "cycle": ["commit", "upload"]}, "does not have"),
    ({"why": "x", "cycle": []}, "no cycle"),
])
def test_traffic_the_loop_cannot_run_is_refused(traffic, says):
    from lcbench.harness import Program, check_traffic
    with pytest.raises(ValueError, match=says):
        check_traffic(traffic, Program)
