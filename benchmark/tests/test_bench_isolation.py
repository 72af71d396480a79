"""What the benchmark loads: nothing of JAX or the JAX package anywhere, and
nothing of the program in the reference.  Top-level module names are
compared whole (the program's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import bench_fixture

FORBIDDEN = {"jax", "jaxlib", "flax", "lcpc_proof_of_storage_tpu"}
PROGRAM = "lcpc_proof_of_storage_tpu_torch"


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    for path in bench_fixture.BENCH.rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path


def test_reference_source_imports_nothing_of_the_program():
    for path in (bench_fixture.BENCH / "reference").glob("*.py"):
        assert PROGRAM not in _top_level_imports(path), path


def _loaded_after(code: str, tmp: Path) -> set[str]:
    script = (f"import sys, json\nsys.path[:0] = [{str(bench_fixture.BENCH)!r}, "
              f"{str(bench_fixture.REPO)!r}]\n{code}\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=tmp, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    bench_fixture.tiny_tree(tmp_path)
    loaded = _loaded_after(
        f"sys.path.insert(0, {str(bench_fixture.BENCH / 'tests')!r})\n"
        "import bench_fixture, pathlib\n"
        "res = bench_fixture.run(pathlib.Path('.').resolve(), 'ligero-2e28-cpv-tiny')\n"
        "assert res['correct'], res['checks']", tmp_path)
    assert not loaded & FORBIDDEN
    assert PROGRAM in loaded


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    loaded = _loaded_after(
        "import reference, reference.blake3, reference.brakedown, reference.chacha, "
        "reference.field, reference.ligero, reference.proof, reference.transcript",
        tmp_path)
    assert PROGRAM not in loaded and not loaded & FORBIDDEN
