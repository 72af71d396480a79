"""The port imports torch and never JAX.

Checked in a subprocess: tests/conftest.py imports jax into this process.
"""

import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "lcpc_proof_of_storage_tpu_torch"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import lcpc_proof_of_storage_tpu_torch as p\n"
            "p.LigeroEncoding, p.commit, p.prove, p.verify\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
            "assert 'torch' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_sources():
    for src in list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py",
                                          PKG.parent / "chip_profile.py"]:
        for line in src.read_text().splitlines():
            words = line.split()
            assert words[:2] not in (["import", "jax"], ["from", "jax"]) and not (
                words[:1] in (["import"], ["from"]) and words[1:2]
                and words[1].startswith("jax.")), f"{src}: {line}"


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py and chip_profile.py reach the reference's host modules
    only through the port's re-exports."""
    for script in ("chip_smoke.py", "chip_profile.py"):
        for line in (PKG.parent / script).read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and words[1:2]
                        and words[1].split(".")[0] == "lcpc_proof_of_storage_tpu"), \
                f"{script}: {line}"
