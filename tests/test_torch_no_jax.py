"""The port imports torch and never JAX, and nothing of the JAX package.

Checked in a subprocess: tests/conftest.py imports jax into this process.
"""

import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "lcpc_proof_of_storage_tpu_torch"
REFERENCE = "lcpc_proof_of_storage_tpu"
SCRIPTS = (PKG.parent / "chip_smoke.py", PKG.parent / "chip_profile.py")

DRIVE = """
import importlib, sys
for m in MODULES:
    importlib.import_module(m)
import lcpc_proof_of_storage_tpu_torch as p
from lcpc_proof_of_storage_tpu_torch.fields import FT63

def run(enc, n, commit=p.commit):
    coeffs = [(i * 2654435761 + 12345) % FT63.modulus for i in range(n)]
    comm = commit(coeffs, enc, device="cpu")
    root = comm.get_root().root
    x = 987654321
    xr = pow(x, comm.n_per_row, FT63.modulus)
    outer = [pow(xr, i, FT63.modulus) for i in range(comm.n_rows)]
    inner = [pow(x, j, FT63.modulus) for j in range(comm.n_per_row)]
    def tr():
        t = p.Transcript(b"no-jax")
        t.append_message(b"polycommit", root)
        return t
    proof = p.deserialize_proof(p.serialize_proof(p.prove(comm, outer, enc, tr()), FT63), FT63)
    want = 0
    for c in reversed(coeffs):
        want = (want * x + c) % FT63.modulus
    assert p.verify(root, outer, inner, proof, enc, tr(), device="cpu") == want

run(p.LigeroEncoding.new_from_dims(16, 64, FT63), 300)
run(p.LigeroEncoding.new_from_dims(256, 2048, FT63, ntt="four_step"), 600)
run(p.BrakedownEncoding.new(400, seed=3, field=FT63), 400)
run(p.LigeroEncoding.new_from_dims(4, 16, FT63), 1100,
    lambda c, e, device: p.commit_streamed(c, e, target_batch_rows=100, keep_comm=False,
                                           device_coeffs=False, device=device))

import asyncio, pathlib, tempfile
from lcpc_proof_of_storage_tpu_torch.pos.database import MetadataStore
from lcpc_proof_of_storage_tpu_torch.pos.networking.client import ClientSession
from lcpc_proof_of_storage_tpu_torch.pos.networking.server import serve

async def pos_round_trip(base):
    server = await serve(0, base=base, db_path=str(base / "srv_db"), device="cpu")
    port = server.sockets[0].getsockname()[1]
    data = bytes((i * 31 + 7) % 256 for i in range(3000))
    (base / "f.bin").write_bytes(data)
    session = await ClientSession.connect(f"127.0.0.1:{port}", MetadataStore(base / "db"),
                                          device="cpu")
    try:
        meta = await session.upload_file(base / "f.bin", 8, 32)
        await session.request_and_verify_proof(meta)
        await session.request_and_verify_polynomial(meta)
        assert await session.download_file(meta) == data
    finally:
        await session.close()
        server.close()
        await server.wait_closed()

with tempfile.TemporaryDirectory() as d:
    asyncio.run(pos_round_trip(pathlib.Path(d)))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "lcpc_proof_of_storage_tpu"))
assert not bad, bad
assert "torch" in sys.modules
"""


def test_importing_the_port_loads_no_jax():
    """Every port module imports, and a tiny Ligero (on the stages and the
    four_step routes), a tiny Brakedown and a tiny streamed Ligero (three
    row batches, host coefficients, no encoded matrix kept) commit -> prove
    -> serde -> verify run on the CPU, then a tiny PoS round trip (an
    in-process server and client: upload, proof, polynomial evaluation,
    download), with no jax* and no lcpc_proof_of_storage_tpu module loaded."""
    modules = sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = f"MODULES = {modules!r}\n" + DRIVE
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _imports(src: Path):
    """(line, top-level module) of every import statement in a source file."""
    for line in src.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and words[1:2]:
            yield line, words[1].split(".")[0]


def test_no_jax_import_in_sources():
    sources = [*PKG.rglob("*.py"), *SCRIPTS]
    assert {"storage.py", "server.py", "client.py", "cli.py"} <= {
        p.name for p in PKG.rglob("*.py") if "pos" in p.relative_to(PKG).parts}
    for src in sources:
        for line, top in _imports(src):
            assert top not in ("jax", "jaxlib"), f"{src}: {line}"


def test_chip_smoke_imports_only_the_port():
    """Neither the port nor chip_smoke.py / chip_profile.py import the JAX
    package, not even its JAX-free modules."""
    for src in [*PKG.rglob("*.py"), *SCRIPTS]:
        for line, top in _imports(src):
            assert top != REFERENCE, f"{src}: {line}"
        assert f"{REFERENCE}." not in src.read_text().replace(
            f"{REFERENCE}_torch", "").replace(f"{REFERENCE}/", ""), src
