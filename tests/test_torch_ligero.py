"""The port's Ligero commit -> prove -> verify slice against the JAX package.

- the Ligero golden pins of tests/golden_vectors.json, reproduced by the
  port alone (same inputs as tests/test_golden_vectors.py);
- roots, bincode proof bytes and transcript states equal to the reference's
  on a seeded input, each package with its own transcript, serde and field
  specs;
- proofs cross-verify in both directions, a carried-over commitment proves
  to the same bytes, and tampered proofs fail with the reference's kind;
- the reference faults the port does not copy.

All comparisons are exact.  The JAX side runs ft63 at golden-size dims.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.codes.ligero import LigeroEncoding as JaxLigero
from lcpc_proof_of_storage_tpu.core import commit as jax_core
from lcpc_proof_of_storage_tpu.crypto.transcript import Transcript as JaxTranscript
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.utils import serde as jax_serde
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.core import commit as port
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT253_192, FT255
from lcpc_proof_of_storage_tpu_torch.utils import serde
from lcpc_proof_of_storage_tpu_torch.utils.carry import (commit_from_reference,
                                                         encoding_from_reference,
                                                         proof_from_reference)

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden_vectors.json").read_text())
X = 123456789


def _tr(root: bytes, cls=Transcript):
    tr = cls(b"golden")
    tr.append_message(b"polycommit", root)
    return tr


def _jtr(root: bytes):
    return _tr(root, JaxTranscript)


def _tensors(spec, n_rows, n_per_row, x=X):
    p = spec.modulus
    xr = pow(x, n_per_row, p)
    return [pow(xr, i, p) for i in range(n_rows)], [pow(x, j, p) for j in range(n_per_row)]


def _sha(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


# -- golden pins, port only ---------------------------------------------------

def test_golden_ft63_pins():
    coeffs = [(i * 2654435761 + 12345) % FT63.modulus for i in range(512)]
    enc = LigeroEncoding.new_from_dims(16, 64, FT63)
    comm = port.commit(coeffs, enc, device="cpu")
    root = comm.get_root().root
    outer, _ = _tensors(FT63, comm.n_rows, comm.n_per_row)
    tr = _tr(root)
    proof = port.prove(comm, outer, enc, tr)
    blob = serde.serialize_proof(proof, FT63)
    assert root.hex() == GOLDEN["ligero_ft63_root"]
    assert _sha(blob) == GOLDEN["proof_sha"]
    assert len(blob) == GOLDEN["proof_len"]
    assert _sha(tr.state_bytes()) == GOLDEN["transcript_state_sha"]
    proof_json = json.dumps(serde.proof_to_json(proof, FT63), sort_keys=True).encode()
    assert _sha(proof_json) == GOLDEN["proof_json_sha"]
    reser = serde.serialize_proof(serde.deserialize_proof(blob, FT63), FT63)
    assert _sha(reser) == GOLDEN["serde_reserialize_sha"]


@pytest.mark.parametrize("name,spec", [("ft255", FT255), ("ft253_192", FT253_192)])
def test_golden_wide_field_pins(name, spec):
    coeffs = [(i * 0x9E3779B97F4A7C15 + 7) % spec.modulus for i in range(512)]
    enc = LigeroEncoding.new_from_dims(16, 64, spec)
    comm = port.commit(coeffs, enc, device="cpu")
    root = comm.get_root().root
    outer, _ = _tensors(spec, comm.n_rows, comm.n_per_row)
    blob = serde.serialize_proof(port.prove(comm, outer, enc, _tr(root)), spec)
    assert root.hex() == GOLDEN[f"ligero_{name}_root"]
    assert _sha(blob) == GOLDEN[f"ligero_{name}_proof_sha"]
    assert len(blob) == GOLDEN[f"ligero_{name}_proof_len"]


# -- against the JAX package --------------------------------------------------

@pytest.fixture(scope="module")
def case():
    """One seeded ft63 input committed and proved by both packages."""
    spec, jspec = FT63, jax_field.FT63
    rng = np.random.default_rng(20261016)
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=500)]
    jenc = JaxLigero.new_from_dims(16, 64, jspec)
    jcomm = jax_core.commit(coeffs, jenc)
    root = jcomm.get_root().root
    outer, inner = _tensors(spec, jcomm.n_rows, jcomm.n_per_row)
    jtr = _jtr(root)
    jblob = jax_serde.serialize_proof(jax_core.prove(jcomm, outer, jenc, jtr), jspec)
    enc = encoding_from_reference(jenc)
    comm = port.commit(coeffs, enc, device="cpu")
    value = sum(c * pow(X, i, spec.modulus) for i, c in enumerate(coeffs)) % spec.modulus
    return dict(spec=spec, jspec=jspec, coeffs=coeffs, jenc=jenc, jcomm=jcomm, root=root,
                outer=outer, inner=inner, jblob=jblob, jstate=jtr.state_bytes(), enc=enc,
                comm=comm, value=value)


def _port_proof(case, tr=None):
    return port.prove(case["comm"], case["outer"], case["enc"], tr or _tr(case["root"]))


def _jax_verify(case, proof):
    return jax_core.verify(case["root"], case["outer"], case["inner"], proof, case["jenc"],
                           _jtr(case["root"]))


def _port_verify(case, proof):
    return port.verify(case["root"], case["outer"], case["inner"], proof, case["enc"],
                       _tr(case["root"]), device="cpu")


def test_root_and_proof_bytes_match_reference(case):
    assert case["comm"].get_root().root == case["root"]
    tr = _tr(case["root"])
    assert serde.serialize_proof(_port_proof(case, tr), case["spec"]) == case["jblob"]
    assert tr.state_bytes() == case["jstate"]


def test_reference_proof_verifies_under_port(case):
    jproof = jax_serde.deserialize_proof(case["jblob"], case["jspec"])
    assert _port_verify(case, proof_from_reference(jproof)) == case["value"]
    blob_proof = serde.deserialize_proof(case["jblob"], case["spec"])
    assert _port_verify(case, blob_proof) == case["value"]


def test_port_proof_verifies_under_reference(case):
    blob = serde.serialize_proof(_port_proof(case), case["spec"])
    assert _jax_verify(case, jax_serde.deserialize_proof(blob, case["jspec"])) == case["value"]


def test_carried_commitment_proves_to_same_bytes(case):
    comm = commit_from_reference(case["jcomm"], device="cpu")
    assert comm.coeffs.dtype == torch.int32 and comm.hashes.dtype == torch.int32
    proof = port.prove(comm, case["outer"], case["enc"], _tr(case["root"]))
    assert serde.serialize_proof(proof, case["spec"]) == case["jblob"]


def _tamper(proof, what, spec):
    if what == "column":
        proof.columns[0].col[0] = (proof.columns[0].col[0] + 1) % spec.modulus
    elif what == "path":
        proof.columns[1].path[0] = bytes(32)
    elif what == "eval":
        proof.p_eval[0] = (proof.p_eval[0] + 1) % spec.modulus
    elif what == "long_row":
        proof.p_random_vec[0].append(5)


@pytest.mark.parametrize("what", ["column", "path", "eval", "long_row"])
def test_tampered_proof_fails_like_reference(case, what):
    """The port raises the reference's VerifierError kind.  "long_row" is one
    extra nonzero coefficient on p_random_vec[0]: both reject it with
    ColumnDegree (the port re-encodes every coefficient of the widened row)."""
    jproof = jax_serde.deserialize_proof(case["jblob"], case["jspec"])
    _tamper(jproof, what, case["spec"])
    with pytest.raises(jax_core.VerifierError) as want:
        _jax_verify(case, jproof)
    proof = _port_proof(case)
    _tamper(proof, what, case["spec"])
    with pytest.raises(port.VerifierError) as got:
        _port_verify(case, proof)
    assert got.value.kind == want.value.kind
    if what == "long_row":
        assert got.value.kind == "ColumnDegree"


def test_verify_folds_paths_without_native_library(case, monkeypatch):
    """Where the native library is not built, the path folds run in Python
    and give the same verdicts."""
    monkeypatch.setattr(port, "fold_paths_native", lambda *a: None)
    assert _port_verify(case, _port_proof(case)) == case["value"]
    proof = _port_proof(case)
    _tamper(proof, "path", case["spec"])
    with pytest.raises(port.VerifierError) as e:
        _port_verify(case, proof)
    assert e.value.kind == "ColumnPath"


def test_open_column_and_paths_match_reference(case):
    comm, jcomm, spec = case["comm"], case["jcomm"], case["spec"]
    cols = [0, 5, 63]
    assert port.merkle_paths_batch(comm, cols) == jax_core.merkle_paths_batch(jcomm, cols)
    for c in cols:
        got = port.open_column(comm, c, spec)
        want = jax_core.open_column(jcomm, c, spec)
        assert got.col == want.col and got.path == want.path
    with pytest.raises(port.ProverError):
        port.open_column(comm, 64)


# -- reference faults the port does not copy ----------------------------------

def test_prove_gathers_paths_once(case, monkeypatch):
    """prove builds byte paths only when it has no packed sibling array."""
    def fail(*a, **k):
        raise AssertionError("byte paths built after the packed gather")
    monkeypatch.setattr(port, "merkle_paths_batch", fail)
    proof = _port_proof(case)
    assert all(c._path is None and c._sibs is proof._paths_packed for c in proof.columns)


def test_check_comm_requires_exact_width(case):
    comm = case["comm"]
    wide = port.LcCommit(coeffs=comm.coeffs, comm=torch.cat([comm.comm, comm.comm[:, :1]], 1),
                         n_rows=comm.n_rows, n_cols=comm.n_cols, n_per_row=comm.n_per_row,
                         hashes=comm.hashes)
    with pytest.raises(port.ProverError):
        port.prove(wide, case["outer"], case["enc"], _tr(case["root"]))


def test_packed_path_fast_path_checks_row_index(case):
    """Two columns that swap their rows of the packed sibling array no longer
    fold through the fast path; their own (wrong) paths fail."""
    proof = _port_proof(case)
    c0, c1 = proof.columns[0], proof.columns[1]
    c0._sibi, c1._sibi = 1, 0
    with pytest.raises(port.VerifierError) as e:
        _port_verify(case, proof)
    assert e.value.kind == "ColumnPath"


# -- encoding ------------------------------------------------------------------

@pytest.mark.parametrize("length,spec,rho", [
    (512, FT63, (1, 2)), (1 << 12, FT255, (1, 4)), (1 << 20, FT255, (1, 4)),
    (1 << 21, FT255, (1, 4)), (100_000, FT253_192, (1, 2))])
def test_dims_and_soundness_match_reference(length, spec, rho):
    jspec = jax_field.FIELDS[spec.name]
    assert LigeroEncoding._get_dims(length, spec, rho) == JaxLigero._get_dims(length, jspec, rho)
    dims = LigeroEncoding._get_dims(length, spec, rho)
    assert (LigeroEncoding._n_col_opens(rho), LigeroEncoding._n_degree_tests(dims[2], spec)) == \
        (JaxLigero._n_col_opens(rho), JaxLigero._n_degree_tests(dims[2], jspec))


def test_main_path_dims():
    enc = LigeroEncoding.new(1 << 20, FT255, rho=(1, 4))
    assert enc.get_dims(1 << 20) == (128, 8192, 32768)
    assert (enc.get_n_degree_tests(), enc.get_n_col_opens()) == (1, 189)
    ml = LigeroEncoding.new_ml(12, FT63)
    assert ml.get_dims(1 << 12)[0] * ml.n_per_row == 1 << 12


def test_commit_places_everything_on_its_device(case):
    comm = case["comm"]
    assert {comm.coeffs.device.type, comm.comm.device.type, comm.hashes.device.type} == {"cpu"}
    assert list(case["enc"]._tables_on) == [torch.device("cpu")]
    assert comm.hashes.shape == (2 * 64 - 1, 8)


def test_commit_leaves_the_encoding_alone(case):
    """commit on `device` encodes with the encoding's tables for that device
    and moves nothing the encoding holds."""
    enc = case["enc"]
    tables = enc.ntt_tables
    comm = port.commit(case["coeffs"], enc, device="cpu")
    assert enc.ntt_tables is tables and enc.tables(torch.device("cpu")) is tables
    assert comm.get_root().root == case["root"]


def test_verify_runs_on_the_device_it_is_given(case, monkeypatch):
    """verify encodes on the device it is given, else on the card where
    there is one and on the CPU here (chip_smoke.py checks on the card that
    a default verify launches the encoding's kernel)."""
    seen = []
    encode = case["enc"].encode

    def spy(rows):
        seen.append(rows.device)
        return encode(rows)

    monkeypatch.setattr(case["enc"], "encode", spy)
    assert _port_verify(case, _port_proof(case)) == case["value"]
    assert port.verify(case["root"], case["outer"], case["inner"], _port_proof(case),
                       case["enc"], _tr(case["root"]), device="cpu") == case["value"]
    assert seen == [torch.device("cpu")] * 2


def test_entry_points_default_to_the_card(monkeypatch):
    """commit and verify run on the card where there is one, unless given
    the CPU; with no card and no device they raise instead of falling back."""
    from lcpc_proof_of_storage_tpu_torch.core.commit import default_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert default_device() == torch.device("cuda", 0)
    assert default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()


def test_commit_without_a_card_or_device_raises(monkeypatch, case):
    """No card and no device: commit and verify raise; device="cpu" is the
    one way to run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.commit(case["coeffs"], case["enc"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.commit(torch.zeros((4, FT63.num_limbs16), dtype=torch.int32), case["enc"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.verify(case["root"], case["outer"], case["inner"], _port_proof(case), case["enc"],
                    _tr(case["root"]))
    assert port.commit(case["coeffs"], case["enc"], device="cpu").get_root().root == case["root"]
