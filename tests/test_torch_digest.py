"""The port's generic host digests and commitment serde against the JAX package.

- the native BLAKE2b-256 and the native Merkle layers equal ``hashlib`` and
  the Python fallback;
- the port reproduces the ``blake2b_ligero_ft63_root`` pin of
  tests/golden_vectors.json, and its Blake2b root equals the reference's;
- Blake2b proofs cross-verify in both directions; a tampered path fails
  with ColumnPath, and so does a Blake2b proof verified as Blake3;
- ``serialize_commit`` / ``serialize_root`` bytes equal the reference's on
  the same commitment, and ``deserialize_commit`` gives it back.

Inputs come from np.random.default_rng; every comparison is exact.  The
JAX side runs ft63 at golden-size dims.
"""

import copy
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
from lcpc_proof_of_storage_tpu_torch import native
from lcpc_proof_of_storage_tpu_torch.codes.brakedown import BrakedownEncoding
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.core import commit as port
from lcpc_proof_of_storage_tpu_torch.crypto import digest
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT253_192
from lcpc_proof_of_storage_tpu_torch.fields.field import ints_to_limbs
from lcpc_proof_of_storage_tpu_torch.utils import serde
from lcpc_proof_of_storage_tpu_torch.utils.carry import (commit_from_reference,
                                                         proof_from_reference)

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden_vectors.json").read_text())
X = 123456789


def _tr(root: bytes, cls=Transcript):
    tr = cls(b"golden")
    tr.append_message(b"polycommit", root)
    return tr


def _tensors(spec, n_rows, n_per_row, x=X):
    p = spec.modulus
    xr = pow(x, n_per_row, p)
    return [pow(xr, i, p) for i in range(n_rows)], [pow(x, j, p) for j in range(n_per_row)]


def _eval(coeffs, spec, x=X):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % spec.modulus
    return acc


@pytest.fixture(scope="module")
def case():
    """A seeded ft63 Ligero (16, 64) input, committed with Blake2b in both
    packages, and a proof from each."""
    rng = np.random.default_rng(11)
    coeffs = [int(v) for v in rng.integers(0, FT63.modulus, size=500)]
    enc = LigeroEncoding.new_from_dims(16, 64, FT63)
    jenc = JaxLigero.new_from_dims(16, 64, jax_field.FT63)
    comm = port.commit(coeffs, enc, device="cpu", digest="blake2b")
    jcomm = jax_core.commit(coeffs, jenc, digest="blake2b")
    root = comm.get_root().root
    outer, inner = _tensors(FT63, comm.n_rows, comm.n_per_row)
    return {"coeffs": coeffs, "enc": enc, "jenc": jenc, "comm": comm, "jcomm": jcomm,
            "root": root, "outer": outer, "inner": inner,
            "proof": port.prove(comm, outer, enc, _tr(root)),
            "jproof": jax_core.prove(jcomm, outer, jenc, _tr(root, JaxTranscript))}


# -- the host library ---------------------------------------------------------

@pytest.mark.parametrize("length", [0, 1, 64, 127, 128, 129, 256, 1000])
def test_native_blake2b_equals_hashlib(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, size=(5, length), dtype=np.uint8)
    got = native.blake2b_many_native(msgs)
    if got is None:
        pytest.skip("no C++ compiler for the host library")
    want = [hashlib.blake2b(m.tobytes(), digest_size=32).digest() for m in msgs]
    assert [g.tobytes() for g in got] == want
    assert [digest.BLAKE2B.hash(m.tobytes()) for m in msgs] == want


@pytest.mark.parametrize("name", ["blake2b"])
@pytest.mark.parametrize("n_cols", [1, 2, 3, 5, 7, 64, 128, 257, 1000, 4096])
def test_merkle_tree_host_native_and_fallback_agree(name, n_cols, monkeypatch):
    """merkle_tree_host (native layers where built) equals the tree folded
    here with hashlib's Blake2b, and the Python fallback."""
    d = digest.get_digest(name)
    rng = np.random.default_rng(n_cols)
    leaves = rng.integers(0, 256, size=(n_cols, 32), dtype=np.uint8)
    got = digest.merkle_tree_host(leaves, n_cols, d)
    np2 = 1 << max(0, (n_cols - 1).bit_length())
    layer = [leaves[i].tobytes() if i < n_cols else bytes(32) for i in range(np2)]
    want = list(layer)
    while len(layer) > 1:
        layer = [hashlib.blake2b(layer[i] + layer[i + 1], digest_size=32).digest()
                 for i in range(0, len(layer), 2)]
        want += layer
    assert got.dtype == torch.int32 and got.shape == (2 * np2 - 1, 8)
    assert got.numpy().view("<u4").tobytes() == b"".join(want)
    monkeypatch.setattr(d, "_layers_fn", None)
    monkeypatch.setattr(d, "_many_fn", None)
    assert torch.equal(digest.merkle_tree_host(leaves, n_cols, d), got)


def test_column_leaves_host_big_endian_reprs():
    """Leaves hash H(0^32 || to_repr of each value), ft253_192 reversing each
    value's bytes."""
    rng = np.random.default_rng(5)
    vals = [[int(v) % FT253_192.modulus for v in rng.integers(0, 1 << 62, size=3)]
            for _ in range(4)]                                     # 4 rows, 3 columns
    limbs = np.stack([ints_to_limbs(r, FT253_192) for r in vals])
    got = digest.column_leaves_host(limbs, FT253_192, digest.BLAKE2B)
    for c in range(3):
        msg = bytes(32) + b"".join(FT253_192.to_repr(vals[r][c]) for r in range(4))
        assert got[c].tobytes() == hashlib.blake2b(msg, digest_size=32).digest()


def test_unknown_digest_is_rejected():
    with pytest.raises(ValueError, match="unknown digest"):
        port.commit([1, 2, 3], LigeroEncoding.new_from_dims(2, 4, FT63), device="cpu",
                    digest="sha3")


# -- commitments --------------------------------------------------------------

def test_golden_blake2b_root():
    coeffs = [(i * 2654435761 + 12345) % FT63.modulus for i in range(512)]
    comm = port.commit(coeffs, LigeroEncoding.new_from_dims(16, 64, FT63), device="cpu",
                       digest="blake2b")
    assert comm.get_root().root.hex() == GOLDEN["blake2b_ligero_ft63_root"]


def test_blake2b_commit_matches_reference(case):
    """Same Merkle array and encoded matrix as the reference; the Blake3
    commit shares the encoded matrix but not the root."""
    comm, jcomm = case["comm"], case["jcomm"]
    assert comm.hashes.numpy().view(np.uint32).tolist() == np.asarray(jcomm.hashes).tolist()
    b3 = port.commit(case["coeffs"], case["enc"], device="cpu")
    assert torch.equal(b3.comm, comm.comm)
    assert b3.get_root().root != case["root"]


def test_blake2b_brakedown_verifies():
    rng = np.random.default_rng(3)
    coeffs = [int(v) for v in rng.integers(0, FT63.modulus, size=700)]
    enc = BrakedownEncoding.new(700, seed=3, field=FT63)
    comm = port.commit(coeffs, enc, device="cpu", digest="blake2b")
    root = comm.get_root().root
    outer, inner = _tensors(FT63, comm.n_rows, comm.n_per_row)
    proof = port.prove(comm, outer, enc, _tr(root))
    assert port.verify(root, outer, inner, proof, enc, _tr(root), device="cpu",
                       digest="blake2b") == _eval(coeffs, FT63)


def test_reference_blake2b_proof_verifies_under_port(case):
    proof = proof_from_reference(case["jproof"])
    got = port.verify(case["root"], case["outer"], case["inner"], proof, case["enc"],
                      _tr(case["root"]), device="cpu", digest="blake2b")
    assert got == _eval(case["coeffs"], FT63)


def test_port_blake2b_proof_verifies_under_reference(case):
    blob = serde.serialize_proof(case["proof"], FT63)
    assert blob == jax_serde.serialize_proof(case["jproof"], case["jenc"].spec)
    jproof = jax_serde.deserialize_proof(blob, case["jenc"].spec)
    got = jax_core.verify(case["root"], case["outer"], case["inner"], jproof, case["jenc"],
                          _tr(case["root"], JaxTranscript), digest="blake2b")
    assert got == _eval(case["coeffs"], FT63)


@pytest.mark.parametrize("what", ["path", "column", "digest"])
def test_tampered_blake2b_proof_fails(case, what):
    proof = copy.deepcopy(case["proof"])
    used = "blake2b"
    if what == "path":
        col = proof.columns[3]
        col._path = [bytes(32)] + col.path[1:]
        kind = "ColumnPath"
    elif what == "column":
        col = proof.columns[0]
        col._col = [(col.col[0] + 1) % FT63.modulus] + col.col[1:]
        kind = "ColumnDegree"
    else:
        used = "blake3"
        kind = "ColumnPath"
    with pytest.raises(port.VerifierError) as e:
        port.verify(case["root"], case["outer"], case["inner"], proof, case["enc"],
                    _tr(case["root"]), device="cpu", digest=used)
    assert e.value.kind == kind


def test_verify_column_path(case):
    comm = case["comm"]
    col = port.open_column(comm, 5)
    assert port.verify_column_path(col, 5, case["root"], FT63, digest="blake2b")
    assert not port.verify_column_path(col, 6, case["root"], FT63, digest="blake2b")
    assert not port.verify_column_path(col, 5, case["root"], FT63)
    b3 = port.commit(case["coeffs"], case["enc"], device="cpu")
    assert port.verify_column_path(port.open_column(b3, 5), 5, b3.get_root().root, FT63)


# -- serde --------------------------------------------------------------------

def test_root_serde_matches_reference(case):
    blob = serde.serialize_root(case["root"])
    assert blob == jax_serde.serialize_root(case["root"])
    assert serde.deserialize_root(blob) == case["root"]


def test_commit_serde_matches_reference(case):
    """A commitment serializes to the reference's bytes; the deserialized
    commitment proves to the same proof bytes, and the reference's
    deserialized commitment carried over serializes to them again."""
    spec = case["jenc"].spec
    comm = case["comm"]
    blob = serde.serialize_commit(comm, FT63)
    assert blob == jax_serde.serialize_commit(case["jcomm"], spec)
    back = serde.deserialize_commit(blob, FT63, device="cpu")
    assert torch.equal(back.hashes, comm.hashes) and torch.equal(back.comm, comm.comm)
    assert torch.equal(back.coeffs, comm.coeffs)
    root = comm.get_root().root
    assert (serde.serialize_proof(port.prove(back, case["outer"], case["enc"], _tr(root)), FT63)
            == serde.serialize_proof(case["proof"], FT63))
    carried = commit_from_reference(jax_serde.deserialize_commit(blob, spec), device="cpu")
    assert serde.serialize_commit(carried, FT63) == blob


def test_deserialize_commit_needs_a_device_without_a_card(case):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    blob = serde.serialize_commit(case["comm"], FT63)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serde.deserialize_commit(blob, FT63)
