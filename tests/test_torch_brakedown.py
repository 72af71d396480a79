"""The port's Brakedown commit -> prove -> verify against the JAX package.

- the brakedown_ft63_{root,proof_sha,proof_len} pins of
  tests/golden_vectors.json, reproduced by the port alone;
- the same root, proof bytes and transcript state as the reference on a
  seeded input (each package with its own matgen, transcript and serde),
  and on the reference's own tables carried over;
- proofs cross-verify in both directions;
- a degree-test row with one extra coefficient gets the same verdict in
  both packages (Brakedown's encode reads n_per_row coefficients);
- dims and soundness equal the reference's at 2^11, 2^21 and 2^25 (the
  solver only at the large sizes: no matgen).

Inputs come from np.random.default_rng; every comparison is exact.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.codes import brakedown as jax_bd
from lcpc_proof_of_storage_tpu.core import commit as jax_core
from lcpc_proof_of_storage_tpu.crypto.transcript import Transcript as JaxTranscript
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.ops import expander as jax_ex
from lcpc_proof_of_storage_tpu.utils import serde as jax_serde
from lcpc_proof_of_storage_tpu_torch.codes import brakedown as port_bd
from lcpc_proof_of_storage_tpu_torch.codes.brakedown import BrakedownEncoding
from lcpc_proof_of_storage_tpu_torch.core import commit as port
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import FIELDS, FT63
from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
from lcpc_proof_of_storage_tpu_torch.utils import serde
from lcpc_proof_of_storage_tpu_torch.utils.carry import (brakedown_encoding_from_reference,
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


def test_golden_brakedown_pins():
    bde = BrakedownEncoding.new(512, seed=7, field=FT63)
    coeffs = [(i * 97 + 5) % FT63.modulus for i in range(512)]
    comm = port.commit(coeffs, bde, device="cpu")
    root = comm.get_root().root
    outer, _ = _tensors(FT63, comm.n_rows, comm.n_per_row)
    blob = serde.serialize_proof(port.prove(comm, outer, bde, _tr(root)), FT63)
    assert root.hex() == GOLDEN["brakedown_ft63_root"]
    assert hashlib.sha256(blob).hexdigest() == GOLDEN["brakedown_ft63_proof_sha"]
    assert len(blob) == GOLDEN["brakedown_ft63_proof_len"]


@pytest.fixture(scope="module")
def case():
    """One seeded ft63 input of 2000 coefficients committed and proved by
    both packages, each generating its own code (seed 0)."""
    spec, jspec = FT63, jax_field.FT63
    rng = np.random.default_rng(20261017)
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=2000)]
    jenc = jax_bd.BrakedownEncoding.new(2000, seed=0, field=jspec)
    jcomm = jax_core.commit(coeffs, jenc)
    root = jcomm.get_root().root
    outer, inner = _tensors(spec, jcomm.n_rows, jcomm.n_per_row)
    jtr = _tr(root, JaxTranscript)
    jblob = jax_serde.serialize_proof(jax_core.prove(jcomm, outer, jenc, jtr), jspec)
    enc = BrakedownEncoding.new(2000, seed=0, field=spec)
    value = sum(c * pow(X, i, spec.modulus) for i, c in enumerate(coeffs)) % spec.modulus
    return dict(spec=spec, jspec=jspec, coeffs=coeffs, jenc=jenc, root=root, outer=outer,
                inner=inner, jblob=jblob, jstate=jtr.state_bytes(), enc=enc,
                comm=port.commit(coeffs, enc, device="cpu"), value=value)


def _port_verify(case, proof, enc=None):
    return port.verify(case["root"], case["outer"], case["inner"], proof,
                       enc or case["enc"], _tr(case["root"]), device="cpu")


def _jax_verify(case, proof):
    return jax_core.verify(case["root"], case["outer"], case["inner"], proof, case["jenc"],
                           _tr(case["root"], JaxTranscript))


def test_root_proof_and_transcript_match_reference(case):
    assert (case["enc"].n_per_row, case["enc"].n_cols) == (case["jenc"].n_per_row,
                                                           case["jenc"].n_cols)
    assert case["comm"].get_root().root == case["root"]
    tr = _tr(case["root"])
    proof = port.prove(case["comm"], case["outer"], case["enc"], tr)
    assert serde.serialize_proof(proof, case["spec"]) == case["jblob"]
    assert tr.state_bytes() == case["jstate"]


def test_carried_tables_commit_and_prove_alike(case):
    """The reference's own tables (no port matgen) give the same bytes."""
    enc = brakedown_encoding_from_reference(case["jenc"])
    comm = port.commit(case["coeffs"], enc, device="cpu")
    assert comm.get_root().root == case["root"]
    proof = port.prove(comm, case["outer"], enc, _tr(case["root"]))
    assert serde.serialize_proof(proof, case["spec"]) == case["jblob"]
    assert _port_verify(case, proof, enc) == case["value"]


def test_reference_proof_verifies_under_port(case):
    assert _port_verify(case, serde.deserialize_proof(case["jblob"], case["spec"])) == \
        case["value"]
    jproof = jax_serde.deserialize_proof(case["jblob"], case["jspec"])
    assert _port_verify(case, proof_from_reference(jproof)) == case["value"]


def test_port_proof_verifies_under_reference(case):
    proof = port.prove(case["comm"], case["outer"], case["enc"], _tr(case["root"]))
    blob = serde.serialize_proof(proof, case["spec"])
    assert _jax_verify(case, jax_serde.deserialize_proof(blob, case["jspec"])) == case["value"]
    assert _port_verify(case, proof) == case["value"]


@pytest.mark.parametrize("what", ["long_row", "column", "eval"])
def test_tampered_proof_gets_the_reference_verdict(case, what):
    """"long_row" appends one nonzero coefficient to p_random_vec[0]: the
    encode of both packages reads only n_per_row coefficients, the transcript
    takes the whole row, and both reject the proof with the same kind."""
    jproof = jax_serde.deserialize_proof(case["jblob"], case["jspec"])
    proof = port.prove(case["comm"], case["outer"], case["enc"], _tr(case["root"]))
    for pr in (jproof, proof):
        if what == "long_row":
            pr.p_random_vec[0].append(5)
        elif what == "column":
            pr.columns[0].col[0] = (pr.columns[0].col[0] + 1) % FT63.modulus
        else:
            pr.p_eval[0] = (pr.p_eval[0] + 1) % FT63.modulus
    with pytest.raises(jax_core.VerifierError) as want:
        _jax_verify(case, jproof)
    with pytest.raises(port.VerifierError) as got:
        _port_verify(case, proof)
    assert got.value.kind == want.value.kind


def test_encode_reads_n_per_row_coefficients(case):
    """Coefficients past n_per_row do not enter the codeword (the
    reference's rows[:, :n_per_row])."""
    enc = case["enc"]
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.integers(0, 1 << 16, size=(2, enc.n_per_row + 7, 4))
                            .astype(np.int32))
    rows[..., 3] &= 0x3FFF
    assert torch.equal(enc.encode(rows), enc.encode(rows[:, : enc.n_per_row].clone()))


class _DimsOnly:
    """Stands in for an ExpanderEncoder: dims from the solver, no matgen."""

    def __init__(self, n, seed, field, spec, mod):
        pre, post = mod.get_dims(n, float(field.num_bits - 1), spec)
        self.field, self.spec, self.n_per_row = field, spec, n
        self.codeword_len = (n + post[-1][0] + sum(m for _, m, _ in pre[:-1])
                             + sum(m for _, m, _ in post))


@pytest.mark.parametrize("log2", [11, 21, 25])
@pytest.mark.parametrize("name", ["ft63", "ft255"])
def test_dims_and_soundness_match_reference(log2, name, monkeypatch):
    spec, jspec = FIELDS[name], jax_field.FIELDS[name]
    monkeypatch.setattr(jax_bd, "ExpanderEncoder",
                        lambda n, seed, f, c: _DimsOnly(n, seed, f, c, jax_ex))
    monkeypatch.setattr(port_bd.ExpanderEncoder, "build",
                        staticmethod(lambda n, seed, f, c: _DimsOnly(n, seed, f, c, ex)))
    for make, jmake in ((BrakedownEncoding.new, jax_bd.BrakedownEncoding.new),
                        (BrakedownEncoding.new_ml, jax_bd.BrakedownEncoding.new_ml)):
        arg = 1 << log2 if make == BrakedownEncoding.new else log2
        enc, jenc = make(arg, 0, spec), jmake(arg, 0, jspec)
        assert enc.get_dims(1 << log2) == jenc.get_dims(1 << log2)
        assert enc.get_n_col_opens() == jenc.get_n_col_opens()
        assert enc.get_n_degree_tests() == jenc.get_n_degree_tests()
    if (log2, name) == (21, "ft255"):
        enc = BrakedownEncoding.new(1 << 21, 0, spec)
        assert enc.get_dims(1 << 21) == (18, 117587, 178850)
        assert (enc.get_n_col_opens(), enc.get_n_degree_tests()) == (6593, 1)
    if (log2, name) == (25, "ft255"):
        assert BrakedownEncoding.new(1 << 25, 0, spec).get_dims(1 << 25)[:2] == (143, 235172)


def test_real_dims_at_2_11_match_reference():
    """At 2^11 with matgen: the built codes have the solver's dims."""
    enc = BrakedownEncoding.new_ml(11, seed=1, field=FT63)
    jenc = jax_bd.BrakedownEncoding.new_ml(11, seed=1, field=jax_field.FT63)
    assert enc.get_dims(1 << 11) == jenc.get_dims(1 << 11)
    n_rows, n_per_row, _ = enc.get_dims(1 << 11)
    assert n_rows * n_per_row == 1 << 11 and n_per_row & (n_per_row - 1) == 0


def test_new_from_dims_checks_the_code():
    """new_from_dims builds the code of its n_per_row and rejects a column
    count that code does not have."""
    enc = BrakedownEncoding.new_from_dims(512, 779, 7, FT63)
    assert enc.get_dims(512) == BrakedownEncoding.new(512, seed=7, field=FT63).get_dims(512)
    with pytest.raises(ValueError):
        BrakedownEncoding.new_from_dims(512, 780, 7, FT63)
