"""The port's own host copies (crypto/, fields/field.py, utils/serde.py,
native/) against the JAX package's modules they were copied from.

Each check runs twice: with the port's C++ host library, and with the
library switched off so the pure-Python and numpy fallbacks run.  The
reference side keeps its own library.  Inputs come from
np.random.default_rng; every comparison is byte equality.
"""

import json

import numpy as np
import pytest

from lcpc_proof_of_storage_tpu.crypto import blake3_ref as jax_blake3
from lcpc_proof_of_storage_tpu.crypto import chacha as jax_chacha
from lcpc_proof_of_storage_tpu.crypto import keccak as jax_keccak
from lcpc_proof_of_storage_tpu.crypto.transcript import Transcript as JaxTranscript
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.utils import serde as jax_serde
from lcpc_proof_of_storage_tpu_torch import native
from lcpc_proof_of_storage_tpu_torch.crypto import blake3_ref, chacha, keccak
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import field
from lcpc_proof_of_storage_tpu_torch.utils import serde


@pytest.fixture(params=["native", "fallback"])
def host(request, monkeypatch):
    """Run the test with the port's host library, then without it."""
    if request.param == "native":
        assert native.native() is not None, "the host library did not build"
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        assert native.native() is None
    return request.param


def test_transcript_matches_reference(host):
    rng = np.random.default_rng(1)
    tr, jtr = Transcript(b"parity"), JaxTranscript(b"parity")
    for i in range(4):
        msg = rng.bytes(int(rng.integers(0, 300)))
        for t in (tr, jtr):
            t.append_message(b"m%d" % i, msg)
            t.append_u64(b"u", i * 0x1234567)
        assert tr.challenge_bytes(b"c", 64) == jtr.challenge_bytes(b"c", 64)
    batch = rng.bytes(32 * 50)
    tr.append_messages_batch(b"row", batch, 32, 50)
    jtr.append_messages_batch(b"row", batch, 32, 50)
    assert tr.clone().state_bytes() == jtr.state_bytes()
    assert tr.challenge_bytes(b"end", 32) == jtr.challenge_bytes(b"end", 32)
    assert type(tr.strobe).__name__ == ("NativeStrobe" if host == "native" else "Strobe128")


def test_chacha_matches_reference(host):
    rng = np.random.default_rng(2)
    seed = rng.bytes(32)
    for rounds in (20, 8):
        a, b = chacha.ChaChaRng(seed, rounds), jax_chacha.ChaChaRng(seed, rounds)
        a.set_stream(7)
        b.set_stream(7)
        assert a.next_u32() == b.next_u32()
        assert (a.next_u64_array(300) == b.next_u64_array(300)).all()
        assert a.fill_bytes(77) == b.fill_bytes(77)
        assert (a.peek_u64_array(5000) == b.peek_u64_array(5000)).all()
    assert chacha.seed_from_u64(0xDEADBEEF) == jax_chacha.seed_from_u64(0xDEADBEEF)
    r1 = chacha.ChaChaRng(seed, 20)
    r2 = jax_chacha.ChaChaRng(seed, 20)
    assert ([chacha.UniformUsize(0, 178850).sample(r1) for _ in range(50)]
            == [jax_chacha.UniformUsize(0, 178850).sample(r2) for _ in range(50)])
    assert chacha.choose_multiple(r1, 1000, 9) == jax_chacha.choose_multiple(r2, 1000, 9)


def test_field_random_matches_reference(host):
    for name in ("ft63", "ft255", "ft253_192"):
        spec, jspec = field.FIELDS[name], jax_field.FIELDS[name]
        assert (spec.montgomery_r_inv, spec.root_of_unity) == (
            jspec.montgomery_r_inv, jspec.root_of_unity)
        seed = bytes(range(32))
        got = spec.random_vec(chacha.ChaChaRng(seed, 20), 40)
        assert got == jspec.random_vec(jax_chacha.ChaChaRng(seed, 20), 40)
        assert np.array_equal(field.ints_to_limbs(got, spec), jax_field.ints_to_limbs(got, jspec))
        assert field.limbs_to_ints(field.ints_to_limbs(got, spec)) == got


def test_blake3_and_keccak_match_reference(host):
    rng = np.random.default_rng(3)
    for n in (0, 1, 64, 65, 1024, 1025, 2048, 5000):
        data = rng.bytes(n)
        assert blake3_ref.blake3(data) == jax_blake3.blake3(data) == blake3_ref.blake3_py(data)
    state = bytearray(rng.bytes(200))
    jstate = bytearray(state)
    keccak.keccak_f1600_bytes(state)
    jax_keccak.keccak_f1600_bytes(jstate)
    assert state == jstate
    assert keccak.sha3_256(b"abc") == jax_keccak.sha3_256(b"abc")


@pytest.fixture(scope="module")
def proofs():
    """A port Ligero ft63 proof; the bincode bytes the reference's serde
    writes for it, and the reference's parse of those bytes."""
    from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
    from lcpc_proof_of_storage_tpu_torch.core import commit as port

    rng = np.random.default_rng(4)
    spec = field.FT63
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=300)]
    enc = LigeroEncoding.new_from_dims(16, 64, spec)
    comm = port.commit(coeffs, enc, device="cpu")
    tr = Transcript(b"serde")
    tr.append_message(b"polycommit", comm.get_root().root)
    proof = port.prove(comm, [int(v) for v in rng.integers(1, 1 << 60, size=comm.n_rows)],
                       enc, tr)
    blob = jax_serde.serialize_proof(proof, jax_field.FT63)
    return proof, blob, jax_serde.deserialize_proof(blob, jax_field.FT63)


def test_serde_matches_reference(proofs, host):
    mine, blob, jproof = proofs
    spec = field.FT63
    assert serde.serialize_proof(mine, spec) == blob
    proof = serde.deserialize_proof(blob, spec)
    assert serde.serialize_proof(proof, spec) == blob
    assert json.dumps(serde.proof_to_json(proof, spec), sort_keys=True) == json.dumps(
        jax_serde.proof_to_json(jproof, jax_field.FT63), sort_keys=True)
    back = serde.proof_from_json(serde.proof_to_json(proof, spec), spec)
    assert serde.serialize_proof(back, spec) == blob
    col = serde.serialize_column(proof.columns[2], spec)
    assert col == jax_serde.serialize_column(jproof.columns[2], jax_field.FT63)
    assert serde.deserialize_column(col, spec).col == jproof.columns[2].col
    with pytest.raises(ValueError):
        serde.deserialize_proof(blob[:8] + (1 << 40).to_bytes(8, "little") + blob[16:], spec)
