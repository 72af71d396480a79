"""The plain reference agrees with the program at small sizes, piece by
piece: the transcript, ChaCha and its samplers, BLAKE3 and the Merkle tree,
and each code's encoding of a row."""

from __future__ import annotations

import os
import random

import numpy as np
import pytest
import torch

import bench_fixture  # noqa: F401  (puts the benchmark on sys.path)
from reference import blake3, brakedown, chacha, field, ligero, transcript

F = field.FIELDS["ft255"]


def test_transcript_matches_the_programs():
    from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
    a, b = transcript.Transcript(b"t"), Transcript(b"t")
    rnd = random.Random(1)
    for t in (a, b):
        t.append_message(b"polycommit", bytes(32))
    for n in (0, 1, 31, 165, 166, 167, 500):
        msg = bytes(rnd.randrange(256) for _ in range(n))
        a.append_message(b"m", msg)
        b.append_message(b"m", msg)
        assert a.challenge_bytes(b"c", 32) == b.challenge_bytes(b"c", 32)
    msgs = os.urandom(32 * 700)
    a.append_messages(b"$l//PR", msgs, 32)
    b.append_messages_batch(b"$l//PR", msgs, 32, 700)
    assert a.challenge_bytes(b"$l//CO", 32) == b.challenge_bytes(b"$l//CO", 32)


def test_transcript_at_every_block_position():
    """A PRF whose op bytes end a block reads the state as it is: the Python
    sponge does, OpenSSL's cannot and says so (proof.replay then takes the
    Python one)."""
    from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
    boundary = 0
    for n in range(170):
        msg = bytes(range(256))[:n] * 1
        theirs, slow = Transcript(b"t"), transcript.Transcript(b"t", transcript.PySponge())
        fast = transcript.Transcript(b"t")
        for t in (theirs, slow, fast):
            t.append_message(b"m", msg)
        want = theirs.challenge_bytes(b"c", 32)
        assert slow.challenge_bytes(b"c", 32) == want, n
        try:
            assert fast.challenge_bytes(b"c", 32) == want, n
        except NotImplementedError:
            boundary += 1
    assert boundary


def test_chacha_and_samplers_match_the_programs():
    from lcpc_proof_of_storage_tpu_torch.crypto.chacha import ChaChaRng, UniformUsize
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    seed = bytes(range(32))
    mine, theirs = chacha.ChaCha(seed), ChaChaRng(seed, 20)
    assert list(mine.u64s(300)) == [theirs.next_u64() for _ in range(300)]
    mine, theirs = chacha.ChaCha(seed), ChaChaRng(seed, 20)
    assert chacha.field_random(mine, F.modulus, 50) == FT255.random_vec(theirs, 50)
    mine, theirs = chacha.ChaCha(seed), ChaChaRng(seed, 20)
    dist = UniformUsize(0, 1 << 19)
    assert chacha.uniform_below(mine, 1 << 19, 189) == [dist.sample(theirs) for _ in range(189)]
    from lcpc_proof_of_storage_tpu_torch.crypto.chacha import seed_from_u64
    assert chacha.seed_from_u64(12345) == seed_from_u64(12345)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1024, 1025, 4608, 65568])
def test_blake3_matches_the_programs(n):
    from lcpc_proof_of_storage_tpu_torch.crypto.blake3_ref import blake3 as theirs
    data = random.Random(n).randbytes(n)
    assert blake3.hash_bytes(data) == theirs(data)


def _coeffs(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(0, 1 << 16, (n, 16), generator=g, dtype=torch.int32)
    c[:, 15] = torch.randint(0, F.modulus >> 240, (n,), generator=g, dtype=torch.int32)
    return c


@pytest.mark.parametrize("code", ["ligero", "brakedown"])
def test_encoding_and_root_match_the_programs(code):
    from lcpc_proof_of_storage_tpu_torch import BrakedownEncoding, LigeroEncoding, commit
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    n = 1 << 13
    if code == "ligero":
        enc = LigeroEncoding.new(n, FT255, rho=(1, 4))
        ref = ligero.Code({"rho": [1, 4], "log2_coeffs": 13}, F)
    else:
        enc = BrakedownEncoding.new(n, seed=0, field=FT255)
        ref = brakedown.Code({"code": "sdig3", "code_seed": 0, "log2_coeffs": 13}, F)
    dims = enc.get_dims(n)
    assert tuple(ref.dims) == dims
    assert (ref.n_col_opens, ref.n_degree_tests) == (enc.get_n_col_opens(),
                                                     enc.get_n_degree_tests())
    c = _coeffs(n, 3)
    comm = commit(c, enc, device="cpu")
    rows = torch.cat([c, c.new_zeros(dims[0] * dims[1] - n, 16)]).reshape(dims[0], dims[1], 16)
    for r in range(dims[0]):
        want = field.limbs_to_ints(comm.comm[r].numpy())
        assert ref.encode_row(field.limbs_to_ints(rows[r].numpy())) == want
    levels = blake3.merkle_levels(blake3.column_leaves(comm.comm, F.repr_bytes))
    assert blake3.digest_bytes(levels[-1][0]) == comm.get_root().root


def test_row_sums_are_exact():
    rnd = random.Random(5)
    mat = _coeffs(6 * 40, 9).reshape(6, 40, 16)
    ints = [field.limbs_to_ints(mat[r].numpy()) for r in range(6)]
    w = [rnd.randrange(F.modulus) for _ in range(6)]
    assert field.combine_rows(w, mat, F, block=7) == [
        sum(w[i] * ints[i][c] for i in range(6)) % F.modulus for c in range(40)]
    v = [[rnd.randrange(F.modulus) for _ in range(40)] for _ in range(3)]
    assert field.row_dots(mat, v, F, block=4) == [
        [sum(a * b for a, b in zip(ints[i], vk)) % F.modulus for i in range(6)] for vk in v]
    big = mat.clone()
    big[0, 0] = torch.tensor(field.ints_to_limbs([F.modulus + 1], F)[0], dtype=torch.int32)
    assert field.noncanonical(big, F) == 1 and field.noncanonical(mat, F) == 0
    assert np.all(field.ints_to_limbs(field.limbs_to_ints(mat[0].numpy()), F) == mat[0].numpy())
