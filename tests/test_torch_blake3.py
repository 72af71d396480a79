"""Port Blake3 leaves and Merkle parents (plain PyTorch) against the JAX
package's ops.blake3_jax and the byte-level crypto.blake3_ref.  Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.crypto.blake3_ref import blake3
from lcpc_proof_of_storage_tpu.fields.field import (FT63, FT127, FT191, FT253_192, FT255,
                                                    ints_to_limbs)
from lcpc_proof_of_storage_tpu.ops import blake3_jax
from lcpc_proof_of_storage_tpu_torch.ops.blake3 import (bytes_to_digest, digest_to_bytes,
                                                        digests_to_bytes, hash_columns,
                                                        hash_columns_plain,
                                                        merkle_parents_plain)

torch.set_num_threads(1)


def _matrix(spec, rows, cols, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(rows * cols)]
    return vals, ints_to_limbs(vals, spec).reshape(rows, cols, -1)


@pytest.mark.parametrize("spec,rows,cols", [
    (FT63, 1, 6),          # one block
    (FT63, 300, 5),        # 2432-byte messages: 3 chunks
    (FT255, 70, 3),        # 2272 bytes: 3 chunks, left-leaning merge
    (FT255, 31, 2),        # exactly one 1024-byte chunk
    (FT253_192, 33, 4),    # big-endian reprs, 2 chunks
    (FT127, 70, 3),        # 1152 bytes: 2 chunks
    (FT191, 50, 2),        # 1232 bytes: 2 chunks
], ids=["ft63-1row", "ft63-3chunks", "ft255-3chunks", "ft255-1chunk", "ft253_192-be",
        "ft127-2chunks", "ft191-2chunks"])
def test_hash_columns_plain_matches_reference(spec, rows, cols):
    _, m = _matrix(spec, rows, cols, rows)
    want = np.asarray(blake3_jax.hash_columns(jnp.asarray(m), spec)).view(np.int32)
    got = hash_columns(torch.from_numpy(m.astype(np.int32)), spec)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_leaf_matches_blake3_bytes():
    vals, m = _matrix(FT253_192, 40, 2, 11)
    got = digests_to_bytes(hash_columns_plain(torch.from_numpy(m.astype(np.int32)), FT253_192))
    for c in range(2):
        msg = b"\x00" * 32 + b"".join(FT253_192.to_repr(vals[r * 2 + c]) for r in range(40))
        assert got[c] == blake3(msg)


def test_merkle_parents_plain_matches_reference():
    rng = np.random.default_rng(5)
    nodes = rng.integers(0, 1 << 32, size=(64, 8), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(blake3_jax.merkle_parents(jnp.asarray(nodes))).view(np.int32)
    got = merkle_parents_plain(torch.from_numpy(nodes.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    left, right = digests_to_bytes(torch.from_numpy(nodes[:2].view(np.int32)))
    assert digest_to_bytes(merkle_parents_plain(torch.from_numpy(nodes[:2].view(np.int32)))[0]) \
        == blake3(left + right)


def test_digest_bytes_round_trip():
    d = bytes(range(32))
    assert digest_to_bytes(bytes_to_digest(d)) == d
    assert bytes_to_digest(d).dtype == torch.int32
