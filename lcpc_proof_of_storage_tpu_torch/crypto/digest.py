"""Digest genericity for the polynomial commitment: digests hashed on the host.

A copy of the JAX package's ``crypto/digest.py``.  lcpc-2d is generic over
the digest (``LcCommit<D, E>``, lcpc-2d/src/lib.rs:174-191), and the
reference's microbenchmarks also ran Blake2b.  Blake3 is the production
digest, hashed on the device by kernel K2 (and on the host by
``crypto/blake3_ref.py`` where a verifier folds one path); any other digest
(here: Blake2b) hashes on the host while the encode stays on the device
(``core/commit.py commit(..., digest=)``).

A digest gives 32-byte outputs: the wire format, the Merkle array layout
and the serde's fixed-width paths all assume them, as the reference's
``Output<D>`` instantiations do.  The batched forms run in the port's C++
host library (``native/``) where it is built, and fall back to ``hashlib``
with the same bytes where it is not.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import native
from ..fields.field import FieldSpec
from ..fields.limb import narrow_limbs


class HostDigest:
    """A 32-byte-output digest computed on the host."""

    def __init__(self, name: str, fn, many_fn=None, layers_fn=None):
        self.name = name
        self._fn = fn
        self._many_fn = many_fn
        self._layers_fn = layers_fn

    def hash(self, msg: bytes) -> bytes:
        out = self._fn(msg)
        assert len(out) == 32
        return out

    def hash_many(self, msgs: np.ndarray) -> np.ndarray:
        """(k, n) uint8 equal-length messages -> (k, 32) uint8 digests: one
        native call where the library is built, else one call a message."""
        if self._many_fn is not None:
            out = self._many_fn(msgs)
            if out is not None:
                return out
        out = np.empty((msgs.shape[0], 32), np.uint8)
        for i in range(msgs.shape[0]):
            out[i] = np.frombuffer(self._fn(msgs[i].tobytes()), np.uint8)
        return out

    def merkle_layers(self, nodes: np.ndarray) -> None:
        """Fill the layers of a (2 np2 - 1, 32) uint8 Merkle array in place
        from its np2 leaves: in one native call where the library is built,
        else a layer at a time through :meth:`hash_many`."""
        if self._layers_fn is not None and self._layers_fn(nodes):
            return
        start, width = 0, (nodes.shape[0] + 1) // 2
        while width > 1:
            pairs = nodes[start:start + width].reshape(width // 2, 64)
            nodes[start + width:start + width + width // 2] = self.hash_many(pairs)
            start, width = start + width, width // 2


BLAKE2B = HostDigest("blake2b", lambda m: hashlib.blake2b(m, digest_size=32).digest(),
                     many_fn=native.blake2b_many_native,
                     layers_fn=native.blake2b_merkle_layers_native)

_DIGESTS = {"blake2b": BLAKE2B}


def get_digest(name: str) -> HostDigest:
    try:
        return _DIGESTS[name]
    except KeyError:
        raise ValueError(f"unknown digest {name!r}; have {sorted(_DIGESTS)}") from None


def limbs_to_repr_bytes(limbs, spec: FieldSpec) -> torch.Tensor:
    """(..., L) canonical 16-bit limbs (a tensor on any device, or an array)
    -> (..., 2L) uint8 repr bytes on the same device: the little-endian limb
    buffer, each value's bytes reversed for a big-endian field."""
    if isinstance(limbs, np.ndarray):
        limbs = torch.from_numpy(limbs.astype(np.int32))
    le = narrow_limbs(limbs).contiguous().view(torch.uint8)
    return le.flip(-1) if spec.endianness == "big" else le


def column_messages(comm, spec: FieldSpec) -> np.ndarray:
    """(rows, n_cols, L) limbs (a tensor on any device, or an array) ->
    (n_cols, 32 + rows W) uint8 host messages 0^32 || column reprs, laid out
    where the limbs are (one transposed 16-bit copy) and read back once."""
    if isinstance(comm, np.ndarray):
        comm = torch.from_numpy(comm.astype(np.int32))
    reprs = limbs_to_repr_bytes(comm.transpose(0, 1), spec)              # (n_cols, rows, W)
    n_cols = reprs.shape[0]
    msgs = torch.zeros((n_cols, 32 + reprs[0].numel()), dtype=torch.uint8, device=reprs.device)
    msgs[:, 32:] = reprs.reshape(n_cols, -1)
    return msgs.cpu().numpy()


def column_leaves_host(comm, spec: FieldSpec, d: HostDigest) -> np.ndarray:
    """(rows, n_cols, L) limbs -> (n_cols, 32) uint8 leaf digests
    H(0^32 || column reprs) hashed on the host, the counterpart of K2's
    column leaves (lcpc-2d/src/lib.rs:752-763)."""
    return d.hash_many(column_messages(comm, spec))


def merkle_tree_host(leaves: np.ndarray, n_cols: int, d: HostDigest,
                     device=None) -> torch.Tensor:
    """The Merkle array over (n_cols, 32) uint8 leaves with the reference's
    layout and zero-digest padding (lib.rs:685-694): [leaves padded to np2]
    ++ layers ++ [root], as the (2 np2 - 1, 8) int32 words K2's tree gives,
    on `device` (default: the CPU)."""
    np2 = 1 if n_cols <= 1 else 1 << (n_cols - 1).bit_length()
    nodes = np.zeros((2 * np2 - 1, 32), np.uint8)
    nodes[:n_cols] = leaves
    d.merkle_layers(nodes)
    words = torch.from_numpy(nodes.view("<u4").view(np.int32).reshape(-1, 8))
    return words if device is None else words.to(device)
