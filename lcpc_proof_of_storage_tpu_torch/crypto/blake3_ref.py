"""Blake3 hash, pure-Python host reference implementation.

The reference uses blake3 as the column/Merkle digest (blake3 1.5 crate via
digest traits; lcpc-2d/src/lib.rs:736-815, proof-of-storage Blake3 alias in
src/lib.rs:19-24).  This host implementation hashes the verifier's Merkle path
folds where the native library is not built, and is the oracle for the
column hash of ops/blake3.py (plain version and kernel K2).

Only the default (unkeyed) hash mode with 32-byte output is needed.
"""

from __future__ import annotations

import struct

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

BLOCK_LEN = 64
CHUNK_LEN = 1024
MASK32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def compress(cv: tuple[int, ...], block_words: tuple[int, ...], counter: int,
             block_len: int, flags: int) -> list[int]:
    """The Blake3 compression function; returns all 16 output words."""
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & MASK32, (counter >> 32) & MASK32, block_len, flags,
    ]
    m = list(block_words)
    for rnd in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if rnd < 6:
            m = [m[p] for p in MSG_PERMUTATION]
    out = [0] * 16
    for i in range(8):
        out[i] = state[i] ^ state[i + 8]
        out[i + 8] = state[i + 8] ^ cv[i]
    return out


def _words_of(block: bytes) -> tuple[int, ...]:
    block = block.ljust(BLOCK_LEN, b"\x00")
    return struct.unpack("<16I", block)


def _chunk_cv(chunk: bytes, chunk_counter: int, is_only_chunk: bool) -> tuple[int, ...]:
    """Chaining value of one (≤1024-byte) chunk.  If the chunk is the whole
    message, the caller handles the ROOT flag instead via _root_output."""
    cv = IV
    nblocks = max(1, (len(chunk) + BLOCK_LEN - 1) // BLOCK_LEN)
    for i in range(nblocks):
        block = chunk[i * BLOCK_LEN : (i + 1) * BLOCK_LEN]
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == nblocks - 1:
            flags |= CHUNK_END
            if is_only_chunk:
                flags |= ROOT
        out = compress(cv, _words_of(block), chunk_counter, len(block), flags)
        cv = tuple(out[:8])
    return cv


def _parent_cv(left: tuple[int, ...], right: tuple[int, ...], is_root: bool) -> tuple[int, ...]:
    block = left + right
    flags = PARENT | (ROOT if is_root else 0)
    out = compress(IV, block, 0, BLOCK_LEN, flags)
    return tuple(out[:8])


def _hash_subtree(data: bytes, chunk_counter: int) -> tuple[int, ...]:
    """CV of a subtree spanning >= 1 chunk, never the root."""
    if len(data) <= CHUNK_LEN:
        return _chunk_cv(data, chunk_counter, False)
    # left subtree gets the largest power-of-two number of chunks < total
    nchunks = (len(data) + CHUNK_LEN - 1) // CHUNK_LEN
    left_chunks = 1 << (nchunks - 1).bit_length() - 1
    left_chunks = max(1, left_chunks)
    split = left_chunks * CHUNK_LEN
    left = _hash_subtree(data[:split], chunk_counter)
    right = _hash_subtree(data[split:], chunk_counter + left_chunks)
    return _parent_cv(left, right, False)


def blake3(data: bytes) -> bytes:
    """Blake3 hash (default mode, 32-byte output).

    Uses the C++ host library when it is built (``native/``); falls back to
    the pure-Python spec implementation (blake3_py below), which is also
    the cross-check oracle."""
    from ..native import blake3_native
    out = blake3_native(bytes(data))
    if out is not None:
        return out
    return blake3_py(data)


def blake3_py(data: bytes) -> bytes:
    """Pure-Python Blake3 (spec reference implementation)."""
    if len(data) <= CHUNK_LEN:
        cv = _chunk_cv(data, 0, True)
        return struct.pack("<8I", *cv)
    nchunks = (len(data) + CHUNK_LEN - 1) // CHUNK_LEN
    left_chunks = 1 << (nchunks - 1).bit_length() - 1
    left_chunks = max(1, left_chunks)
    split = left_chunks * CHUNK_LEN
    left = _hash_subtree(data[:split], 0)
    right = _hash_subtree(data[split:], left_chunks)
    cv = _parent_cv(left, right, True)
    return struct.pack("<8I", *cv)


class Blake3Hasher:
    """Incremental wrapper mirroring digest::Digest usage in the reference."""

    def __init__(self):
        self._buf = bytearray()

    def update(self, data: bytes) -> "Blake3Hasher":
        self._buf += data
        return self

    def finalize(self) -> bytes:
        return blake3(bytes(self._buf))

    def finalize_reset(self) -> bytes:
        out = blake3(bytes(self._buf))
        self._buf = bytearray()
        return out
