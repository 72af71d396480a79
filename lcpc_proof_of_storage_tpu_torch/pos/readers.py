"""file -> field-element read-path family.

Mirrors the reference's four read paths (proof-of-storage/src/fields.rs:26-105
and :122-127): whole-file read, sync buffered stream, async buffered stream,
and path-based read — all of which must agree element-for-element
(fields.rs tests `stream_and_read_agree*`, :302-357).  Elements are 16-bit
limb rows (uint32, trailing axis L), this framework's canonical host format.

Also carries the byte/element iterator helpers
(fields/field_generator_iter.rs, fields/random_byte_iterator.rs) and the
vec<->file converters (fields.rs:107-146).
"""

from __future__ import annotations

import os
from typing import BinaryIO, Iterable, Iterator

import numpy as np

from ..fields.field import FieldSpec
from .storage import data_bytes_to_limbs_np, limbs_to_data_bytes_np

#: sync/async stream buffer size in elements (fields.rs:42 BUF_MULT)
BUF_MULT = 1000


def read_file_to_field_elements(f: BinaryIO, spec: FieldSpec):
    """Whole-file read -> (file_size, (n, L) limbs) (fields.rs:26-35)."""
    data = f.read()
    return len(data), data_bytes_to_limbs_np(data, spec)


def stream_file_to_field_elements_sync(f: BinaryIO, spec: FieldSpec,
                                       buf_mult: int = BUF_MULT):
    """Buffered streaming read -> (file_size, (n, L) limbs)
    (fields.rs:73-105).  Reads buf_mult elements' worth of bytes per chunk;
    the final partial element is zero-padded, as the reference's fixed
    DataBytes buffer does (fields.rs:93-97)."""
    chunk_bytes = buf_mult * spec.data_byte_capacity
    parts: list[np.ndarray] = []
    size = 0
    while True:
        chunk = f.read(chunk_bytes)
        if not chunk:
            break
        size += len(chunk)
        parts.append(data_bytes_to_limbs_np(chunk, spec))
    if not parts:
        return 0, np.empty((0, spec.num_limbs16), np.uint32)
    return size, np.concatenate(parts, axis=0)


async def stream_file_to_field_elements_async(path: str | os.PathLike,
                                              spec: FieldSpec,
                                              buf_mult: int = BUF_MULT):
    """Async streaming read -> (file_size, (n, L) limbs) (fields.rs:37-71).

    tokio::fs offloads file IO to a blocking pool; asyncio's analogue is
    run_in_executor per chunk, keeping the event loop free."""
    import asyncio

    loop = asyncio.get_running_loop()
    chunk_bytes = buf_mult * spec.data_byte_capacity
    f = await loop.run_in_executor(None, lambda: open(path, "rb"))
    try:
        parts: list[np.ndarray] = []
        size = 0
        while True:
            chunk = await loop.run_in_executor(None, f.read, chunk_bytes)
            if not chunk:
                break
            size += len(chunk)
            parts.append(data_bytes_to_limbs_np(chunk, spec))
    finally:
        await loop.run_in_executor(None, f.close)
    if not parts:
        return 0, np.empty((0, spec.num_limbs16), np.uint32)
    return size, np.concatenate(parts, axis=0)


def read_file_path_to_field_elements(path: str | os.PathLike,
                                     spec: FieldSpec) -> np.ndarray:
    """Path-based whole read (fields.rs:122-127)."""
    with open(path, "rb") as f:
        _, limbs = read_file_to_field_elements(f, spec)
    return limbs


def field_elements_to_file(path: str | os.PathLike, limbs: np.ndarray,
                           spec: FieldSpec) -> None:
    """Write elements' data bytes; trailing zero bytes of the LAST element
    are dropped (fields.rs:128-146) so a read round-trips byte-exactly for
    data that doesn't end in zeros."""
    data = limbs_to_data_bytes_np(np.asarray(limbs, np.uint32), spec)
    data = data.rstrip(b"\x00") if len(limbs) else b""
    with open(path, "wb") as f:
        f.write(data)


class RandomBytesIterator:
    """Endless pseudo-random byte iterator
    (fields/random_byte_iterator.rs)."""

    def __init__(self, seed: int | None = None):
        self._rng = np.random.default_rng(seed)
        self._buf = b""
        self._pos = 0

    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        if self._pos >= len(self._buf):
            self._buf = self._rng.integers(0, 256, size=4096,
                                           dtype=np.uint8).tobytes()
            self._pos = 0
        b = self._buf[self._pos]
        self._pos += 1
        return b

    def take_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            if self._pos >= len(self._buf):
                self._buf = self._rng.integers(0, 256, size=max(4096, n),
                                               dtype=np.uint8).tobytes()
                self._pos = 0
            need = n - len(out)
            out += self._buf[self._pos : self._pos + need]
            self._pos += min(need, len(self._buf) - self._pos)
        return bytes(out)


class FieldGeneratorIter:
    """bytes iterator -> field-element iterator
    (fields/field_generator_iter.rs): consumes DATA_BYTE_CAPACITY bytes per
    element, zero-padding the final partial chunk.  Yields (L,) limb rows."""

    def __init__(self, byte_iter: Iterable[int], spec: FieldSpec):
        self._it = iter(byte_iter)
        self._spec = spec
        self._done = False

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._done:
            raise StopIteration
        cap = self._spec.data_byte_capacity
        chunk = bytearray()
        for _ in range(cap):
            try:
                chunk.append(next(self._it))
            except StopIteration:
                self._done = True
                break
        if not chunk:
            raise StopIteration
        return data_bytes_to_limbs_np(bytes(chunk), self._spec)[0]


def random_writeable_field_vec(log_len: int, spec: FieldSpec,
                               seed: int | None = None) -> np.ndarray:
    """(2^log_len, L) random data-safe elements (fields.rs:148-160)."""
    rbi = RandomBytesIterator(seed)
    data = rbi.take_bytes(spec.data_byte_capacity * (1 << log_len))
    return data_bytes_to_limbs_np(data, spec)
