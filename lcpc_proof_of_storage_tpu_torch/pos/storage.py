"""Proof-of-storage on-disk layer: column-major encoded files, streaming
commitment, incremental column digests, standalone Merkle tree.

Counterpart of ``lcpc_proof_of_storage_tpu/pos/storage.py`` (itself a
re-creation of proof-of-storage/src/lcpc_online/{encoded_file_writer,
encoded_file_reader,column_digest_accumulator,merkle_tree,
encoded_file_metadata,file_formatter}.rs), with the device work on the
card:

  * rows are encoded in device batches by :func:`ops.ntt.encode_rows`
    (kernel K1) and decoded by :func:`ops.ntt.decode_rows` (K4's inverse
    entry);
  * every batch of encoded rows ends on a Blake3 chunk boundary of every
    column stream (32 zero bytes, then one repr a row), so the column
    digests are K2's chunk CVs of the batches merged at the end (K2's merge
    entry), and the Merkle layers are K2's parents;
  * the encoded batch is turned into column-major repr bytes on the device
    and written into the mapped file with one strided host copy.

The on-disk format is the reference's, byte for byte: column-major
``.porenc`` with column stride row_capacity * repr_bytes
(encoded_file_writer.rs:309-389), ``.portree`` the concatenated digests,
``.meta`` JSON metadata.  On CPU tensors every kernel step runs its plain
PyTorch version.
"""

from __future__ import annotations

import copy
import functools
import json
import mmap
import os
import secrets
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from ..core.commit import default_device
from ..crypto import blake3_ref as b3
from ..fields.field import FieldSpec
from ..ops.blake3 import (batch_chunks, chunk_cvs, digests_to_bytes, hash_columns, merge_cvs,
                          merkle_array, merkle_tree)
from ..ops.ntt import NttTables, decode_rows, encode_rows

# -- constants (databases/constants.rs:1-5) ---------------------------------

SERVER_FILE_FOLDER = "PoR_server_files"
UNENCODED_FILE_EXTENSION = "porraw"
ENCODED_FILE_EXTENSION = "porenc"
MERKLE_FILE_EXTENSION = "portree"
METADATA_FILE_EXTENSION = "meta"

#: int32 limbs of encoded rows in one device batch of the writer and readers
BATCH_BYTES = 1 << 28


# -- ulid -------------------------------------------------------------------

_B32 = "0123456789ABCDEFGHJKMNPQRSTVWXYZ"


def new_ulid() -> str:
    """Crockford-base32 ULID (ulid crate equivalent)."""
    ts = int(time.time() * 1000) & ((1 << 48) - 1)
    rand = secrets.randbits(80)
    v = (ts << 80) | rand
    return "".join(_B32[(v >> (5 * (25 - i))) & 31] for i in range(26))


# -- file formatter (file_formatter.rs) -------------------------------------

def server_dir(base: Path | None = None) -> Path:
    d = (base or Path.cwd()) / SERVER_FILE_FOLDER
    d.mkdir(parents=True, exist_ok=True)
    return d


def file_paths(ulid: str, base: Path | None = None) -> dict[str, Path]:
    d = server_dir(base)
    return {
        "raw": d / f"{ulid}.{UNENCODED_FILE_EXTENSION}",
        "enc": d / f"{ulid}.{ENCODED_FILE_EXTENSION}",
        "tree": d / f"{ulid}.{MERKLE_FILE_EXTENSION}",
        "meta": d / f"{ulid}.{METADATA_FILE_EXTENSION}",
    }


# -- metadata (encoded_file_metadata.rs) ------------------------------------

@dataclass
class EncodedFileMetadata:
    ulid: str
    pre_encoded_size: int
    encoded_size: int
    rows_written: int
    row_capacity: int
    bytes_of_data: int

    def write_to_file(self, path: Path) -> None:
        path.write_text(json.dumps(asdict(self)))

    @classmethod
    def read_from_file(cls, path: Path) -> "EncodedFileMetadata":
        return cls(**json.loads(path.read_text()))


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


# -- field element <-> bytes, numpy (host) ----------------------------------

def limbs_to_repr_bytes_np(limbs: np.ndarray, spec: FieldSpec) -> np.ndarray:
    """(..., L) limbs -> (..., W) uint8 canonical repr bytes."""
    limbs = np.asarray(limbs)
    le = np.empty(limbs.shape[:-1] + (spec.repr_bytes,), np.uint8)
    le[..., 0::2] = limbs & 0xFF
    le[..., 1::2] = (limbs >> 8) & 0xFF
    if spec.endianness == "big":
        le = le[..., ::-1]
    return np.ascontiguousarray(le)


def repr_bytes_to_limbs_np(data: np.ndarray, spec: FieldSpec) -> np.ndarray:
    """(..., W) uint8 repr bytes -> (..., L) uint32 limbs."""
    if spec.endianness == "big":
        data = data[..., ::-1]
    return data[..., 0::2].astype(np.uint32) | (data[..., 1::2].astype(np.uint32) << 8)


def data_bytes_to_limbs_np(data: bytes | np.ndarray, spec: FieldSpec) -> np.ndarray:
    """Flat data bytes -> (n_elems, L) uint32 limbs (DataField::from_byte_vec):
    data_byte_capacity bytes an element, the last one zero-padded."""
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data
    cap = spec.data_byte_capacity
    n = ceildiv(len(arr), cap)
    padded = np.zeros(n * cap, np.uint8)
    padded[: len(arr)] = arr
    chunks = padded.reshape(n, cap)
    # little-endian bytes of the element value (BE fields read a chunk as a BE int)
    full = np.zeros((n, spec.repr_bytes), np.uint8)
    full[:, :cap] = chunks[:, ::-1] if spec.endianness == "big" else chunks
    return full[:, 0::2].astype(np.uint32) | (full[:, 1::2].astype(np.uint32) << 8)


def limbs_to_data_bytes_np(limbs: np.ndarray, spec: FieldSpec) -> bytes:
    """(n, L) limbs -> concatenated data bytes (field_vec_to_byte_vec)."""
    reprs = limbs_to_repr_bytes_np(limbs, spec)
    cap = spec.data_byte_capacity
    if spec.endianness == "little":
        return reprs[:, :cap].tobytes()
    return reprs[:, spec.repr_bytes - cap:].tobytes()


# -- the same conversions on any device (torch) -----------------------------

def data_bytes_to_limbs(data: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """:func:`data_bytes_to_limbs_np` of a flat uint8 tensor, on its device:
    -> (n_elems, L) int32 limbs."""
    cap = spec.data_byte_capacity
    n = ceildiv(data.numel(), cap)
    flat = torch.zeros(n * cap, dtype=torch.uint8, device=data.device)
    flat[: data.numel()] = data
    chunks = flat.view(n, cap)
    full = torch.zeros((n, spec.repr_bytes), dtype=torch.uint8, device=data.device)
    full[:, :cap] = chunks.flip(1) if spec.endianness == "big" else chunks
    return full[:, 0::2].to(torch.int32) | (full[:, 1::2].to(torch.int32) << 8)


def limbs_to_repr_bytes(limbs: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(..., L) int32 limbs -> (..., W) uint8 repr bytes, on their device."""
    le = torch.stack([limbs & 0xFF, (limbs >> 8) & 0xFF], dim=-1).to(torch.uint8)
    le = le.reshape(*limbs.shape[:-1], spec.repr_bytes)
    return le.flip(-1) if spec.endianness == "big" else le


def repr_bytes_to_limbs(data: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(..., W) uint8 repr bytes -> (..., L) int32 limbs, on their device."""
    if spec.endianness == "big":
        data = data.flip(-1)
    return data[..., 0::2].to(torch.int32) | (data[..., 1::2].to(torch.int32) << 8)


def bytes_tensor(data, device) -> torch.Tensor:
    """Bytes (or a bytearray) -> a flat uint8 tensor on `device`."""
    if not len(data):
        return torch.zeros(0, dtype=torch.uint8, device=device)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)


def limb_tensor(x) -> torch.Tensor:
    """Limbs given as a tensor or a host array -> a tensor (int32 where a
    host array is converted)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x).astype(np.int32))


@functools.lru_cache(maxsize=16)
def ntt_tables(spec: FieldSpec, n: int, device: torch.device) -> NttTables:
    """The NTT tables of one row length on one device, built once a process."""
    return NttTables(spec, n).to(device)


def encode_data(data, spec: FieldSpec, n_per_row: int, tables: NttTables) -> torch.Tensor:
    """Data bytes -> their (k, n_cols, L) encoded rows on the tables' device
    (K1 on CUDA): k = ceil(elements / n_per_row), at least 1, the last row
    zero-padded."""
    L = spec.num_limbs16
    limbs = data_bytes_to_limbs(bytes_tensor(data, tables.device), spec)
    k = max(1, ceildiv(limbs.shape[0], n_per_row))
    mat = limbs.new_zeros((k * n_per_row, L))
    mat[: limbs.shape[0]] = limbs
    return encode_rows(mat.view(k, n_per_row, L), spec, tables.n, tables)


# -- column-major file access (host) ----------------------------------------

@contextmanager
def _strided_view(fileobj, n_cols: int, stride_bytes: int, writable=False):
    """(n_cols, stride_bytes) uint8 page-cache view of a column-major encoded
    file, or None when it cannot be mapped (file shorter than the full
    column grid, zero length): callers then seek column by column."""
    flen = n_cols * stride_bytes
    mm = None
    try:
        fileobj.flush()
        if flen <= 0 or os.fstat(fileobj.fileno()).st_size < flen:
            yield None
            return
        mm = mmap.mmap(fileobj.fileno(), flen,
                       access=mmap.ACCESS_WRITE if writable else mmap.ACCESS_READ)
    except (OSError, ValueError):
        yield None
        return
    try:
        view = np.frombuffer(mm, np.uint8).reshape(n_cols, stride_bytes)
        if not writable:
            view.flags.writeable = False
        yield view
        del view
    finally:
        try:
            mm.close()
        except BufferError:
            # the caller's `with ... as view:` name still references the
            # array; the mapping closes when that last reference drops
            pass


def _read_columns(fileobj, n_cols: int, stride: int, b0: int, b1: int) -> np.ndarray:
    """(n_cols, b1 - b0) bytes [b0, b1) of every column of a column-major
    file with column stride `stride`."""
    out = np.empty((n_cols, b1 - b0), np.uint8)
    with _strided_view(fileobj, n_cols, stride) as view:
        if view is not None:
            out[:] = view[:, b0:b1]
            return out
    for c in range(n_cols):
        fileobj.seek(c * stride + b0)
        out[c] = np.frombuffer(fileobj.read(b1 - b0), np.uint8)
    return out


def _columns_to_rows(col_bytes: np.ndarray, count: int, spec: FieldSpec,
                     device: torch.device) -> torch.Tensor:
    """(n_cols, count * W) column-major bytes -> (count, n_cols, L) int32
    limbs on `device` (the transpose runs there)."""
    n_cols = col_bytes.shape[0]
    t = torch.from_numpy(col_bytes).to(device).view(n_cols, count, spec.repr_bytes)
    return repr_bytes_to_limbs(t, spec).permute(1, 0, 2).contiguous()


# -- chunk alignment of the column streams ----------------------------------

@functools.lru_cache(maxsize=None)
def _first_boundary(W: int) -> int:
    """The first row r >= 1 whose stream offset 32 + r * W is a multiple of
    1024: every batch but the last ends on such a row."""
    return next(r for r in range(1, 1025) if (32 + r * W) % 1024 == 0)


def _boundary_step(W: int) -> int:
    return 1024 // int(np.gcd(1024, W))


def chunk_row(chunk: int, W: int) -> int | None:
    """The row whose bytes start chunk `chunk` of a column stream, or None
    where the chunk starts inside a row."""
    if chunk == 0:
        return 0
    off = chunk * b3.CHUNK_LEN - 32
    return off // W if off % W == 0 else None


def aligned_batch_rows(r0: int, W: int, target: int) -> int:
    """Rows k >= 1 of the next batch from row r0, such that r0 + k is a
    chunk boundary: the most that stay within `target` rows, else the fewest
    that reach one."""
    first, step = _first_boundary(W), _boundary_step(W)
    if r0 + target >= first:
        last = first + ((r0 + target - first) // step) * step
        if last > r0:
            return last - r0
    nxt = first if r0 < first else first + ((r0 - first) // step + 1) * step
    return nxt - r0


def aligned_batches(r0: int, r1: int, W: int, target: int) -> list[tuple[int, int]]:
    """Rows [r0, r1) from a chunk-boundary row r0, in batches that end on
    chunk boundaries but the last."""
    out = []
    while r0 < r1:
        e = min(r1, r0 + aligned_batch_rows(r0, W, target))
        out.append((r0, e))
        r0 = e
    return out


def target_rows(n_cols: int, spec: FieldSpec) -> int:
    """Encoded rows of n_cols columns in about BATCH_BYTES of int32 limbs."""
    return max(1, BATCH_BYTES // (n_cols * spec.num_limbs16 * 4))


def _zero_stream_digests(n: int, device) -> torch.Tensor:
    """(n, 8) int32 digests of the 32-byte zero block alone (a stream of no
    rows)."""
    d = np.frombuffer(b3.blake3(b"\x00" * 32), "<u4").view(np.int32)
    return torch.from_numpy(np.tile(d, (n, 1))).to(device)


# -- incremental column digests ----------------------------------------------

class ColumnDigestAccumulator:
    """column_digest_accumulator.rs: per-column digests over encoded rows.

    Each column's stream is 32 zero bytes, then its repr in every row
    (lcpc-2d/src/lib.rs:752-753; column_digest_accumulator.rs:33).  Rows
    are kept on the device until a chunk boundary of the streams, then the
    aligned prefix is hashed into chunk CVs (K2's chunk-CV entry) and
    dropped; finalize merges every column's CVs (K2's merge entry), or
    hashes the rows whole (K2's leaves) where a stream is one chunk.

    `columns` = None means All; a list means Only(indices) (the reference's
    Only mode indexes digests by column id, a bug; positions are used)."""

    def __init__(self, n_encoded_cols: int, spec: FieldSpec,
                 columns: list[int] | None = None, device=None):
        self.spec = spec
        self.n_encoded_cols = n_encoded_cols
        self.columns = columns
        self.device = default_device(device)
        self._cols = (None if columns is None
                      else torch.tensor(list(columns), dtype=torch.int64, device=self.device))
        self.width = n_encoded_cols if columns is None else len(columns)
        self._pending: list[torch.Tensor] = []
        self._pending_rows = 0
        self._hashed_rows = 0
        self._chunks = 0
        self._head: torch.Tensor | None = None     # the first chunk's rows
        self._cvs = torch.empty((self.width, 0, 8), dtype=torch.int32, device=self.device)
        self.finalized = False

    def get_width(self) -> int:
        return self.width

    def update(self, encoded_row) -> None:
        """encoded_row: (n_encoded_cols, L), one encoded row."""
        self.update_batch(limb_tensor(encoded_row)[None])

    def update_batch(self, rows) -> None:
        """rows: (k, n_encoded_cols, L) limbs, k encoded rows at once (a
        tensor on any device, or a host array)."""
        rows = limb_tensor(rows)
        if rows.dim() != 3 or rows.shape[1] != self.n_encoded_cols:
            raise ValueError(f"update_batch: rows {tuple(rows.shape)}, expected "
                             f"(k, {self.n_encoded_cols}, {self.spec.num_limbs16})")
        if self.finalized:
            raise RuntimeError("accumulator already finalized")
        rows = rows.to(self.device, torch.int32)
        if self._cols is not None:
            rows = rows.index_select(1, self._cols)
        self._pending.append(rows)
        self._pending_rows += rows.shape[0]
        self._flush(final=False)

    def _take_pending(self, n: int) -> torch.Tensor:
        """The first n pending rows, as one contiguous tensor."""
        rows = self._pending[0] if len(self._pending) == 1 else torch.cat(self._pending)
        batch, rest = rows[:n], rows[n:]
        self._pending = [rest] if rest.shape[0] else []
        self._pending_rows -= n
        return batch.contiguous()

    def _flush(self, final: bool) -> None:
        """Hash the pending rows up to the last chunk boundary (all of them
        where final)."""
        W = self.spec.repr_bytes
        h = self._hashed_rows
        if final:
            take = self._pending_rows
        elif self._pending_rows:
            k = aligned_batch_rows(h, W, self._pending_rows)
            take = k if k <= self._pending_rows else 0
        else:
            take = 0
        if take == 0:
            return
        batch = self._take_pending(take)
        first = h == 0
        if first and 32 + take * W <= b3.CHUNK_LEN:
            self._head = batch.clone()     # the stream may end as this one chunk
        k, _ = batch_chunks(take, self.spec, first)
        if self._chunks + k > self._cvs.shape[1]:
            grown = torch.empty((self.width, max(2 * self._cvs.shape[1], self._chunks + k), 8),
                                dtype=torch.int32, device=self.device)
            grown[:, : self._chunks] = self._cvs[:, : self._chunks]
            self._cvs = grown
        chunk_cvs(batch, self.spec, self._cvs, self._chunks, first)
        self._hashed_rows += take
        self._chunks += k

    def finalize(self) -> torch.Tensor:
        """-> (width, 8) int32 digests on the accumulator's device."""
        if self.finalized:
            raise RuntimeError("accumulator already finalized")
        self.finalized = True
        total = self._hashed_rows + self._pending_rows
        if total == 0:
            return _zero_stream_digests(self.width, self.device)
        if 32 + total * self.spec.repr_bytes <= b3.CHUNK_LEN:
            parts = ([self._head] if self._hashed_rows else []) + self._pending
            return hash_columns(torch.cat(parts).contiguous(), self.spec)
        self._flush(final=True)
        return merge_cvs(self._cvs[:, : self._chunks].contiguous())

    def get_column_digests(self) -> list[bytes]:
        return digests_to_bytes(self.finalize())

    def finalize_to_merkle_tree(self) -> "MerkleTree":
        if self.columns is not None:
            raise ValueError("a Merkle tree needs all columns")
        return MerkleTree.new(self.finalize())

    def finalize_to_commit(self) -> bytes:
        return self.finalize_to_merkle_tree().root()

# -- standalone merkle tree (merkle_tree.rs) --------------------------------

class MerkleTree:
    """Digest array [leaves..., parents..., root]; width a power of two."""

    def __init__(self, digests: list[bytes], width: int):
        self.digests = digests
        self.width = width

    @classmethod
    def new(cls, leaves) -> "MerkleTree":
        """leaves: a list of 32-byte digests, or an (n, 8) int32 digest
        tensor; the layers are built on the tensor's device (K2's tree entry
        on CUDA, the plain version on CPU)."""
        if not isinstance(leaves, torch.Tensor):
            words = np.frombuffer(b"".join(leaves), "<u4").view(np.int32).reshape(-1, 8)
            leaves = torch.from_numpy(words.copy())
        width = leaves.shape[0]
        if width < 2 or width & (width - 1):
            raise ValueError(f"Merkle tree width must be a power of two >= 2, got {width}")
        hashes = merkle_array(width, leaves.device)
        hashes[:width] = leaves
        return cls(digests_to_bytes(merkle_tree(hashes)), width)

    def root(self) -> bytes:
        return self.digests[-1]

    def get_path(self, index: int) -> list[bytes] | None:
        if index >= self.width:
            return None
        path = []
        offset = 0
        width = self.width
        while width > 1:
            other = (index & ~1) | (~index & 1)
            path.append(self.digests[offset + other])
            offset += width
            width //= 2
            index >>= 1
        return path

    def __len__(self) -> int:
        return len(self.digests)

    def __getitem__(self, i: int) -> bytes:
        return self.digests[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, MerkleTree) and self.digests == other.digests

    def to_bytes(self) -> bytes:
        return b"".join(self.digests)

    @classmethod
    def from_bytes(cls, data: bytes) -> "MerkleTree":
        n = len(data) // 32
        if (n + 1) & n or n <= 2:
            raise ValueError("invalid tree size")
        digests = [data[i * 32: (i + 1) * 32] for i in range(n)]
        return cls(digests, (n + 1) // 2)


# -- chunk-CV cache: incremental edit/append re-hash ------------------------

class ColumnCVCache:
    """Blake3 chunk CVs of every chunk of an encoded file's column streams,
    on the device.

    The stream of column c is 32 zero bytes ++ its on-disk encoded bytes
    (rows_written * repr_bytes, column-major .porenc layout).  Building the
    cache hashes the whole file once; after that a row edit re-hashes only
    the chunks it touches and an append only the chunks past the old tail:
    the touched rows are read from the file, widened to limbs on the device
    and hashed by K2's chunk-CV entry from the chunk boundary at or below
    them; the digests are K2's merge of all chunks (the final partial chunk
    included, whose CV is kept up to date too).  :meth:`copy_for` hands the
    CVs to a byte-identical copy of the file without reading it.  The
    reference re-hashes the whole encoded file on every edit and append
    (file_handler.rs:331, 474-481)."""

    def __init__(self, path: Path, spec: FieldSpec, n_cols: int,
                 row_capacity: int, rows_written: int, device=None):
        self.path = Path(path)
        self.spec = spec
        self.n_cols = n_cols
        self.row_capacity = row_capacity
        self.rows_written = rows_written
        self.device = default_device(device)
        self.cvs = torch.zeros((n_cols, self._n_chunks(rows_written), 8), dtype=torch.int32,
                               device=self.device)
        self._refresh(0, self.cvs.shape[1])

    def _n_chunks(self, rows: int) -> int:
        return ceildiv(32 + rows * self.spec.repr_bytes, b3.CHUNK_LEN)

    def copy_for(self, path: Path) -> "ColumnCVCache":
        """The cache of a byte-identical copy of the file at `path`: the same
        CVs, in a tensor of its own (edits of either file leave the other's
        CVs as they are)."""
        other = copy.copy(self)
        other.path = Path(path)
        other.cvs = self.cvs.clone()
        return other

    def rows_tensor(self, r0: int, r1: int) -> torch.Tensor:
        """Rows [r0, r1) of the file as (r1 - r0, n_cols, L) int32 limbs on
        the cache's device."""
        W = self.spec.repr_bytes
        with open(self.path, "rb") as f:
            cols = _read_columns(f, self.n_cols, self.row_capacity * W, r0 * W, r1 * W)
        return _columns_to_rows(cols, r1 - r0, self.spec, self.device)

    def _refresh(self, k0: int, k1: int) -> None:
        """Recompute chunks [k0, k1), widened to chunks that start on row
        boundaries."""
        W = self.spec.repr_bytes
        if self.rows_written == 0 or k1 <= k0:
            return
        total = self.cvs.shape[1]
        while chunk_row(k0, W) is None:
            k0 -= 1
        while k1 < total and chunk_row(k1, W) is None:
            k1 += 1
        r0 = chunk_row(k0, W)
        r1 = self.rows_written if k1 >= total else chunk_row(k1, W)
        for s, e in aligned_batches(r0, r1, W, target_rows(self.n_cols, self.spec)):
            chunk0 = 0 if s == 0 else (32 + s * W) // b3.CHUNK_LEN
            chunk_cvs(self.rows_tensor(s, e), self.spec, self.cvs, chunk0, s == 0)

    def note_rows_changed(self, r0: int, r1: int) -> None:
        """Rows [r0, r1) were rewritten on disk: refresh the touched chunks."""
        W = self.spec.repr_bytes
        self._refresh((32 + r0 * W) // b3.CHUNK_LEN,
                      min(ceildiv(32 + r1 * W, b3.CHUNK_LEN), self.cvs.shape[1]))

    def set_rows_written(self, new_rows: int) -> None:
        """Append path: extend the CVs past the old tail (the old final
        chunk is recomputed)."""
        old = self.cvs.shape[1]
        self.rows_written = new_rows
        new = self._n_chunks(new_rows)
        if new != old:
            grown = torch.zeros((self.n_cols, new, 8), dtype=torch.int32, device=self.device)
            keep = min(old, new)
            grown[:, :keep] = self.cvs[:, :keep]
            self.cvs = grown
        self._refresh(max(old - 1, 0), new)

    def set_row_capacity(self, row_capacity: int) -> None:
        """Capacity doubling moves the column streams on disk; their content
        is unchanged, so the CVs stay valid."""
        self.row_capacity = row_capacity

    def digests(self) -> torch.Tensor:
        """(n_cols, 8) int32 column digests on the cache's device."""
        if self.rows_written == 0:
            return _zero_stream_digests(self.n_cols, self.device)
        if self.cvs.shape[1] == 1:
            return hash_columns(self.rows_tensor(0, self.rows_written), self.spec)
        return merge_cvs(self.cvs)

    def column_digests(self) -> list[bytes]:
        return digests_to_bytes(self.digests())

    def to_merkle_tree(self) -> MerkleTree:
        return MerkleTree.new(self.digests())


# -- encoded file writer (encoded_file_writer.rs) ---------------------------

class EncodedFileWriter:
    """Streaming commit: bytes in -> batched device encode -> incremental
    column digests -> column-major writes.  Layout: element (row, col) at
    byte offset col*row_capacity*W + row*W.  Runs on `device` (default: the
    current CUDA card; without one it raises unless given ``device="cpu"``)."""

    def __init__(self, n_per_row: int, n_cols: int, original_file_size: int,
                 target_path: Path, spec: FieldSpec, device=None):
        if n_cols & (n_cols - 1) or not 0 < n_per_row < n_cols:
            raise ValueError(f"bad encoding dims ({n_per_row}, {n_cols})")
        self.spec = spec
        self.n_per_row = n_per_row
        self.n_cols = n_cols
        self.device = default_device(device)
        self.tables = ntt_tables(spec, n_cols, self.device)
        cap = spec.data_byte_capacity
        num_rows = ceildiv(ceildiv(max(original_file_size, 0), cap), n_per_row)
        self.row_capacity = max(2 * num_rows, 2)
        self.accumulator = ColumnDigestAccumulator(n_cols, spec, device=self.device)
        self.bytes_received = 0
        self.rows_written = 0
        self._pending = bytearray()
        self._file = open(target_path, "w+b")
        self._file.truncate(self.row_capacity * n_cols * spec.repr_bytes)
        self._mm = None

    @property
    def row_bytes(self) -> int:
        return self.n_per_row * self.spec.data_byte_capacity

    def _batch_rows(self) -> int:
        """Rows of the next full batch: about BATCH_BYTES of encoded int32
        limbs, ending on a chunk boundary of the column streams."""
        return aligned_batch_rows(self.rows_written, self.spec.repr_bytes,
                                  target_rows(self.n_cols, self.spec))

    def _mapped(self) -> mmap.mmap:
        """mmap of the encoded file, fallocated first: stores into an
        unallocated sparse file stall on block allocation."""
        flen = self.row_capacity * self.n_cols * self.spec.repr_bytes
        if self._mm is None or len(self._mm) != flen:
            if self._mm is not None:
                self._mm.close()
            self._file.flush()
            try:
                os.posix_fallocate(self._file.fileno(), 0, flen)
            except OSError:
                pass
            self._mm = mmap.mmap(self._file.fileno(), flen)
        return self._mm

    def push_bytes(self, data: bytes) -> None:
        self.bytes_received += len(data)
        self._pending += data
        while len(self._pending) // self.row_bytes >= self._batch_rows():
            self._encode_and_write(self._batch_rows() * self.row_bytes)

    def _encode_and_write(self, nbytes: int) -> None:
        """Encode the first nbytes of the pending data (whole rows, or the
        rest of the file) and write them."""
        encoded = encode_data(self._pending[:nbytes], self.spec, self.n_per_row, self.tables)
        del self._pending[:nbytes]
        self.accumulator.update_batch(encoded)
        self._write_rows(encoded)

    def _write_rows(self, encoded: torch.Tensor) -> None:
        """Column-major write of (k, n_cols, L) encoded rows: the transpose
        to (n_cols, k, W) repr bytes runs on the device, then one strided
        copy into the mapped file."""
        k = encoded.shape[0]
        W = self.spec.repr_bytes
        by_col = limbs_to_repr_bytes(encoded, self.spec).permute(1, 0, 2).contiguous()
        by_col = by_col.cpu().numpy().reshape(self.n_cols, k * W)
        if self.rows_written + k > self.row_capacity:
            self.set_new_capacity(2 * (self.rows_written + k))
        base = self.rows_written * W
        view = np.frombuffer(self._mapped(), np.uint8).reshape(self.n_cols, -1)
        view[:, base: base + k * W] = by_col
        del view
        self.rows_written += k

    def set_new_capacity(self, new_capacity: int) -> None:
        if new_capacity < self.rows_written:
            raise ValueError("capacity below the rows written")
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        _move_columns(self._file, self.n_cols, self.row_capacity, new_capacity,
                      self.spec.repr_bytes)
        self.row_capacity = new_capacity

    def _drain(self) -> None:
        while self._pending:
            k = min(len(self._pending) // self.row_bytes, self._batch_rows())
            self._encode_and_write(k * self.row_bytes if k else len(self._pending))

    def metadata(self, ulid: str = "") -> EncodedFileMetadata:
        return EncodedFileMetadata(
            ulid=ulid, pre_encoded_size=self.n_per_row,
            encoded_size=self.n_cols, rows_written=self.rows_written,
            row_capacity=self.row_capacity, bytes_of_data=self.bytes_received)

    def _close_file(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._file.flush()
        self._file.close()

    def finalize_to_merkle_tree(self) -> tuple[EncodedFileMetadata, MerkleTree]:
        self._drain()
        tree = self.accumulator.finalize_to_merkle_tree()
        self._close_file()
        return self.metadata(), tree

    def finalize_to_column_digests(self) -> tuple[EncodedFileMetadata, list[bytes]]:
        self._drain()
        digests = self.accumulator.get_column_digests()
        self._close_file()
        return self.metadata(), digests

    @classmethod
    def convert_unencoded_file(cls, unencoded_path: Path, encoded_path: Path,
                               tree_path: Path | None, meta_path: Path | None,
                               n_per_row: int, n_cols: int, spec: FieldSpec,
                               ulid: str = "", device=None
                               ) -> tuple[EncodedFileMetadata, MerkleTree]:
        total = os.path.getsize(unencoded_path)
        writer = cls(n_per_row, n_cols, total, encoded_path, spec, device)
        with open(unencoded_path, "rb") as f:
            while True:
                data = f.read(1 << 24)
                if not data:
                    break
                writer.push_bytes(data)
        meta, tree = writer.finalize_to_merkle_tree()
        meta.ulid = ulid
        if meta_path is not None:
            meta.write_to_file(meta_path)
        if tree_path is not None:
            tree_path.write_bytes(tree.to_bytes())
        return meta, tree


def _move_columns(f, n_cols: int, old_cap: int, new_cap: int, W: int) -> None:
    """Grow a column-major file from old_cap to new_cap rows a column."""
    old_len, new_len = old_cap * W, new_cap * W
    f.truncate(new_cap * n_cols * W)
    for col in range(n_cols - 1, -1, -1):
        f.seek(col * old_len)
        data = f.read(old_len)
        f.seek(col * new_len)
        f.write(data.ljust(new_len, b"\x00"))


# -- encoded file reader (encoded_file_reader.rs) ---------------------------

class EncodedFileReader:
    """Row and column access to an encoded file; decodes and re-encodes on
    `device` (default: the current CUDA card; without one it raises unless
    given ``device="cpu"``)."""

    def __init__(self, path: Path, spec: FieldSpec, n_per_row: int,
                 n_cols: int, rows_written: int, row_capacity: int, device=None):
        self.spec = spec
        self.n_per_row = n_per_row
        self.n_cols = n_cols
        self.rows_written = rows_written
        self.row_capacity = row_capacity
        self.device = default_device(device)
        self._file = open(path, "r+b")

    @property
    def tables(self) -> NttTables:
        return ntt_tables(self.spec, self.n_cols, self.device)

    def close(self) -> None:
        self._file.close()

    def _column_bytes(self, start: int, count: int) -> np.ndarray:
        W = self.spec.repr_bytes
        return _read_columns(self._file, self.n_cols, self.row_capacity * W, start * W,
                             (start + count) * W)

    def get_encoded_row(self, row: int) -> np.ndarray:
        """(n_cols, L) uint32 limbs of one encoded row."""
        return self.get_encoded_rows(row, 1)[0]

    def get_encoded_rows(self, start: int, count: int) -> np.ndarray:
        """(count, n_cols, L) uint32 limbs, one strided gather."""
        out = self._column_bytes(start, count).reshape(self.n_cols, count, -1)
        return repr_bytes_to_limbs_np(out.transpose(1, 0, 2), self.spec)

    def encoded_rows_tensor(self, start: int, count: int) -> torch.Tensor:
        """(count, n_cols, L) int32 limbs on the reader's device."""
        return _columns_to_rows(self._column_bytes(start, count), count, self.spec, self.device)

    def get_unencoded_row(self, row: int) -> np.ndarray:
        """(n_per_row, L) decoded limbs (inverse NTT, then truncate)."""
        dec = decode_rows(self.encoded_rows_tensor(row, 1), self.spec, self.n_per_row,
                          self.tables)
        return dec[0].cpu().numpy().astype(np.uint32)

    def get_unencoded_row_bytes(self, row: int) -> bytes:
        return limbs_to_data_bytes_np(self.get_unencoded_row(row), self.spec)

    def decode_to_bytes(self) -> bytes:
        """Decode the whole file, in device batches."""
        out = []
        target = target_rows(self.n_cols, self.spec)
        for r0 in range(0, self.rows_written, target):
            cnt = min(target, self.rows_written - r0)
            dec = decode_rows(self.encoded_rows_tensor(r0, cnt), self.spec, self.n_per_row,
                              self.tables)
            out.append(limbs_to_data_bytes_np(
                dec.reshape(-1, self.spec.num_limbs16).cpu().numpy(), self.spec))
        return b"".join(out)

    def flush(self) -> None:
        """Make buffered writes visible to other handles (the chunk-CV cache
        reads the file through its own descriptor)."""
        self._file.flush()

    def replace_encoded_rows(self, row: int, encoded_rows) -> None:
        """Write (k, n_cols, L) encoded rows from `row` on (k tensor rows on
        any device, or host limbs); row <= rows_written."""
        rows = limb_tensor(encoded_rows)
        if row > self.rows_written or row + rows.shape[0] > self.row_capacity:
            raise ValueError(f"rows {row}.. outside the file ({self.rows_written} written, "
                             f"capacity {self.row_capacity})")
        k = rows.shape[0]
        W = self.spec.repr_bytes
        stride = self.row_capacity * W
        reprs = limbs_to_repr_bytes(rows.to(self.device, torch.int32), self.spec)
        by_col = reprs.permute(1, 0, 2).contiguous().cpu().numpy().reshape(self.n_cols, k * W)
        with _strided_view(self._file, self.n_cols, stride, writable=True) as view:
            if view is not None:
                view[:, row * W: (row + k) * W] = by_col
            else:
                for c in range(self.n_cols):
                    self._file.seek(c * stride + row * W)
                    self._file.write(by_col[c].tobytes())
        self.rows_written = max(self.rows_written, row + k)

    def replace_encoded_row(self, row: int, encoded_row) -> None:
        """Write one (n_cols, L) encoded row; row <= rows_written."""
        self.replace_encoded_rows(row, limb_tensor(encoded_row)[None])

    def replace_row_with_decoded_bytes(self, row: int, data: bytes) -> None:
        """Encode at most one row of data bytes (K1 on CUDA; a short row is
        zero-padded) and write it as encoded row `row`."""
        if len(data) > self.n_per_row * self.spec.data_byte_capacity:
            raise ValueError(f"{len(data)} bytes are more than one row holds")
        self.replace_encoded_rows(row, self.encode_data_rows(data))

    def encode_data_rows(self, data: bytes) -> torch.Tensor:
        """:func:`encode_data` at the reader's dims, on its device."""
        return encode_data(data, self.spec, self.n_per_row, self.tables)

    def get_encoded_column_without_path(self, col: int) -> np.ndarray:
        """(rows_written, L) limbs: one contiguous column read."""
        W = self.spec.repr_bytes
        self._file.seek(col * self.row_capacity * W)
        data = self._file.read(self.rows_written * W)
        arr = np.frombuffer(data, np.uint8).reshape(self.rows_written, W)
        return repr_bytes_to_limbs_np(arr, self.spec)

    def process_file_to_merkle_tree(self) -> MerkleTree:
        acc = ColumnDigestAccumulator(self.n_cols, self.spec, device=self.device)
        for s, e in aligned_batches(0, self.rows_written, self.spec.repr_bytes,
                                    target_rows(self.n_cols, self.spec)):
            acc.update_batch(self.encoded_rows_tensor(s, e - s))
        return acc.finalize_to_merkle_tree()

    def set_new_capacity(self, new_capacity: int) -> None:
        if new_capacity < self.rows_written:
            raise ValueError("capacity below the rows written")
        _move_columns(self._file, self.n_cols, self.row_capacity, new_capacity,
                      self.spec.repr_bytes)
        self.row_capacity = new_capacity


def get_encoded_file_size_from_rate(decoded_size: int, n_per_row: int,
                                    n_cols: int, spec: FieldSpec) -> int:
    """encoded_file_reader.rs:384-395 (div_ceil order matters)."""
    cap = spec.data_byte_capacity
    return ceildiv(ceildiv(decoded_size, cap), n_per_row) * spec.repr_bytes * n_cols


def get_decoded_file_size_from_rate(encoded_size: int, n_per_row: int,
                                    n_cols: int, spec: FieldSpec) -> int:
    return ceildiv(ceildiv(encoded_size, n_cols), spec.repr_bytes) \
        * spec.data_byte_capacity * n_per_row
