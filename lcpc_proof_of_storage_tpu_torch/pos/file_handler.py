"""FileHandler: the per-file storage manager.

Counterpart of ``lcpc_proof_of_storage_tpu/pos/file_handler.py`` (reference:
proof-of-storage/src/lcpc_online/file_handler.rs).  Owns the on-disk
quadruple (.porraw/.porenc/.portree/.meta) and the in-memory Merkle tree;
supports create/attach, edit/append/reshape, row/column access and the
full-consistency self-check.  Its device work (row encodes, the chunk-CV
cache, the left-multiply of a polynomial evaluation) runs on `device`
(default: the current CUDA card; without one it raises unless given
``device="cpu"``).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np
import torch

from ..core.commit import LcColumn, default_device
from ..fields.field import FieldSpec, ints_to_limbs, limbs_to_ints
from ..fields.limb import limb_field, narrow_limbs
from ..ops.collapse import collapse
from ..ops.ntt import encode_rows
from ..utils.profiling import phase
from .storage import (
    ColumnCVCache, ColumnDigestAccumulator, EncodedFileMetadata, EncodedFileReader,
    EncodedFileWriter, MerkleTree, aligned_batches, bytes_tensor, ceildiv, data_bytes_to_limbs,
    file_paths, new_ulid, ntt_tables,
)

#: raw bytes of one left-multiply batch (uploaded as 16-bit limbs)
LEFT_MULTIPLY_BYTES = 64 << 20


class FileHandler:
    def __init__(self, ulid: str, paths: dict[str, Path], spec: FieldSpec,
                 meta: EncodedFileMetadata, tree: MerkleTree, device=None):
        self.ulid = ulid
        self.paths = paths
        self.spec = spec
        self.device = default_device(device)
        self.pre_encoded_size = meta.pre_encoded_size
        self.encoded_size = meta.encoded_size
        self.rows_written = meta.rows_written
        self.row_capacity = meta.row_capacity
        self.total_data_bytes = meta.bytes_of_data
        self.merkle_tree = tree
        self.reader = EncodedFileReader(
            paths["enc"], spec, meta.pre_encoded_size, meta.encoded_size,
            meta.rows_written, meta.row_capacity, self.device)
        self._cv_cache: ColumnCVCache | None = None   # built on first edit or append

    # -- constructors --------------------------------------------------------
    @classmethod
    def attach(cls, ulid: str, spec: FieldSpec, base: Path | None = None,
               device=None) -> "FileHandler":
        paths = file_paths(ulid, base)
        for k, p in paths.items():
            if not p.is_file():
                raise FileNotFoundError(f"missing {k} file: {p}")
        meta = EncodedFileMetadata.read_from_file(paths["meta"])
        if meta.ulid != ulid:
            raise ValueError(f"metadata ulid {meta.ulid} is not {ulid}")
        tree = MerkleTree.from_bytes(paths["tree"].read_bytes())
        return cls(ulid, paths, spec, meta, tree, device)

    @classmethod
    def create_from_unencoded_file(cls, ulid: str, source: Path | None,
                                   pre_encoded_size: int, encoded_size: int,
                                   spec: FieldSpec, base: Path | None = None,
                                   device=None) -> "FileHandler":
        if encoded_size & (encoded_size - 1):
            raise ValueError(f"encoded size {encoded_size} is not a power of two")
        paths = file_paths(ulid, base)
        if source is not None and source != paths["raw"]:
            os.replace(source, paths["raw"])
        meta, tree = EncodedFileWriter.convert_unencoded_file(
            paths["raw"], paths["enc"], paths["tree"], paths["meta"],
            pre_encoded_size, encoded_size, spec, ulid=ulid, device=device)
        return cls(ulid, paths, spec, meta, tree, device)

    @classmethod
    def create_from_bytes(cls, data: bytes, pre_encoded_size: int,
                          encoded_size: int, spec: FieldSpec,
                          base: Path | None = None, ulid: str | None = None,
                          device=None) -> "FileHandler":
        ulid = ulid or new_ulid()
        paths = file_paths(ulid, base)
        paths["raw"].write_bytes(data)
        return cls.create_from_unencoded_file(
            ulid, None, pre_encoded_size, encoded_size, spec, base, device)

    # -- metadata ------------------------------------------------------------
    def get_encoded_metadata(self) -> EncodedFileMetadata:
        return EncodedFileMetadata(
            ulid=self.ulid, pre_encoded_size=self.pre_encoded_size,
            encoded_size=self.encoded_size, rows_written=self.rows_written,
            row_capacity=self.row_capacity, bytes_of_data=self.total_data_bytes)

    def _write_metadata(self) -> None:
        self.get_encoded_metadata().write_to_file(self.paths["meta"])

    def _write_tree(self, tree: MerkleTree) -> None:
        if len(tree) != self.encoded_size * 2 - 1:
            raise ValueError(f"tree of {len(tree)} digests for {self.encoded_size} columns")
        self.paths["tree"].write_bytes(tree.to_bytes())

    @property
    def row_data_bytes(self) -> int:
        return self.pre_encoded_size * self.spec.data_byte_capacity

    def get_dimensions(self) -> tuple[int, int, int]:
        return (self.pre_encoded_size, self.encoded_size, self.rows_written)

    def get_commit_root(self) -> bytes:
        return self.merkle_tree.root()

    # -- mutation ------------------------------------------------------------
    def _rewrite_rows(self, start_row: int, end_row: int) -> None:
        """Re-encode raw rows [start_row, end_row) in one device batch and
        write them into the encoded file."""
        with phase("row re-encode", actor="file_handler"):
            with open(self.paths["raw"], "rb") as f:
                f.seek(start_row * self.row_data_bytes)
                data = f.read((end_row - start_row) * self.row_data_bytes)
            enc = self.reader.encode_data_rows(data)
            self.reader.replace_encoded_rows(start_row, enc[: end_row - start_row])
            self.reader.flush()

    def edit_bytes(self, byte_start: int, new_bytes: bytes) -> tuple[bytes, MerkleTree]:
        """file_handler.rs:279-333: returns (original bytes, new tree)."""
        if byte_start + len(new_bytes) > self.total_data_bytes:
            raise ValueError("can't edit more bytes than there are in the file")
        with open(self.paths["raw"], "r+b") as f:
            f.seek(byte_start)
            original = f.read(len(new_bytes))
            f.seek(byte_start)
            f.write(new_bytes)
        start_row = byte_start // self.row_data_bytes
        end_row = ceildiv(byte_start + len(new_bytes), self.row_data_bytes)
        self._rewrite_rows(start_row, end_row)
        cache = self._cv_cache_ready()
        cache.note_rows_changed(start_row, end_row)
        return original, self._tree_from_cache(cache)

    def append_bytes(self, data: bytes) -> MerkleTree:
        """file_handler.rs:335-366."""
        with open(self.paths["raw"], "ab") as f:
            f.write(data)
        start_row = self.total_data_bytes // self.row_data_bytes
        end_row = ceildiv(self.total_data_bytes + len(data), self.row_data_bytes)
        cache = self._cv_cache_ready()
        if end_row > self.row_capacity:
            self.reader.set_new_capacity(end_row * 2)
            self.row_capacity = end_row * 2
            cache.set_row_capacity(self.row_capacity)
        self.total_data_bytes += len(data)
        self.rows_written = end_row
        self.reader.rows_written = end_row
        if end_row > start_row:
            self._rewrite_rows(start_row, end_row)
        # the rewritten last partial row and the chunks past the old tail
        cache.set_rows_written(end_row)
        cache.note_rows_changed(start_row, end_row)
        tree = self._tree_from_cache(cache)
        self._write_metadata()
        return tree

    def reshape(self, new_pre: int, new_enc: int) -> tuple[EncodedFileMetadata, MerkleTree]:
        """file_handler.rs:224-276: re-encode from the raw file at new dims."""
        self.reader.close()
        meta, tree = EncodedFileWriter.convert_unencoded_file(
            self.paths["raw"], self.paths["enc"], self.paths["tree"],
            self.paths["meta"], new_pre, new_enc, self.spec, ulid=self.ulid,
            device=self.device)
        self.pre_encoded_size = new_pre
        self.encoded_size = new_enc
        self.rows_written = meta.rows_written
        self.row_capacity = meta.row_capacity
        self.total_data_bytes = meta.bytes_of_data
        self.merkle_tree = tree
        self.reader = EncodedFileReader(
            self.paths["enc"], self.spec, new_pre, new_enc,
            meta.rows_written, meta.row_capacity, self.device)
        self._cv_cache = None                 # dims changed: rebuild lazily
        return meta, tree

    def _cv_cache_ready(self) -> ColumnCVCache:
        """The chunk-CV cache, built on a handler's first use (one pass over
        the encoded file) unless :meth:`clone_to_new_ulid` handed it over;
        every later edit or append re-hashes only the chunks it touches (the
        reference re-hashes the whole file each time, file_handler.rs:331,
        474-481)."""
        if self._cv_cache is None:
            with phase("chunk-CV cache build", actor="file_handler"):
                self._cv_cache = ColumnCVCache(
                    self.paths["enc"], self.spec, self.encoded_size,
                    self.row_capacity, self.rows_written, self.device)
        return self._cv_cache

    def _tree_from_cache(self, cache: ColumnCVCache) -> MerkleTree:
        with phase("re-hash, merge and tree", actor="file_handler"):
            tree = cache.to_merkle_tree()
            self.merkle_tree = tree
            self._write_tree(tree)
        return tree

    def recalculate_merkle_tree(self) -> MerkleTree:
        """The tree of the encoded file as it is on disk (its rows read back
        in chunk-aligned batches, K2's chunk CVs, merge and tree), stored and
        written; the chunk-CV cache, which may no longer match the file, is
        rebuilt at its next use."""
        tree = self.reader.process_file_to_merkle_tree()
        self.merkle_tree = tree
        self._write_tree(tree)
        self._cv_cache = None
        return tree

    # -- access --------------------------------------------------------------
    def get_encoded_row(self, row: int) -> np.ndarray:
        return self.reader.get_encoded_row(row)

    def get_decoded_row_bytes(self, row: int) -> bytes:
        return self.reader.get_unencoded_row_bytes(row)

    def get_unencoded_row(self, row: int) -> bytes:
        if not 0 <= row < self.rows_written:
            raise ValueError(f"row {row} outside the file's {self.rows_written} rows")
        start = row * self.row_data_bytes
        end = min((row + 1) * self.row_data_bytes, self.total_data_bytes)
        return self.get_unencoded_bytes(start, end)

    def get_unencoded_bytes(self, start: int, end: int) -> bytes:
        with open(self.paths["raw"], "rb") as f:
            f.seek(start)
            return f.read(end - start)

    def read_only_digests(self, columns: list[int] | None = None) -> list[bytes]:
        cols = columns if columns is not None else list(range(self.encoded_size))
        return [self.merkle_tree[c] for c in cols]

    def read_full_columns(self, columns: list[int] | None = None) -> list[LcColumn]:
        cols = columns if columns is not None else list(range(self.encoded_size))
        return [LcColumn(col=limbs_to_ints(self.reader.get_encoded_column_without_path(c)),
                         path=self.merkle_tree.get_path(c)) for c in cols]

    def left_multiply_unencoded_matrix_by_vector(self, left: list[int]) -> list[int]:
        """v = left^T . unencoded matrix (file_handler.rs:614-638).

        The raw file is read in row batches of about LEFT_MULTIPLY_BYTES,
        each uploaded and widened to 16-bit limbs on the device, and each
        batch folds into the (1, n_pre, L) accumulator by K3p (the collapse
        with an accumulator, T = 1)."""
        if len(left) != self.rows_written:
            raise ValueError(f"left vector of {len(left)}, the file has "
                             f"{self.rows_written} rows")
        n_pre = self.pre_encoded_size
        L = self.spec.num_limbs16
        t_all = torch.from_numpy(ints_to_limbs([v % self.spec.modulus for v in left],
                                               self.spec).astype(np.int32)).to(self.device)
        rows_b = max(1, LEFT_MULTIPLY_BYTES // max(self.row_data_bytes, 1))
        acc = torch.zeros((1, n_pre, L), dtype=torch.int32, device=self.device)
        with open(self.paths["raw"], "rb") as f:
            for r0 in range(0, self.rows_written, rows_b):
                r1 = min(r0 + rows_b, self.rows_written)
                f.seek(r0 * self.row_data_bytes)
                chunk = f.read(min(r1 * self.row_data_bytes, self.total_data_bytes)
                               - r0 * self.row_data_bytes)
                limbs = data_bytes_to_limbs(bytes_tensor(chunk, self.device), self.spec)
                mat = torch.zeros(((r1 - r0) * n_pre, L), dtype=torch.int16,
                                  device=self.device)
                mat[: limbs.shape[0]] = narrow_limbs(limbs)
                acc = collapse(mat.view(r1 - r0, n_pre, L), t_all[None, r0:r1].contiguous(),
                               self.spec, acc=acc)
        return limbs_to_ints(acc[0].cpu().numpy())

    def verifiable_polynomial_evaluation(self, left: list[int]) -> list[int]:
        """v = left^T . ENCODED matrix (lcpc_online.rs:454-484) served from
        the raw file: the encode is row-wise linear, so
        left^T . encode(M) == encode(left^T . M): one batched left-multiply
        over the unencoded rows plus a single-row encode (K1), instead of
        the reference's full re-commit per request (server.rs:670-683)."""
        u = self.left_multiply_unencoded_matrix_by_vector(left)
        row = limb_field(self.spec).array(u, self.device)[None]
        enc = encode_rows(row, self.spec, self.encoded_size,
                          ntt_tables(self.spec, self.encoded_size, self.device))
        return limbs_to_ints(enc[0].cpu().numpy())

    def verify_all_files_agree(self) -> None:
        """Exhaustive self-check (file_handler.rs:505-541): the tree of the
        encoded file and the tree of the raw file re-encoded both equal the
        handler's tree."""
        if self.reader.process_file_to_merkle_tree() != self.merkle_tree:
            raise ValueError("encoded file tree mismatch")
        acc = ColumnDigestAccumulator(self.encoded_size, self.spec, device=self.device)
        raw_size = os.path.getsize(self.paths["raw"])
        if raw_size != self.total_data_bytes:
            raise ValueError("raw size mismatch")
        raw_rows = ceildiv(raw_size, self.row_data_bytes)
        with open(self.paths["raw"], "rb") as f:
            for s, e in aligned_batches(0, raw_rows, self.spec.repr_bytes, 512):
                acc.update_batch(self.reader.encode_data_rows(
                    f.read((e - s) * self.row_data_bytes))[: e - s])
        if acc.finalize_to_merkle_tree() != self.merkle_tree:
            raise ValueError("raw-file re-encode tree mismatch")

    def clone_to_new_ulid(self, base: Path | None = None) -> "FileHandler":
        """Duplicate the on-disk quadruple under a fresh ulid and return a
        handler attached to the copy: byte-identical raw/enc/tree copies,
        metadata rewritten with the new ulid (the reference declares this
        surface but never finished it, file_handler.rs:209 todo!()).  The
        copy's chunk-CV cache is a copy of this handler's (built first if
        this handler has none), so an edit or append of the copy re-hashes
        only what it touches."""
        ulid = new_ulid()
        if base is None:
            base = self.paths["raw"].parent.parent
        dst = file_paths(ulid, base)
        self.reader.flush()
        cache = self._cv_cache_ready()
        with phase("clone (copy of the quadruple)", actor="file_handler"):
            for key in ("raw", "enc", "tree"):
                shutil.copyfile(self.paths[key], dst[key])
            meta = self.get_encoded_metadata()
            meta.ulid = ulid
            meta.write_to_file(dst["meta"])
        clone = FileHandler.attach(ulid, self.spec, base=base, device=self.device)
        clone._cv_cache = cache.copy_for(dst["enc"])
        return clone

    def clone_reshaped(self, new_pre: int, new_enc: int, base: Path | None = None):
        """Reshape into a NEW ulid: copy only the raw file and re-encode it
        at the new dims.  Returns (handler attached to the new quadruple,
        its MerkleTree)."""
        ulid = new_ulid()
        if base is None:
            base = self.paths["raw"].parent.parent
        dst = file_paths(ulid, base)
        shutil.copyfile(self.paths["raw"], dst["raw"])
        _, tree = EncodedFileWriter.convert_unencoded_file(
            dst["raw"], dst["enc"], dst["tree"], dst["meta"],
            new_pre, new_enc, self.spec, ulid=ulid, device=self.device)
        return FileHandler.attach(ulid, self.spec, base=base, device=self.device), tree

    def delete_all_files(self) -> None:
        self.reader.close()
        for p in self.paths.values():
            if p.exists():
                p.unlink()
        parent = self.paths["raw"].parent
        if parent.exists() and not any(parent.iterdir()):
            parent.rmdir()
