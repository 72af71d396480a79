"""PoR client: upload/download/proof/eval/edit/append/reshape/delete flows.

Counterpart of ``lcpc_proof_of_storage_tpu/pos/networking/client.py`` (a
re-creation of proof-of-storage/src/networking/client.rs); its device work
(the leaves precompute, the decode of every evaluation check) runs on the
session's device: the current CUDA card unless ``connect`` is given
``device="cpu"`` (without a card and without it, it raises).  Every flow
pre-computes its local expectations (column leaves, expected evaluation
differences) before trusting anything the server sends, exactly mirroring
the reference's verification math:

  * upload: local Leaves precompute for seeded challenge columns BEFORE
    upload; verify received columns against them and the root
    (client.rs:141-281);
  * download: recompute leaves from the downloaded bytes (306-427);
  * poly eval: column paths + partial-evaluation consistency (551-663);
  * reshape: evaluation equality across shapes (666-864);
  * append: new_eval - old_eval == expected difference from the appended
    bytes at elevated degree, incl. the partially-filled-coefficient splice
    (916-1163);
  * edit: same differencing over the edited row range (1166-1442).
"""

from __future__ import annotations

import asyncio
from pathlib import Path

from ...core.commit import default_device
from ...fields.field import limbs_to_ints
from ..database import (CLIENT_METADATA_TABLE, ClientRecord, FileMetadata,
                        MetadataStore, ServerHost)
from .. import online
from ..online import (FIXED_RANDOM_SEED_CHANGE_LATER, POS_FIELD,
                      VerificationError)
from ..storage import data_bytes_to_limbs_np
from . import shared
from ...crypto.chacha import chacha8_rng_from_u64
from ...utils.profiling import phase


class ClientSession:
    """One TCP connection with lockstep request/response."""

    def __init__(self, reader, writer, db: MetadataStore | None = None,
                 server_host: "ServerHost | None" = None, device=None):
        self.reader = reader
        self.writer = writer
        self.db = db
        self.server_host = server_host
        self.device = default_device(device)

    @classmethod
    async def connect(cls, server_ip: str, db: MetadataStore | None = None, device=None):
        host, port = server_ip.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        return cls(reader, writer, db,
                   server_host=ServerHost(server_ip=host, server_port=int(port)),
                   device=device)

    async def close(self):
        self.writer.close()

    async def rpc(self, msg: dict) -> dict:
        await shared.send_msg(self.writer, msg)
        reply = await shared.recv_msg(self.reader)
        if reply is None:
            raise ConnectionError("server closed connection")
        if reply.get("type") == "ErrorResponse":
            raise VerificationError(f"server error: {reply['error']}")
        return reply

    def _store(self, meta: FileMetadata):
        if self.db is not None:
            self.db.put_file_metadata(CLIENT_METADATA_TABLE, meta)
            # ClientRecord (client_record.rs:7-12): remember which server
            # hosts this file so the CLI can resolve it without --server
            if self.server_host is not None:
                self.db.put_client_record(ClientRecord(
                    id_ulid=meta.id_ulid, hosted_on=self.server_host,
                    metadata=meta))

    def _replace(self, old: FileMetadata, new: FileMetadata):
        if self.db is not None:
            self.db.put_file_metadata(CLIENT_METADATA_TABLE, new)
            self.db.delete(CLIENT_METADATA_TABLE, old.id_ulid)
            if self.server_host is not None:
                self.db.put_client_record(ClientRecord(
                    id_ulid=new.id_ulid, hosted_on=self.server_host,
                    metadata=new))
            self.db.delete_client_record(old.id_ulid)

    # -- upload (client.rs:51-303) ------------------------------------------
    async def upload_file(self, path: Path, n_pre: int | None = None,
                          n_enc: int | None = None,
                          use_chunks: bool = False) -> FileMetadata:
        """Chunked mode streams: the leaves precompute runs one-pass from
        disk (online.streaming_leaves_for_file) and chunks stream straight
        from the file — the client never holds the whole file, unlike the
        reference which reads it fully even in chunked mode
        (client.rs:70-83; its chunked server handler was todo!()).  Phase
        spans mirror the reference's benchmark{bottleneck=disk|cpu|network}
        instrumentation (client.rs:61-81)."""
        path = Path(path)
        if use_chunks:
            size = path.stat().st_size
            n_pre, n_enc, n_required = _resolve_dims_len(size, n_pre, n_enc)
            cols_to_verify = online.get_column_indices_from_random_seed(
                FIXED_RANDOM_SEED_CHANGE_LATER, n_required, n_enc)
            with phase("cpu"):
                local_leaves = online.streaming_leaves_for_file(
                    path, n_pre, n_enc, cols_to_verify, POS_FIELD, self.device)
            with phase("network"):
                reply = await self.rpc(shared.start_upload_new_file_by_chunks(
                    str(path), n_pre, n_enc, size))
            ulid = reply["file_ulid"]
            CHUNK = 1 << 16
            sent = 0
            with open(path, "rb") as f:
                while True:
                    with phase("disk"):
                        chunk = f.read(CHUNK)
                    sent += len(chunk)
                    last = sent >= size
                    with phase("network"):
                        reply = await self.rpc(shared.upload_file_chunk(
                            ulid, chunk, last))
                    if last:
                        break
            meta = shared.parse_metadata(reply["file_metadata"])
        else:
            with phase("disk"):
                data = path.read_bytes()
            n_pre, n_enc, n_required = _resolve_dims(data, n_pre, n_enc)
            cols_to_verify = online.get_column_indices_from_random_seed(
                FIXED_RANDOM_SEED_CHANGE_LATER, n_required, n_enc)
            with phase("cpu"):
                local_leaves = online.leaves_for_file_data(
                    data, n_pre, n_enc, cols_to_verify, POS_FIELD, self.device)
            with phase("network"):
                reply = await self.rpc(shared.upload_new_file(
                    str(path), data, n_pre, n_enc))
            meta = shared.parse_metadata(reply["file_metadata"])

        # request proof and verify against precomputed leaves
        with phase("network"):
            reply = await self.rpc(shared.request_proof(meta, cols_to_verify))
        columns = shared.parse_columns(reply["columns"])
        with phase("cpu"):
            online.client_verify_commitment(
                meta.root, local_leaves, cols_to_verify, columns,
                online.get_pos_soundness_n_cols(meta.num_columns,
                                                meta.num_encoded_columns))
        self._store(meta)
        return meta

    # -- download (client.rs:306-427) ---------------------------------------
    async def download_file(self, meta: FileMetadata) -> bytes:
        reply = await self.rpc(shared.request_file(meta))
        data = bytes.fromhex(reply["file"])
        # recompute leaves locally from downloaded data, then verify proof
        n_required = online.get_pos_soundness_n_cols(
            meta.num_columns, meta.num_encoded_columns)
        cols_to_verify = online.get_column_indices_from_random_seed(
            FIXED_RANDOM_SEED_CHANGE_LATER, n_required, meta.num_encoded_columns)
        local_leaves = online.leaves_for_file_data(
            data, meta.num_columns, meta.num_encoded_columns,
            cols_to_verify, POS_FIELD, self.device)
        reply = await self.rpc(shared.request_proof(meta, cols_to_verify))
        columns = shared.parse_columns(reply["columns"])
        online.client_verify_commitment(
            meta.root, local_leaves, cols_to_verify, columns, n_required)
        return data[: meta.filesize_in_bytes]

    # -- proof only (client.rs:459-548) -------------------------------------
    async def request_and_verify_proof(self, meta: FileMetadata) -> None:
        n_required = online.get_pos_soundness_n_cols(
            meta.num_columns, meta.num_encoded_columns)
        cols_to_verify = online.get_column_indices_from_random_seed(
            FIXED_RANDOM_SEED_CHANGE_LATER, n_required, meta.num_encoded_columns)
        reply = await self.rpc(shared.request_proof(meta, cols_to_verify))
        columns = shared.parse_columns(reply["columns"])
        online.verify_column_paths(meta.root, cols_to_verify, columns, POS_FIELD)

    # -- polynomial evaluation (client.rs:551-663) --------------------------
    async def request_and_verify_polynomial(self, meta: FileMetadata) -> None:
        rng = chacha8_rng_from_u64(FIXED_RANDOM_SEED_CHANGE_LATER)
        point = POS_FIELD.random(rng)
        reply = await self.rpc(shared.request_polynomial_evaluation(meta, point))
        v = [int(x) for x in reply["evaluation_result"]]

        cols_to_verify = online.get_column_indices_from_random_seed(
            FIXED_RANDOM_SEED_CHANGE_LATER,
            online.get_pos_soundness_n_cols(meta.num_columns,
                                            meta.num_encoded_columns),
            meta.num_encoded_columns)
        reply = await self.rpc(shared.request_proof(meta, cols_to_verify))
        columns = shared.parse_columns(reply["columns"])
        online.verify_column_paths(meta.root, cols_to_verify, columns, POS_FIELD)
        # partial-eval consistency with left stride x^(i*n_cols)
        online.verify_full_polynomial_evaluation(
            point, v, meta.num_rows, meta.num_encoded_columns,
            meta.num_columns, cols_to_verify, columns, POS_FIELD, self.device)

    # -- reshape (client.rs:666-864) ----------------------------------------
    async def reshape_file(self, meta: FileMetadata, new_pre: int,
                           new_enc: int) -> FileMetadata:
        reply = await self.rpc(shared.request_file_reshape(meta, new_pre, new_enc))
        new_meta = shared.parse_metadata(reply["file_metadata"])
        if (new_meta.num_encoded_columns != new_enc
                or new_meta.num_columns != new_pre):
            await self.rpc(shared.reshape_response(new_meta, meta, False))
            raise VerificationError("reshape dimensions not met")

        rng = chacha8_rng_from_u64(FIXED_RANDOM_SEED_CHANGE_LATER)
        point = POS_FIELD.random(rng)
        cols_old = online.get_column_indices_from_random_seed(
            FIXED_RANDOM_SEED_CHANGE_LATER,
            online.get_pos_soundness_n_cols(meta.num_columns,
                                            meta.num_encoded_columns),
            meta.num_encoded_columns)
        cols_new = online.get_column_indices_from_random_seed(
            FIXED_RANDOM_SEED_CHANGE_LATER,
            online.get_pos_soundness_n_cols(new_meta.num_columns,
                                            new_meta.num_encoded_columns),
            new_meta.num_encoded_columns)

        reply = await self.rpc(shared.request_reshape_evaluation(
            meta, new_meta, point, cols_old, cols_new))
        try:
            old_result = online.verify_full_polynomial_evaluation(
                point, [int(x) for x in reply["original_result_vector"]],
                meta.num_rows, meta.num_columns, meta.num_columns,
                cols_old, shared.parse_columns(reply["original_columns"]),
                POS_FIELD, self.device)
            new_result = online.verify_full_polynomial_evaluation(
                point, [int(x) for x in reply["new_result_vector"]],
                new_meta.num_rows, new_meta.num_columns, new_meta.num_columns,
                cols_new, shared.parse_columns(reply["new_columns"]),
                POS_FIELD, self.device)
        except VerificationError:
            await self.rpc(shared.reshape_response(new_meta, meta, False))
            raise
        if old_result != new_result:
            await self.rpc(shared.reshape_response(new_meta, meta, False))
            raise VerificationError("evaluations mismatched between shapes")
        await self.rpc(shared.reshape_response(new_meta, meta, True))
        self._replace(meta, new_meta)
        return new_meta

    # -- append (client.rs:916-1163) ----------------------------------------
    async def append_to_file(self, meta: FileMetadata,
                             data_to_append: bytes) -> FileMetadata:
        reply = await self.rpc(shared.append_to_file(meta, data_to_append))
        new_meta = shared.parse_metadata(reply["file_metadata"])
        if new_meta.filesize_in_bytes < meta.filesize_in_bytes + len(data_to_append):
            await self.rpc(shared.edit_or_append_response(new_meta, meta, False))
            raise VerificationError("insufficient bytes on new commit")

        rng = chacha8_rng_from_u64(FIXED_RANDOM_SEED_CHANGE_LATER)
        point = POS_FIELD.random(rng)
        cols = online.get_column_indices_from_random_seed(
            FIXED_RANDOM_SEED_CHANGE_LATER,
            online.get_pos_soundness_n_cols(meta.num_columns,
                                            meta.num_encoded_columns),
            meta.num_encoded_columns)
        reply = await self.rpc(shared.request_append_evaluation(
            meta, new_meta, point, cols))
        try:
            old_result = online.verify_full_polynomial_evaluation(
                point, [int(x) for x in reply["original_result_vector"]],
                meta.num_rows, meta.num_columns, meta.num_columns, cols,
                shared.parse_columns(reply["original_columns"]), POS_FIELD, self.device)
            new_result = online.verify_full_polynomial_evaluation(
                point, [int(x) for x in reply["new_result_vector"]],
                new_meta.num_rows, new_meta.num_columns, new_meta.num_columns,
                cols, shared.parse_columns(reply["new_columns"]), POS_FIELD, self.device)
        except VerificationError:
            await self.rpc(shared.edit_or_append_response(new_meta, meta, False))
            raise

        edited_row = [int(x) for x in reply["edited_unencoded_row"]]
        expected_diff = _expected_append_difference(
            meta, data_to_append, edited_row, point)
        p = POS_FIELD.modulus
        if new_result != (old_result + expected_diff) % p:
            await self.rpc(shared.edit_or_append_response(new_meta, meta, False))
            raise VerificationError("append difference mismatch")
        await self.rpc(shared.edit_or_append_response(new_meta, meta, True))
        self._replace(meta, new_meta)
        return new_meta

    # -- edit (client.rs:1166-1442) -----------------------------------------
    async def edit_file(self, meta: FileMetadata, start: int,
                        new_data: bytes) -> FileMetadata:
        reply = await self.rpc(shared.edit_file_bytes(meta, start, new_data))
        new_meta = shared.parse_metadata(reply["file_metadata"])
        for attr in ("num_rows", "num_columns", "num_encoded_columns"):
            if getattr(new_meta, attr) != getattr(meta, attr):
                raise VerificationError(f"{attr} changed on edit")
        if new_meta.root == meta.root:
            raise VerificationError("server returned the same root")

        rng = chacha8_rng_from_u64(FIXED_RANDOM_SEED_CHANGE_LATER)
        point = POS_FIELD.random(rng)
        cols = online.get_column_indices_from_random_seed(
            FIXED_RANDOM_SEED_CHANGE_LATER,
            online.get_pos_soundness_n_cols(meta.num_columns,
                                            meta.num_encoded_columns),
            meta.num_encoded_columns)
        cap = POS_FIELD.data_byte_capacity
        first_row = start // (meta.num_columns * cap)
        last_row = (start + len(new_data)) // (meta.num_columns * cap)
        reply = await self.rpc(shared.request_edit_evaluation(
            meta, new_meta, point, cols, (first_row, last_row)))

        original_rows = bytes.fromhex(reply["original_unencoded_rows"])
        if len(original_rows) < len(new_data):
            raise VerificationError("server sent insufficient row data")
        try:
            old_result = online.verify_full_polynomial_evaluation(
                point, [int(x) for x in reply["original_result_vector"]],
                meta.num_rows, meta.num_columns, meta.num_columns, cols,
                shared.parse_columns(reply["original_columns"]), POS_FIELD, self.device)
            new_result = online.verify_full_polynomial_evaluation(
                point, [int(x) for x in reply["new_result_vector"]],
                new_meta.num_rows, new_meta.num_columns, new_meta.num_columns,
                cols, shared.parse_columns(reply["new_columns"]), POS_FIELD, self.device)
        except VerificationError:
            await self.rpc(shared.edit_or_append_response(new_meta, meta, False))
            raise

        # expected difference from splicing the new bytes into the rows
        start_in_rows = start % (meta.num_columns * cap)
        expected_bytes = bytearray(original_rows)
        expected_bytes[start_in_rows : start_in_rows + len(new_data)] = new_data
        orig_coeffs = limbs_to_ints(data_bytes_to_limbs_np(original_rows, POS_FIELD))
        new_coeffs = limbs_to_ints(data_bytes_to_limbs_np(bytes(expected_bytes), POS_FIELD))
        p = POS_FIELD.modulus
        deg0 = first_row * meta.num_columns
        diff = (online.evaluate_field_polynomial_at_point_with_elevated_degree(
                    new_coeffs, point, deg0, POS_FIELD)
                - online.evaluate_field_polynomial_at_point_with_elevated_degree(
                    orig_coeffs, point, deg0, POS_FIELD)) % p
        if new_result != (old_result + diff) % p:
            await self.rpc(shared.edit_or_append_response(new_meta, meta, False))
            raise VerificationError("edit difference mismatch")
        await self.rpc(shared.edit_or_append_response(new_meta, meta, True))
        self._replace(meta, new_meta)
        return new_meta

    # -- encoded column (shared.rs RequestEncodedColumn) ----------------------
    async def request_encoded_column(self, meta: FileMetadata,
                                     col: int) -> list[int]:
        """One column of the server's stored ENCODED file, verified against
        the committed root via its Merkle leaf digest + path from a proof
        request (the EncodedColumn reply itself carries no path)."""
        reply = await self.rpc(shared.request_encoded_column(meta, col))
        vals = [int(x) for x in reply["col"]]
        reply = await self.rpc(shared.request_proof(meta, [col]))
        columns = shared.parse_columns(reply["columns"])
        online.verify_column_paths(meta.root, [col], columns, POS_FIELD)
        if columns[0].col != vals:
            raise VerificationError("encoded column does not match opening")
        return vals

    # -- delete (client.rs:867-913) -----------------------------------------
    async def delete_file(self, meta: FileMetadata) -> None:
        reply = await self.rpc(shared.delete_file(meta))
        if reply["type"] != "FileDeleted":
            raise VerificationError(f"unexpected reply {reply['type']} to DeleteFile")
        if self.db is not None:
            self.db.delete(CLIENT_METADATA_TABLE, meta.id_ulid)
            self.db.delete_client_record(meta.id_ulid)


def _resolve_dims(data: bytes, n_pre, n_enc):
    """client.rs:85-139 dims resolution."""
    return _resolve_dims_len(len(data), n_pre, n_enc)


def _resolve_dims_len(file_len: int, n_pre, n_enc):
    if n_pre is not None and n_enc is not None:
        if not (n_pre >= 1 and n_enc >= 2 and n_enc & (n_enc - 1) == 0 and n_enc > n_pre):
            raise ValueError(f"bad dims ({n_pre}, {n_enc})")
    elif n_pre is not None:
        rounded = 1 if n_pre <= 1 else 1 << (n_pre - 1).bit_length()
        n_enc = 1 << rounded.bit_length()
    elif n_enc is not None:
        if n_enc < 2 or n_enc & (n_enc - 1):
            raise ValueError(f"encoded columns {n_enc} is not a power of two >= 2")
        n_pre = n_enc // 2
    else:
        n_pre, n_enc, _ = online.get_aspect_ratio_default_from_file_len(file_len)
    return n_pre, n_enc, online.get_pos_soundness_n_cols(n_pre, n_enc)


def _expected_append_difference(meta: FileMetadata, data_to_append: bytes,
                                edited_row: list[int], point: int) -> int:
    """client.rs:1062-1115: append differencing with partial-coefficient
    splice."""
    p = POS_FIELD.modulus
    cap = POS_FIELD.data_byte_capacity
    original_degree = meta.filesize_in_bytes // cap
    byte_offset = meta.filesize_in_bytes % cap
    expected = 0
    prefix = b""
    if byte_offset != 0:
        changed = edited_row[original_degree % meta.num_columns]
        original_bytes = POS_FIELD.to_data_bytes(changed)[:byte_offset]
        prefix = original_bytes
        original_coeff = limbs_to_ints(
            data_bytes_to_limbs_np(original_bytes, POS_FIELD))
        if len(original_coeff) != 1:
            raise VerificationError("the server's edited row splits a coefficient")
        expected = (expected
                    - online.evaluate_field_polynomial_at_point_with_elevated_degree(
                        original_coeff, point, original_degree, POS_FIELD)) % p
    combined = prefix + data_to_append
    coeffs = limbs_to_ints(data_bytes_to_limbs_np(combined, POS_FIELD))
    expected = (expected
                + online.evaluate_field_polynomial_at_point_with_elevated_degree(
                    coeffs, point, original_degree, POS_FIELD)) % p
    return expected
