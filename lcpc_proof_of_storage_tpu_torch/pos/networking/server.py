"""PoR server: asyncio TCP, one handler task per connection.

Counterpart of ``lcpc_proof_of_storage_tpu/pos/networking/server.py`` (a
re-creation of proof-of-storage/src/networking/server.rs), serving the same
wire messages and the same on-disk quadruples; its device work (encodes,
digests, the left-multiply of an evaluation) runs on the server's device,
the current CUDA card unless ``serve`` is given ``device="cpu"`` (without
a card and without it, it raises).
Request/response
in lockstep over a length-delimited JSON stream; every handler error turns
into an ErrorResponse instead of dropping the connection (server.rs:267-277).

Files are stored as the FileHandler quadruple (.porraw/.porenc/.portree/
.meta) written ONCE at upload, and proofs / polynomial evaluations /
encoded columns are served from the stored encoded file + Merkle tree — the
reference instead re-reads and re-commits the whole file on every proof
request (server.rs:670-683), making proof latency linear in file size.

Intentional deviations from reference bugs (documented):
  * chunked upload is fully implemented (reference left todo!() at
    server.rs:456) using the streaming EncodedFileWriter;
  * RequestEncodedColumn is handled (the reference dispatches it at
    server.rs:212 but left the handler unimplemented!(), server.rs:639-660);
  * accept/reject file shuffling uses the intended transactional semantics:
    accepted edits/appends keep the NEW file and drop the old; rejected ones
    drop the NEW file (the reference renames/deletes the wrong side,
    server.rs:1109-1131).
"""

from __future__ import annotations

import asyncio
import logging
import traceback
from collections import OrderedDict
from pathlib import Path

from ...core.commit import default_device
from ...fields.field import limbs_to_ints
from ...utils.profiling import phase
from ..database import (FileMetadata, MetadataStore, SERVER_METADATA_TABLE,
                        ServerHost)
from ..file_handler import FileHandler
from .. import online
from ..online import POS_FIELD
from ..storage import (EncodedFileWriter, ceildiv, data_bytes_to_limbs_np,
                       file_paths, new_ulid)
from . import shared

MAX_CACHED_HANDLERS = 32


class ServerState:
    def __init__(self, base: Path | None = None, db_path: str | None = None, device=None):
        self.base = base
        self.device = default_device(device)
        self.db = MetadataStore(db_path or (str(base / "PoR_Database")
                                            if base else "PoR_Database"))
        self.open_files: dict[str, EncodedFileWriter] = {}
        self.open_file_info: dict[str, tuple[str, int, int]] = {}
        # attached FileHandlers (ulid -> handler), LRU-capped: each holds an
        # open fd on the encoded file + the in-memory Merkle tree
        self.handlers: OrderedDict[str, FileHandler] = OrderedDict()


def _handler(state: ServerState, meta: FileMetadata) -> FileHandler:
    """Attach (cached) the stored quadruple; files uploaded before the
    quadruple existed (raw only) are encoded once here and served from disk
    afterwards."""
    ulid = meta.id_ulid
    fh = state.handlers.get(ulid)
    if fh is None:
        try:
            fh = FileHandler.attach(ulid, POS_FIELD, base=state.base, device=state.device)
        except FileNotFoundError:
            fh = FileHandler.create_from_unencoded_file(
                ulid, None, meta.num_columns, meta.num_encoded_columns,
                POS_FIELD, base=state.base, device=state.device)
        _register_handler(state, fh)
    else:
        state.handlers.move_to_end(ulid)
    return fh


def _register_handler(state: ServerState, fh: FileHandler) -> None:
    state.handlers[fh.ulid] = fh
    if len(state.handlers) > MAX_CACHED_HANDLERS:
        _, old = state.handlers.popitem(last=False)
        old.reader.close()


def _drop_file(state: ServerState, ulid: str) -> None:
    """Evict the handler and delete the on-disk quadruple."""
    fh = state.handlers.pop(ulid, None)
    if fh is not None:
        fh.reader.close()
    for p in file_paths(ulid, state.base).values():
        if p.exists():
            p.unlink()


def _meta_from_handler(fh: FileHandler, filename: str,
                       root: bytes) -> FileMetadata:
    return FileMetadata(
        id_ulid=fh.ulid, filename=filename, num_rows=fh.rows_written,
        num_columns=fh.pre_encoded_size,
        num_encoded_columns=fh.encoded_size,
        filesize_in_bytes=fh.total_data_bytes, stored_server=ServerHost(),
        root=root)


def _read_raw(state: ServerState, meta: FileMetadata) -> bytes:
    return file_paths(meta.id_ulid, state.base)["raw"].read_bytes()


async def handle_connection(state: ServerState, reader, writer) -> None:
    try:
        while True:
            msg = await shared.recv_msg(reader)
            if msg is None:
                break
            try:
                reply = await dispatch(state, msg)
            except Exception as exc:      # ErrorResponse on any handler error
                traceback.print_exc()
                reply = shared.error_response(str(exc))
            if reply is not None:
                await shared.send_msg(writer, reply)
    finally:
        writer.close()


async def dispatch(state: ServerState, msg: dict) -> dict | None:
    t = msg.get("type")
    handlers = {
        "NewUser": h_new_user,
        "UserLogin": h_user_login,
        "UploadNewFile": h_upload_new_file,
        "StartUploadNewFileByChunks": h_start_chunked,
        "UploadFileChunk": h_upload_chunk,
        "RequestFile": h_request_file,
        "RequestFileRow": h_request_file_row,
        "EditFileBytes": h_edit_file_bytes,
        "AppendToFile": h_append_to_file,
        "RequestEncodedColumn": h_request_encoded_column,
        "RequestProof": h_request_proof,
        "RequestPolynomialEvaluation": h_request_poly_eval,
        "RequestFileReshape": h_request_reshape,
        "RequestReshapeEvaluation": h_request_reshape_eval,
        "ReshapeResponse": h_accept_or_reject,
        "RequestAppendEvaluation": h_request_append_eval,
        "RequestEditEvaluation": h_request_edit_eval,
        "EditOrAppendResponse": h_accept_or_reject,
        "DeleteFile": h_delete_file,
        "ClientKeepAlive": lambda s, m: _keepalive(),
    }
    handler = handlers.get(t)
    if handler is None:
        return shared.error_response(f"unknown message type {t}")
    # per-handler phase span (the reference #[tracing::instrument]s every
    # handler, server.rs:82-280): `pos server -vv` prints the report
    logging.getLogger("pos.server").debug("handling %s", t)
    with phase(t, actor="server"):
        result = handler(state, msg)
        if asyncio.iscoroutine(result):
            result = await result
    return result


async def _keepalive():
    return shared.server_keep_alive()


def h_new_user(state, msg):
    ok = state.db.create_user(msg["username"], msg["password"])
    return shared.user_login_response(ok)


def h_user_login(state, msg):
    return shared.user_login_response(
        state.db.check_login(msg["username"], msg["password"]))


def h_upload_new_file(state, msg):
    """server.rs:341-413 — encode ONCE to the stored quadruple; later proof
    and evaluation requests are served from it."""
    data = bytes.fromhex(msg["file"])
    n_pre, n_enc = msg["columns"], msg["encoded_columns"]
    if not data:
        return shared.error_response("cannot commit an empty file")
    if not online.dims_ok(n_pre, n_enc):
        return shared.error_response("Invalid rows or columns")
    fh = FileHandler.create_from_bytes(data, n_pre, n_enc, POS_FIELD,
                                       base=state.base, device=state.device)
    _register_handler(state, fh)
    meta = _meta_from_handler(fh, msg["filename"], fh.get_commit_root())
    state.db.put_file_metadata(SERVER_METADATA_TABLE, meta)
    return shared.compact_commit(meta)


def h_start_chunked(state, msg):
    """server.rs:416-443 + proper implementation of the todo!()."""
    ulid = new_ulid()
    paths = file_paths(ulid, state.base)
    n_pre, n_enc = msg["columns"], msg["encoded_columns"]
    if not online.dims_ok(n_pre, n_enc):
        return shared.error_response("Invalid rows or columns")
    writer = EncodedFileWriter(n_pre, n_enc, msg["total_file_size"],
                               paths["enc"], POS_FIELD, state.device)
    paths["raw"].write_bytes(b"")
    state.open_files[ulid] = writer
    state.open_file_info[ulid] = (msg["filename"], n_pre, n_enc)
    return shared.uploading_file_chunk_identifier(ulid)


def h_upload_chunk(state, msg):
    ulid = msg["file_ulid"]
    writer = state.open_files.get(ulid)
    if writer is None:
        return shared.error_response(
            "File does not exist, start a chunked upload first")
    chunk = bytes.fromhex(msg["chunk"])
    with open(file_paths(ulid, state.base)["raw"], "ab") as f:
        f.write(chunk)
    writer.push_bytes(chunk)
    if not msg["last_chunk"]:
        return shared.uploading_file_chunk_response(True)
    # finalize: tree + metadata + db entry + CompactCommit.  The quadruple
    # is complete on disk; proof serving attaches to it lazily.
    filename, n_pre, n_enc = state.open_file_info.pop(ulid)
    meta_enc, tree = writer.finalize_to_merkle_tree()
    meta_enc.ulid = ulid
    paths = file_paths(ulid, state.base)
    paths["tree"].write_bytes(tree.to_bytes())
    meta_enc.write_to_file(paths["meta"])
    del state.open_files[ulid]
    meta = FileMetadata(
        id_ulid=ulid, filename=filename,
        num_rows=meta_enc.rows_written, num_columns=n_pre,
        num_encoded_columns=n_enc, filesize_in_bytes=meta_enc.bytes_of_data,
        stored_server=ServerHost(), root=tree.root())
    state.db.put_file_metadata(SERVER_METADATA_TABLE, meta)
    return shared.compact_commit(meta)


def h_request_file(state, msg):
    meta = shared.parse_metadata(msg["file_metadata"])
    return shared.file_msg(_read_raw(state, meta))


def h_request_file_row(state, msg):
    meta = shared.parse_metadata(msg["file_metadata"])
    row = msg["row"]
    fh = _handler(state, meta)
    return shared.file_row_msg(fh.get_unencoded_row(row))


def h_edit_file_bytes(state, msg):
    """server.rs:497-565: copy to new ulid, apply edit, both kept until the
    client's EditOrAppendResponse — the edit re-encodes only the touched
    rows (FileHandler.edit_bytes); the copy takes the old handler's chunk-CV
    cache (built by one pass over the old file if it had none), so the edit
    re-hashes only the touched chunks."""
    meta = shared.parse_metadata(msg["file_metadata"])
    start = msg["start_byte"]
    replacement = bytes.fromhex(msg["replacement_bytes"])
    fh_old = _handler(state, meta)
    if start + len(replacement) > fh_old.total_data_bytes:
        return shared.error_response("edit out of bounds")
    fh_new = fh_old.clone_to_new_ulid(base=state.base)
    _, tree = fh_new.edit_bytes(start, replacement)
    _register_handler(state, fh_new)
    new_meta = _meta_from_handler(fh_new, meta.filename, tree.root())
    new_meta.stored_server = meta.stored_server
    state.db.put_file_metadata(SERVER_METADATA_TABLE, new_meta)
    return shared.compact_commit(new_meta)


def h_append_to_file(state, msg):
    """server.rs:568-636 via incremental append (only the new/partial rows
    are encoded; the copy's chunk-CV cache, taken from the old handler as
    for an edit, re-hashes only the changed tail)."""
    meta = shared.parse_metadata(msg["file_metadata"])
    add = bytes.fromhex(msg["append_data"])
    fh_old = _handler(state, meta)
    fh_new = fh_old.clone_to_new_ulid(base=state.base)
    tree = fh_new.append_bytes(add)
    _register_handler(state, fh_new)
    new_meta = _meta_from_handler(fh_new, meta.filename, tree.root())
    new_meta.stored_server = meta.stored_server
    state.db.put_file_metadata(SERVER_METADATA_TABLE, new_meta)
    return shared.compact_commit(new_meta)


def h_request_encoded_column(state, msg):
    """server.rs:212 dispatch; the reference's handler is unimplemented!()
    (server.rs:639-660).  Implemented: read one column of the stored
    encoded file (no re-encode) and return its field values."""
    meta = shared.parse_metadata(msg["file_metadata"])
    col = msg["row"]                     # reference names the index `row`
    fh = _handler(state, meta)
    if col >= fh.encoded_size:
        return shared.error_response("column out of range")
    vals = limbs_to_ints(fh.reader.get_encoded_column_without_path(col))
    return shared.encoded_column_msg(vals)


def h_request_proof(state, msg):
    """server.rs:652-693 — served from the stored encoded file + Merkle
    tree (contiguous column reads + stored paths) instead of the
    reference's full re-commit per request (server.rs:670-683)."""
    meta = shared.parse_metadata(msg["file_metadata"])
    requested = msg["columns_to_verify"]
    fh = _handler(state, meta)
    columns = fh.read_full_columns(requested)
    return shared.columns_msg(columns)


def h_request_poly_eval(state, msg):
    """server.rs:696-737: v = L^T M with left stride x^(i*n_cols), computed
    as encode(L^T . unencoded rows) — one batched left-multiply plus a
    single-row encode instead of a full re-commit."""
    meta = shared.parse_metadata(msg["file_metadata"])
    point = int(msg["evaluation_point"])
    fh = _handler(state, meta)
    left, _ = online.form_side_vectors(point, fh.rows_written,
                                       fh.encoded_size, POS_FIELD)
    v = fh.verifiable_polynomial_evaluation(left)
    return shared.polynomial_evaluation_msg(v)


def h_request_reshape(state, msg):
    """server.rs:794-831: same data re-encoded at new dims under a NEW
    ulid; both quadruples kept until the client's ReshapeResponse."""
    meta = shared.parse_metadata(msg["file_metadata"])
    new_pre = msg["new_pre_encoded_columns"]
    new_enc = msg["new_encoded_columns"]
    if not online.dims_ok(new_pre, new_enc):
        return shared.error_response("Invalid rows or columns")
    fh_old = _handler(state, meta)
    # raw-only clone: reshape regenerates enc/tree from raw anyway
    fh_new, tree = fh_old.clone_reshaped(new_pre, new_enc, base=state.base)
    _register_handler(state, fh_new)
    new_meta = _meta_from_handler(fh_new, meta.filename, tree.root())
    new_meta.stored_server = meta.stored_server
    state.db.put_file_metadata(SERVER_METADATA_TABLE, new_meta)
    return shared.compact_commit(new_meta)


def _eval_from_handler(state, meta, point, cols):
    """Evaluation + column openings served from the stored quadruple.
    Left stride here is x^(i*n_per_row) (the reference's differencing
    convention, server.rs:963-1055), unlike the plain-eval n_cols stride."""
    fh = _handler(state, meta)
    left, _ = online.form_side_vectors(point, fh.rows_written,
                                       fh.pre_encoded_size, POS_FIELD)
    v = fh.verifiable_polynomial_evaluation(left)
    columns = fh.read_full_columns(cols)
    return fh, v, columns


def h_request_reshape_eval(state, msg):
    """server.rs:834-906: both shapes of the same data."""
    old_meta = shared.parse_metadata(msg["old_file_metadata"])
    new_meta = shared.parse_metadata(msg["new_file_metadata"])
    point = int(msg["evaluation_point"])
    fh_old, old_v, old_cols = _eval_from_handler(
        state, old_meta, point, msg["columns_to_expand_original"])
    _, new_v, new_cols = _eval_from_handler(
        state, new_meta, point, msg["columns_to_expand_new"])
    data = _read_raw(state, old_meta)
    vals = limbs_to_ints(data_bytes_to_limbs_np(data, POS_FIELD))
    expected = online.evaluate_field_polynomial_at_point(vals, point, POS_FIELD)
    return shared.reshape_evaluation_msg(expected, old_v, old_cols, new_v, new_cols)


def h_request_append_eval(state, msg):
    """server.rs:963-1055, append branch.  The edited-row values are read
    as one byte slice of the new raw file instead of converting the whole
    file to field elements."""
    old_meta = shared.parse_metadata(msg["old_file_metadata"])
    new_meta = shared.parse_metadata(msg["new_file_metadata"])
    point = int(msg["evaluation_point"])
    cols = msg["columns_to_expand"]
    _, old_v, old_cols = _eval_from_handler(state, old_meta, point, cols)
    fh_new, new_v, new_cols = _eval_from_handler(state, new_meta, point, cols)
    cap = POS_FIELD.data_byte_capacity
    n_vals = ceildiv(fh_new.total_data_bytes, cap)
    start = (old_meta.num_rows - 1) * old_meta.num_columns
    if old_meta.num_rows < new_meta.num_rows:
        end = old_meta.num_rows * old_meta.num_columns - 1
    else:
        # reference divides by CAPACITY bits instead of bytes here
        # (server.rs:1040, a bug); use the working bound: the whole last row
        end = min(n_vals, start + old_meta.num_columns) - 1
    raw_slice = fh_new.get_unencoded_bytes(
        start * cap, min((end + 1) * cap, fh_new.total_data_bytes))
    edited_row = limbs_to_ints(data_bytes_to_limbs_np(raw_slice, POS_FIELD))
    return shared.append_evaluation_msg(old_v, old_cols, new_v, new_cols,
                                        edited_row[: end - start + 1])


def h_request_edit_eval(state, msg):
    """server.rs:963-1080, edit branch."""
    old_meta = shared.parse_metadata(msg["old_file_metadata"])
    new_meta = shared.parse_metadata(msg["new_file_metadata"])
    point = int(msg["evaluation_point"])
    cols = msg["columns_to_expand"]
    start, finish = msg["requested_unencoded_row_range_inclusive"]
    fh_old, old_v, old_cols = _eval_from_handler(state, old_meta, point, cols)
    _, new_v, new_cols = _eval_from_handler(state, new_meta, point, cols)
    cap = POS_FIELD.data_byte_capacity
    start_b = start * old_meta.num_columns * cap
    end_b = min((finish + 1) * old_meta.num_columns * cap - 1,
                fh_old.total_data_bytes)
    original_rows = fh_old.get_unencoded_bytes(start_b, end_b + 1)
    return shared.edit_evaluation_msg(old_v, old_cols, new_v, new_cols, original_rows)


def h_accept_or_reject(state, msg):
    """ReshapeResponse (server.rs:909-960) and EditOrAppendResponse
    (server.rs:1080-1136), with the intended transactional semantics: the
    loser's quadruple is dropped, the winner's kept as-is."""
    old_meta = shared.parse_metadata(msg["old_file_metadata"])
    new_meta = shared.parse_metadata(msg["new_file_metadata"])
    if msg["accepted"]:
        _drop_file(state, old_meta.id_ulid)
        state.db.delete(SERVER_METADATA_TABLE, old_meta.id_ulid)
        result = new_meta
    else:
        _drop_file(state, new_meta.id_ulid)
        state.db.delete(SERVER_METADATA_TABLE, new_meta.id_ulid)
        result = old_meta
    return shared.compact_commit(result)


def h_delete_file(state, msg):
    """server.rs:740-791."""
    meta = shared.parse_metadata(msg["file_metadata"])
    _drop_file(state, meta.id_ulid)
    state.db.delete(SERVER_METADATA_TABLE, meta.id_ulid)
    return shared.file_deleted(meta.filename)


async def serve(port: int, base: Path | None = None, db_path: str | None = None,
                device=None) -> asyncio.AbstractServer:
    """server_main (server.rs:83-109): bind 0.0.0.0:port, task per conn;
    the device work runs on `device` (default: the card where there is
    one)."""
    state = ServerState(base=base, db_path=db_path, device=device)

    async def on_conn(reader, writer):
        await handle_connection(state, reader, writer)

    server = await asyncio.start_server(on_conn, "0.0.0.0", port)
    return server


def server_main(port: int, base: Path | None = None, device=None) -> None:
    async def run():
        server = await serve(port, base, device=device)
        async with server:
            await server.serve_forever()

    asyncio.run(run())
