"""Wire protocol: length-delimited JSON messages over TCP.

Re-creation of proof-of-storage/src/networking/shared.rs: tokio's
LengthDelimitedCodec (4-byte big-endian length prefix) framing a JSON
payload.  All 21 client-message and 16 server-message variants are carried
as {"type": <VariantName>, ...fields} objects; field names match the Rust
enums so the wire format is structurally equivalent.
"""

from __future__ import annotations

import asyncio
import json

from ..database import FileMetadata

MAX_FRAME = 1 << 31


async def send_msg(writer: asyncio.StreamWriter, msg: dict) -> None:
    payload = json.dumps(msg).encode()
    writer.write(len(payload).to_bytes(4, "big") + payload)
    await writer.drain()


async def recv_msg(reader: asyncio.StreamReader) -> dict | None:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    length = int.from_bytes(header, "big")
    if length > MAX_FRAME:
        raise ValueError("oversized frame")
    try:
        payload = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return json.loads(payload)


# -- message constructors (ClientMessages, shared.rs:36-134) ----------------

def _m(type_: str, **fields) -> dict:
    fields["type"] = type_
    return fields


def new_user(username, password):
    return _m("NewUser", username=username, password=password)


def user_login(username, password):
    return _m("UserLogin", username=username, password=password)


def upload_new_file(filename: str, file: bytes, columns: int, encoded_columns: int):
    return _m("UploadNewFile", filename=filename, file=file.hex(),
              columns=columns, encoded_columns=encoded_columns)


def start_upload_new_file_by_chunks(filename, columns, encoded_columns, total_file_size):
    return _m("StartUploadNewFileByChunks", filename=filename, columns=columns,
              encoded_columns=encoded_columns, total_file_size=total_file_size)


def upload_file_chunk(file_ulid, chunk: bytes, last_chunk: bool):
    return _m("UploadFileChunk", file_ulid=file_ulid, chunk=chunk.hex(),
              last_chunk=last_chunk)


def request_file(metadata: FileMetadata):
    return _m("RequestFile", file_metadata=metadata.to_json())


def request_file_row(metadata: FileMetadata, row: int):
    return _m("RequestFileRow", file_metadata=metadata.to_json(), row=row)


def edit_file_bytes(metadata: FileMetadata, start_byte: int, replacement: bytes):
    return _m("EditFileBytes", file_metadata=metadata.to_json(),
              start_byte=start_byte, replacement_bytes=replacement.hex())


def append_to_file(metadata: FileMetadata, append_data: bytes):
    return _m("AppendToFile", file_metadata=metadata.to_json(),
              append_data=append_data.hex())


def request_encoded_column(metadata: FileMetadata, row: int):
    return _m("RequestEncodedColumn", file_metadata=metadata.to_json(), row=row)


def request_proof(metadata: FileMetadata, columns_to_verify: list[int]):
    return _m("RequestProof", file_metadata=metadata.to_json(),
              columns_to_verify=columns_to_verify)


def request_polynomial_evaluation(metadata: FileMetadata, evaluation_point: int):
    return _m("RequestPolynomialEvaluation", file_metadata=metadata.to_json(),
              evaluation_point=str(evaluation_point))


def request_file_reshape(metadata: FileMetadata, new_pre: int, new_enc: int):
    return _m("RequestFileReshape", file_metadata=metadata.to_json(),
              new_pre_encoded_columns=new_pre, new_encoded_columns=new_enc)


def request_reshape_evaluation(old_meta, new_meta, point: int,
                               cols_original: list[int], cols_new: list[int]):
    return _m("RequestReshapeEvaluation", old_file_metadata=old_meta.to_json(),
              new_file_metadata=new_meta.to_json(), evaluation_point=str(point),
              columns_to_expand_original=cols_original,
              columns_to_expand_new=cols_new)


def reshape_response(new_meta, old_meta, accepted: bool):
    return _m("ReshapeResponse", new_file_metadata=new_meta.to_json(),
              old_file_metadata=old_meta.to_json(), accepted=accepted)


def request_append_evaluation(old_meta, new_meta, point: int, cols: list[int]):
    return _m("RequestAppendEvaluation", old_file_metadata=old_meta.to_json(),
              new_file_metadata=new_meta.to_json(), evaluation_point=str(point),
              columns_to_expand=cols)


def request_edit_evaluation(old_meta, new_meta, point: int, cols: list[int],
                            row_range_inclusive: tuple[int, int]):
    return _m("RequestEditEvaluation", old_file_metadata=old_meta.to_json(),
              new_file_metadata=new_meta.to_json(), evaluation_point=str(point),
              columns_to_expand=cols,
              requested_unencoded_row_range_inclusive=list(row_range_inclusive))


def edit_or_append_response(new_meta, old_meta, accepted: bool):
    return _m("EditOrAppendResponse", new_file_metadata=new_meta.to_json(),
              old_file_metadata=old_meta.to_json(), accepted=accepted)


def delete_file(metadata: FileMetadata):
    return _m("DeleteFile", file_metadata=metadata.to_json())


def client_keep_alive():
    return _m("ClientKeepAlive")


# -- server messages (shared.rs:136-196) ------------------------------------

def user_login_response(success: bool):
    return _m("UserLoginResponse", success=success)


def uploading_file_chunk_identifier(file_ulid: str):
    return _m("UploadingFileChunkIdentifier", file_ulid=file_ulid)


def uploading_file_chunk_response(data_ok: bool):
    return _m("UploadingFileChunkResponse", data_ok=data_ok)


def compact_commit(metadata: FileMetadata):
    return _m("CompactCommit", file_metadata=metadata.to_json())


def columns_msg(columns) -> dict:
    from ...utils.serde import column_to_json
    return _m("Columns", columns=[column_to_json(c) for c in columns])


def file_msg(data: bytes):
    return _m("File", file=data.hex())


def file_row_msg(row: bytes):
    return _m("FileRow", row=row.hex())


def encoded_column_msg(col: list[int]):
    return _m("EncodedColumn", col=[str(v) for v in col])


def polynomial_evaluation_msg(result: list[int]):
    return _m("PolynomialEvaluation", evaluation_result=[str(v) for v in result])


def reshape_evaluation_msg(expected_result: int, orig_v, orig_cols, new_v, new_cols):
    from ...utils.serde import column_to_json
    return _m("ReshapeEvaluation", expected_result=str(expected_result),
              original_result_vector=[str(v) for v in orig_v],
              original_columns=[column_to_json(c) for c in orig_cols],
              new_result_vector=[str(v) for v in new_v],
              new_columns=[column_to_json(c) for c in new_cols])


def append_evaluation_msg(orig_v, orig_cols, new_v, new_cols, edited_row: list[int]):
    from ...utils.serde import column_to_json
    return _m("AppendEvaluation",
              original_result_vector=[str(v) for v in orig_v],
              original_columns=[column_to_json(c) for c in orig_cols],
              new_result_vector=[str(v) for v in new_v],
              new_columns=[column_to_json(c) for c in new_cols],
              edited_unencoded_row=[str(v) for v in edited_row])


def edit_evaluation_msg(orig_v, orig_cols, new_v, new_cols, original_rows: bytes):
    from ...utils.serde import column_to_json
    return _m("EditEvaluation",
              original_result_vector=[str(v) for v in orig_v],
              original_columns=[column_to_json(c) for c in orig_cols],
              new_result_vector=[str(v) for v in new_v],
              new_columns=[column_to_json(c) for c in new_cols],
              original_unencoded_rows=original_rows.hex())


def server_keep_alive():
    return _m("ServerKeepAlive")


def file_deleted(filename: str):
    return _m("FileDeleted", filename=filename)


def error_response(error: str):
    return _m("ErrorResponse", error=error)


# -- parse helpers ----------------------------------------------------------

def parse_metadata(obj: dict) -> FileMetadata:
    return FileMetadata.from_json(obj)


def parse_columns(objs: list[dict]):
    from ...utils.serde import column_from_json
    from ..online import POS_FIELD
    return [column_from_json(o, POS_FIELD) for o in objs]
