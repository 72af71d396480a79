"""Online commitment/verification helpers for the PoR protocol.

Counterpart of ``lcpc_proof_of_storage_tpu/pos/online.py`` (a re-creation
of proof-of-storage/src/lcpc_online.rs): one-shot conversion of file data
into commitments and leaves, client-side verification of column
openings against roots, PoS soundness sizing, and verifiable polynomial
evaluation.  The device steps run on `device` (default: the card where
there is one): the one-shot commit (K1, K2), the streamed leaves of the
requested columns (K1, K2's chunk CVs and merge), the evaluation collapse
(K3) and the decode of a result vector (K4's inverse entry).

PoS defaults (src/lib.rs:19-24): field = writeable_ft63, code = Ligero,
digest = Blake3.
"""

from __future__ import annotations

import math

import torch

from ..codes.ligero import LigeroEncoding
from ..core.commit import LcColumn, LcCommit, commit, default_device, open_column
from ..crypto.blake3_ref import blake3
from ..crypto.chacha import chacha8_rng_from_u64, choose_multiple
from ..fields.field import FieldSpec, WRITEABLE_FT63, limbs_to_ints
from ..fields.limb import limb_field
from ..ops.blake3 import digests_to_bytes
from ..ops.collapse import collapse
from ..ops.ntt import intt
from .storage import (ColumnDigestAccumulator, aligned_batch_rows, bytes_tensor, ceildiv,
                      data_bytes_to_limbs, encode_data, ntt_tables, target_rows)

POS_FIELD = WRITEABLE_FT63

# client.rs:47 — the fixed challenge seed of the reference protocol
FIXED_RANDOM_SEED_CHANGE_LATER = 1337


class VerificationError(Exception):
    pass


# -- dimensions -------------------------------------------------------------

def dims_ok(n_pre: int, n_enc: int) -> bool:
    """lcpc_online.rs:70-77."""
    return (n_enc & (n_enc - 1) == 0 and n_pre >= 1 and n_enc >= 2
            and n_enc >= 2 * n_pre)


def square_dims(data_len: int) -> tuple[int, int]:
    """CommitDimensions::Square (lcpc_online.rs:120-129)."""
    width = math.ceil(math.sqrt(data_len))
    if width & (width - 1) != 0:
        width = 1 << (width - 1).bit_length()
    n_pre = max(width, 1)
    n_enc = 1 << n_pre.bit_length()   # next_power_of_two(n_pre + 1)
    return n_pre, n_enc


def get_aspect_ratio_default_from_field_len(field_len: int) -> tuple[int, int, int]:
    """server.rs:1139-1158: (pre, enc, rows) from √len."""
    n_pre, n_enc = square_dims(field_len)
    return n_pre, n_enc, ceildiv(field_len, n_pre)


def get_aspect_ratio_default_from_file_len(file_len: int, spec: FieldSpec = POS_FIELD):
    return get_aspect_ratio_default_from_field_len(
        ceildiv(file_len, spec.data_byte_capacity))


# -- soundness --------------------------------------------------------------

def get_pos_soundness_n_cols(n_pre: int, n_enc: int) -> int:
    """lcpc_online.rs:358-368."""
    den = math.log2((1.0 + n_pre / n_enc) / 2.0)
    return min(math.ceil(-128.0 / den), n_enc)


def get_column_indices_from_random_seed(seed: int, n_cols_required: int,
                                        n_cols_total: int) -> list[int]:
    """client.rs:443-456: ChaCha8 reservoir sample without replacement."""
    rng = chacha8_rng_from_u64(seed)
    return choose_multiple(rng, n_cols_total, n_cols_required)


# -- one-shot conversions (convert_file_data_to_commit) ---------------------

def pos_encoding(n_pre: int, n_enc: int, spec: FieldSpec = POS_FIELD) -> LigeroEncoding:
    return LigeroEncoding.new_from_dims(n_pre, n_enc, spec)


def commit_file_data(data: bytes, n_pre: int, n_enc: int,
                     spec: FieldSpec = POS_FIELD, device=None) -> LcCommit:
    """CommitRequestType::Commit path: the data's limbs are made on the
    device and committed there."""
    if not data:
        raise ValueError("cannot convert empty file to commit")
    dev = default_device(device)
    limbs = data_bytes_to_limbs(bytes_tensor(data, dev), spec)
    return commit(limbs, pos_encoding(n_pre, n_enc, spec), dev)


def leaves_for_file_data(data: bytes, n_pre: int, n_enc: int,
                         requested: list[int],
                         spec: FieldSpec = POS_FIELD, device=None) -> list[bytes]:
    """CommitRequestType::Leaves: the requested columns' digests of the
    one-shot commit."""
    comm = commit_file_data(data, n_pre, n_enc, spec, device)
    idx = torch.tensor(list(requested), dtype=torch.int64, device=comm.device)
    return digests_to_bytes(comm.hashes[idx])


def streaming_leaves_for_file(path, n_pre: int, n_enc: int,
                              requested: list[int],
                              spec: FieldSpec = POS_FIELD, device=None) -> list[bytes]:
    """leaves_for_file_data without holding the file: row batches that end
    on chunk boundaries of the column streams are read from disk, encoded on
    the device (K1), cut to the requested columns and hashed into their
    chunk CVs (K2), merged at the end.  Bit-identical to
    leaves_for_file_data (the streamed-vs-monolithic oracle family,
    row_generator_iter.rs:237-284); the reference's client reads the whole
    file and commits it in RAM even in chunked mode (client.rs:70-83)."""
    dev = default_device(device)
    row_bytes = n_pre * spec.data_byte_capacity
    tables = ntt_tables(spec, n_enc, dev)
    target = target_rows(n_enc, spec)
    acc = ColumnDigestAccumulator(n_enc, spec, columns=list(requested), device=dev)
    rows_done = 0
    with open(path, "rb") as f:
        while True:
            data = f.read(row_bytes * aligned_batch_rows(rows_done, spec.repr_bytes, target))
            if not data:
                break
            encoded = encode_data(data, spec, n_pre, tables)
            acc.update_batch(encoded)
            rows_done += encoded.shape[0]
    if not rows_done:
        raise ValueError("cannot convert empty file to commit")
    return acc.get_column_digests()


def columns_with_path_for_file_data(data: bytes, n_pre: int, n_enc: int,
                                    requested: list[int], spec: FieldSpec = POS_FIELD,
                                    device=None) -> list[LcColumn]:
    """The requested columns, with their Merkle paths, of the one-shot
    commit of the data."""
    comm = commit_file_data(data, n_pre, n_enc, spec, device)
    return [open_column(comm, c) for c in requested]


def server_retrieve_columns(comm: LcCommit, requested: list[int]) -> list[LcColumn]:
    return [open_column(comm, c) for c in requested]


# -- client-side verification ----------------------------------------------

def hash_field_vec_to_digest(vals: list[int], spec: FieldSpec = POS_FIELD) -> bytes:
    msg = b"\x00" * 32 + b"".join(spec.to_repr(v) for v in vals)
    return blake3(msg)


def hash_column_to_digest(col: LcColumn, spec: FieldSpec = POS_FIELD) -> bytes:
    return hash_field_vec_to_digest(col.col, spec)


def verify_column_paths(root: bytes, requested: list[int],
                        columns: list[LcColumn], spec: FieldSpec = POS_FIELD) -> None:
    """client_online_verify_column_paths (lcpc_online.rs:250-277)."""
    if len(columns) != len(requested):
        raise VerificationError("column count mismatch")
    for col_num, col in zip(requested, columns):
        h = hash_column_to_digest(col, spec)
        if not _fold_path(h, col.path, col_num) == root:
            raise VerificationError(f"merkle path failed for column {col_num}")


def verify_column_paths_without_full_columns(
        root: bytes, requested: list[int], digests: list[bytes],
        paths: list[list[bytes]]) -> None:
    """lcpc_online.rs:280-318: each column's digest folded up its path is
    the root."""
    if len(paths) != len(requested):
        raise VerificationError("path count mismatch")
    for col_num, digest, path in zip(requested, digests, paths):
        if _fold_path(digest, path, col_num) != root:
            raise VerificationError(f"merkle path failed for column {col_num}")


def _fold_path(leaf: bytes, path: list[bytes], index: int) -> bytes:
    h = leaf
    for p in path:
        h = blake3(h + p) if index % 2 == 0 else blake3(p + h)
        index >>= 1
    return h


def verify_column_leaves(local_leaves: list[bytes], requested: list[int],
                         received_leaves: list[bytes]) -> None:
    """lcpc_online.rs:321-356."""
    if len(local_leaves) != len(requested) or len(received_leaves) != len(requested):
        raise VerificationError("leaf count mismatch")
    if local_leaves != received_leaves:
        raise VerificationError("column leaves do not match")


def client_verify_commitment(root: bytes, local_leaves: list[bytes],
                             requested: list[int], columns: list[LcColumn],
                             required_for_soundness: int,
                             spec: FieldSpec = POS_FIELD) -> None:
    """lcpc_online.rs:370-402."""
    if (required_for_soundness < len(local_leaves)
            or required_for_soundness < len(requested)
            or required_for_soundness < len(columns)):
        raise VerificationError("too many columns supplied")
    received = [hash_column_to_digest(c, spec) for c in columns]
    verify_column_leaves(local_leaves, requested, received)
    verify_column_paths(root, requested, columns, spec)


def client_verify_commitment_without_full_columns(
        root: bytes, local_leaves: list[bytes], requested: list[int],
        received_digests: list[bytes], received_paths: list[list[bytes]],
        required_for_soundness: int) -> None:
    """client_verify_commitment with the columns' digests and paths in place
    of the columns."""
    if (required_for_soundness < len(local_leaves)
            or required_for_soundness < len(requested)
            or required_for_soundness < len(received_digests)):
        raise VerificationError("too many columns supplied")
    verify_column_leaves(local_leaves, requested, received_digests)
    verify_column_paths_without_full_columns(root, requested, received_digests, received_paths)


# -- verifiable polynomial evaluation ---------------------------------------

def form_side_vectors(point: int, n_rows: int, n_cols: int,
                      spec: FieldSpec = POS_FIELD) -> tuple[list[int], list[int]]:
    """lcpc_online.rs:603-627: L = [1, x^n, x^2n, ...], R = [1, x, x^2...]."""
    p = spec.modulus
    right = [1] * n_cols
    acc = 1
    for i in range(n_cols):
        right[i] = acc
        acc = (acc * point) % p
    xn = acc                     # x^n_cols
    left = [1] * n_rows
    acc = 1
    for i in range(n_rows):
        left[i] = acc
        acc = (acc * xn) % p
    return left, right


def verifiable_polynomial_evaluation(comm: LcCommit, left: list[int],
                                     spec: FieldSpec = POS_FIELD) -> list[int]:
    """Server: v = L^T . encoded matrix (lcpc_online.rs:454-484), the
    collapse (K3 on CUDA) of the commitment's encoded matrix on its
    device."""
    t = limb_field(spec).array(left, comm.device)[None]
    return limbs_to_ints(collapse(comm.comm, t, spec)[0].cpu().numpy())


def verify_proper_partial_polynomial_evaluation(
        left: list[int], result_vector: list[int], requested: list[int],
        columns: list[LcColumn], spec: FieldSpec = POS_FIELD) -> None:
    """lcpc_online.rs:487-515: per opened column, <L, col> == v[col]."""
    p = spec.modulus
    for col_num, col in zip(requested, columns):
        expected = 0
        for a, b in zip(left, col.col):
            expected = (expected + a * b) % p
        if expected != result_vector[col_num] % p:
            raise VerificationError(f"partial evaluation failed at column {col_num}")


def verify_full_polynomial_evaluation(
        point: int, result_vector: list[int], n_rows: int, n_cols: int,
        n_pre: int, requested: list[int], columns: list[LcColumn],
        spec: FieldSpec = POS_FIELD, device=None) -> int:
    """Intended semantics of the reference's (non-compiling)
    verifiable_full_polynomial_evaluation (lcpc_online.rs:519-566 + SURVEY
    §7 hard part 6): check the opened columns against the encoded result
    vector, decode it, and return <decoded, R[:n_pre]>."""
    left, right = form_side_vectors(point, n_rows, n_cols, spec)
    verify_proper_partial_polynomial_evaluation(
        left, result_vector, requested, columns, spec)
    decoded = decode_row(result_vector, spec, device)[:n_pre]
    p = spec.modulus
    acc = 0
    for a, b in zip(decoded, right[:n_pre]):
        acc = (acc + a * b) % p
    return acc


def decode_row(vals: list[int], spec: FieldSpec = POS_FIELD, device=None) -> list[int]:
    """Inverse NTT decode (lcpc_online.rs:568-574) on `device` (K4's
    inverse entry on CUDA); values are read mod p."""
    dev = default_device(device)
    arr = limb_field(spec).array([v % spec.modulus for v in vals], dev)[None]
    return limbs_to_ints(intt(arr, spec, ntt_tables(spec, len(vals), dev))[0].cpu().numpy())


# -- polynomial helpers (fields.rs:162-194) ---------------------------------

def evaluate_field_polynomial_at_point(coeffs: list[int], point: int,
                                       spec: FieldSpec = POS_FIELD) -> int:
    p = spec.modulus
    result, power = 0, 1
    for c in coeffs:
        result = (result + c * power) % p
        power = (power * point) % p
    return result


def evaluate_field_polynomial_at_point_with_elevated_degree(
        coeffs: list[int], point: int, degree_offset: int,
        spec: FieldSpec = POS_FIELD) -> int:
    p = spec.modulus
    result, power = 0, pow(point, degree_offset, p)
    for c in coeffs:
        result = (result + c * power) % p
        power = (power * point) % p
    return result


def vector_multiply(a: list[int], b: list[int], spec: FieldSpec = POS_FIELD) -> int:
    p = spec.modulus
    return sum(x * y for x, y in zip(a, b)) % p
