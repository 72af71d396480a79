"""Binary + JSON serialization of proof and commitment objects.

A copy of the JAX package's ``utils/serde.py`` for the port's proof and
commitment types (``core/commit.py``).  It mirrors the reference's serde
wrappers (lcpc-2d/src/lib.rs:193-283, 376-420, 455-512, 559-638:
WrappedLcCommit/WrappedOutput/WrappedLcColumn/WrappedLcEvalProof) in the
bincode-1 fixed-int layout the reference uses on the wire (bincode 1.3: u64 little-endian lengths, fields in declaration
order, fixed-size arrays without length prefixes).

Field elements serialize as the reference's `[u64; limbs]` inner array.
(ff_derive serializes the raw Montgomery limbs; we serialize the canonical
value's u64 limbs — an equivalent fixed-width layout, see
fields/field.py notes on Montgomery form.)
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..core.commit import LcColumn, LcCommit, LcEvalProof, _LimbRow, default_device
from ..fields.field import FieldSpec, ints_to_limbs, limbs_to_ints
from ..ops.blake3 import bytes_to_digest, digests_to_bytes


# -- primitives -------------------------------------------------------------

def write_u64(buf: io.BytesIO, v: int) -> None:
    buf.write(v.to_bytes(8, "little"))


def read_u64(buf: io.BytesIO) -> int:
    return int.from_bytes(buf.read(8), "little")


def write_bytes(buf: io.BytesIO, data: bytes) -> None:
    write_u64(buf, len(data))
    buf.write(data)


def read_bytes(buf: io.BytesIO) -> bytes:
    n = read_u64(buf)
    return buf.read(n)


def write_field(buf: io.BytesIO, v: int, spec: FieldSpec) -> None:
    # [u64; limbs] little-endian limb order (canonical value)
    buf.write(v.to_bytes(8 * spec.u64_limbs, "little"))


def read_field(buf: io.BytesIO, spec: FieldSpec) -> int:
    v = int.from_bytes(buf.read(8 * spec.u64_limbs), "little")
    if v >= spec.modulus:
        raise ValueError("non-canonical field element")
    return v


def write_field_vec(buf: io.BytesIO, vals: list[int], spec: FieldSpec) -> None:
    write_u64(buf, len(vals))
    for v in vals:
        write_field(buf, v, spec)


def read_field_vec(buf: io.BytesIO, spec: FieldSpec) -> list[int]:
    n = read_u64(buf)
    return [read_field(buf, spec) for _ in range(n)]


def _read_field_vec_limbs(buf: io.BytesIO, spec: FieldSpec):
    """read_field_vec that ALSO yields the (n, L) uint32 limb array when the
    wire bytes are the 16-bit limb buffer (every shipped field): the bytes
    parse vectorized and verify() reuses the limbs instead of re-converting
    ~470k python ints per Brakedown 2^25 proof.  -> (ints, limbs | None)."""
    n = read_u64(buf)
    if not _limb_wire_width_ok(spec):
        return [read_field(buf, spec) for _ in range(n)], None
    W8 = 8 * spec.u64_limbs
    raw = buf.read(n * W8)
    if len(raw) != n * W8:
        raise ValueError("truncated field vector")
    le = np.frombuffer(raw, "<u2").reshape(n, spec.num_limbs16)
    _check_canonical_rows(le, spec)
    limbs = le.astype(np.uint32)
    return limbs_to_ints(limbs), limbs


def _write_field_vec_limbs(buf: io.BytesIO, vals: list[int], spec: FieldSpec,
                           limbs=None) -> None:
    """write_field_vec from an attached limb array when available (one
    numpy astype+tobytes instead of per-value int.to_bytes)."""
    if (limbs is not None and _limb_wire_width_ok(spec)
            and limbs.shape == (len(vals), spec.num_limbs16)):
        write_u64(buf, len(vals))
        buf.write(np.ascontiguousarray(
            np.asarray(limbs, np.uint32).astype("<u2")).tobytes())
    else:
        write_field_vec(buf, vals, spec)


# -- proof objects ----------------------------------------------------------

def serialize_root(root: bytes) -> bytes:
    """WrappedOutput { bytes } (lcpc-2d/src/lib.rs:376-420)."""
    buf = io.BytesIO()
    write_bytes(buf, root)
    return buf.getvalue()


def deserialize_root(data: bytes) -> bytes:
    return read_bytes(io.BytesIO(data))


def serialize_column(column, spec: FieldSpec) -> bytes:
    buf = io.BytesIO()
    _write_column(buf, column, spec)
    return buf.getvalue()


def _limb_wire_width_ok(spec: FieldSpec) -> bool:
    """True when the bincode field repr (8*u64_limbs LE bytes) IS the
    16-bit limb buffer — every shipped field; guards exotic widths."""
    return 2 * spec.num_limbs16 == 8 * spec.u64_limbs


def _check_canonical_rows(le: np.ndarray, spec: FieldSpec) -> None:
    """Vectorized v < p over (n, L) '<u2' rows (same big-endian limb scan
    as read_field's per-value check); raises like read_field."""
    p_limbs = np.frombuffer(
        spec.modulus.to_bytes(2 * le.shape[-1], "little"), "<u2")
    lt = np.zeros(len(le), bool)
    decided = np.zeros(len(le), bool)
    for j in reversed(range(le.shape[-1])):
        a = le[:, j]
        lt |= ~decided & (a < p_limbs[j])
        decided |= a != p_limbs[j]
    if not lt.all():
        raise ValueError("non-canonical field element")


def _write_column(buf: io.BytesIO, column, spec: FieldSpec) -> None:
    # limb fast path: the LE wire bytes ARE the 16-bit limb buffer, so a
    # prover-built column (limbs, ints never materialized) serializes as
    # one numpy astype+tobytes instead of per-value int.to_bytes —
    # Brakedown proofs carry ~1M values (6593 cols x 143 rows at 2^25)
    limbs = column._limbs if column._col is None else None
    if limbs is not None and _limb_wire_width_ok(spec):
        write_u64(buf, limbs.shape[0])
        buf.write(np.ascontiguousarray(
            np.asarray(limbs, np.uint32).astype("<u2")).tobytes())
    else:
        write_field_vec(buf, column.col, spec)
    if column._path is None and column._sibs is not None:
        # lazy path: wire bytes straight from the packed sibling row
        # (u64 len prefix + 32 bytes per level, same as write_bytes)
        row = column._sibs[column._sibi]
        depth = row.shape[0]
        write_u64(buf, depth)
        out = np.empty((depth, 40), np.uint8)
        out[:, :8] = np.frombuffer((32).to_bytes(8, "little"), np.uint8)
        out[:, 8:] = row
        buf.write(out.tobytes())
    else:
        write_u64(buf, len(column.path))
        for p in column.path:
            write_bytes(buf, p)


def _read_column(buf: io.BytesIO, spec: FieldSpec, out_limbs=None):
    """out_limbs: optional (n_rows, L) uint32 destination row of a packed
    proof array — filled with the column limbs when the fast path applies
    (caller pre-sizes it from the first column)."""
    n = read_u64(buf)
    col = None
    limbs = None
    if _limb_wire_width_ok(spec):
        W8 = 8 * spec.u64_limbs
        raw = buf.read(n * W8)
        if len(raw) != n * W8:
            raise ValueError("truncated column")
        le = np.frombuffer(raw, "<u2").reshape(n, spec.num_limbs16)
        _check_canonical_rows(le, spec)
        if out_limbs is not None and out_limbs.shape == le.shape:
            out_limbs[:] = le
            limbs = out_limbs
        else:
            limbs = le.astype(np.uint32)
    else:
        # the length prefix `n` is already consumed above — read the vector
        # body directly (read_field_vec would consume a second u64 length
        # and misparse the stream)
        col = [read_field(buf, spec) for _ in range(n)]
    k = read_u64(buf)
    path = [read_bytes(buf) for _ in range(k)]
    if limbs is not None:
        return LcColumn(col_limbs=limbs, spec=spec, path=path)
    return LcColumn(col=col, path=path)


def deserialize_column(data: bytes, spec: FieldSpec):
    return _read_column(io.BytesIO(data), spec)


def serialize_proof(proof, spec: FieldSpec) -> bytes:
    """WrappedLcEvalProof layout: n_cols, p_eval, p_random_vec, columns."""
    buf = io.BytesIO()
    # prove()/serde ship rows as limb-backed _LimbRow lists — the wire
    # bytes then come straight out of numpy
    write_u64(buf, proof.n_cols)
    _write_field_vec_limbs(buf, proof.p_eval, spec,
                           limbs=getattr(proof.p_eval, "_limbs", None))
    write_u64(buf, len(proof.p_random_vec))
    for v in proof.p_random_vec:
        _write_field_vec_limbs(buf, v, spec,
                               limbs=getattr(v, "_limbs", None))
    write_u64(buf, len(proof.columns))
    for c in proof.columns:
        _write_column(buf, c, spec)
    return buf.getvalue()


def serialized_proof_len(n_rows: int, n_per_row: int, n_cols: int, n_degree_tests: int,
                         n_col_opens: int, spec: FieldSpec) -> int:
    """Bytes of :func:`serialize_proof` for a proof of these dims: n_cols;
    p_eval and each degree-test row as a length and n_per_row field values;
    each opened column as a length, n_rows values, a length and a path of
    ceil(log2 n_cols) length-prefixed 32-byte digests."""
    value = 8 * spec.u64_limbs
    depth = (n_cols - 1).bit_length() if n_cols > 1 else 0
    row = 8 + n_per_row * value
    column = 8 + n_rows * value + 8 + depth * (8 + 32)
    return 8 + row + 8 + n_degree_tests * row + 8 + n_col_opens * column


def deserialize_proof(data: bytes, spec: FieldSpec):
    buf = io.BytesIO(data)
    n_cols = read_u64(buf)
    p_eval = _LimbRow(*_read_field_vec_limbs(buf, spec))
    ndt = read_u64(buf)
    if ndt * 8 > len(data) - buf.tell():
        raise ValueError("proof declares more degree-test rows than the "
                         "buffer can hold")
    p_random_vec = [_LimbRow(*_read_field_vec_limbs(buf, spec))
                    for _ in range(ndt)]
    ncols_open = read_u64(buf)
    # every serialized column costs at least two u64 length prefixes, so an
    # untrusted count beyond that is rejected before any loop/allocation
    if ncols_open * 16 > len(data) - buf.tell():
        raise ValueError("proof declares more columns than the buffer "
                         "can hold")
    columns = []
    packed = None
    for i in range(ncols_open):
        if i == 0:
            c0 = _read_column(buf, spec)
            columns.append(c0)
            if c0._limbs is not None and ncols_open > 1:
                # bound the untrusted wire count by what the remaining
                # bytes could possibly hold (>= 16-byte length prefixes +
                # column body each) before allocating the packed array — a
                # malicious ncols_open=2^40 must not drive a huge np.empty
                body = 16 + c0._limbs.shape[0] * 8 * spec.u64_limbs
                remaining = len(data) - buf.tell()
                if (ncols_open - 1) * body > remaining:
                    raise ValueError("proof declares more columns than the "
                                     "buffer can hold")
                packed = np.empty((ncols_open,) + c0._limbs.shape, np.uint32)
                packed[0] = c0._limbs
                c0._limbs = packed[0]
        else:
            columns.append(_read_column(
                buf, spec, None if packed is None else packed[i]))
    proof = LcEvalProof(n_cols=n_cols, p_eval=p_eval,
                        p_random_vec=p_random_vec, columns=columns)
    if columns:
        depth = len(columns[0].path)
        if (depth and all(len(c.path) == depth for c in columns)
                and all(len(p) == 32 for c in columns for p in c.path)):
            proof._paths_packed = np.frombuffer(
                b"".join(p for c in columns for p in c.path),
                np.uint8).reshape(len(columns), depth, 32)
            # re-back every column lazily on the packed array (it was just
            # built from these exact bytes): verify's fold then takes the
            # packed fast path; any later .path mutation re-materializes
            # and forfeits it (core/commit.py verify)
            for i, c in enumerate(columns):
                c._path = None
                c._sibs = proof._paths_packed
                c._sibi = i
    return proof


def _write_limb_matrix(buf: io.BytesIO, store, width: int, spec: FieldSpec) -> None:
    """The first `width` columns of a commitment's limb matrix, row-major, as
    one field vector (a wide Brakedown matrix keeps zero columns past
    n_cols, which the one-device commitment does not have)."""
    limbs = store.gather(range(width)).reshape(-1, spec.num_limbs16)
    if _limb_wire_width_ok(spec):
        write_u64(buf, limbs.shape[0])
        buf.write(np.ascontiguousarray(limbs.astype("<u2")).tobytes())
    else:
        write_field_vec(buf, limbs_to_ints(limbs), spec)


def serialize_commit(comm: LcCommit, spec: FieldSpec) -> bytes:
    """WrappedLcCommit layout: comm, coeffs, n_rows, n_cols, n_per_row,
    hashes (lcpc-2d/src/lib.rs:193-204), the matrices read from wherever the
    commitment keeps them (``core/storage.py``)."""
    if comm.comm_rows is None or comm.coeff_rows is None:
        raise ValueError("serialize_commit: the commitment keeps no encoded matrix or no "
                         "coefficients")
    buf = io.BytesIO()
    _write_limb_matrix(buf, comm.comm_rows, comm.n_cols, spec)
    _write_limb_matrix(buf, comm.coeff_rows, comm.n_per_row, spec)
    write_u64(buf, comm.n_rows)
    write_u64(buf, comm.n_cols)
    write_u64(buf, comm.n_per_row)
    hashes = digests_to_bytes(comm.hashes)
    write_u64(buf, len(hashes))
    for h in hashes:
        write_bytes(buf, h)
    return buf.getvalue()


def deserialize_commit(data: bytes, spec: FieldSpec, device=None) -> LcCommit:
    """The commitment of :func:`serialize_commit`, its matrices as int32
    limbs and its Merkle array on `device` (default: :func:`default_device`,
    the current CUDA card; ``device="cpu"`` for the host)."""
    import torch
    device = default_device(device)
    buf = io.BytesIO(data)
    comm_vals, comm_limbs = _read_field_vec_limbs(buf, spec)
    coeff_vals, coeff_limbs = _read_field_vec_limbs(buf, spec)
    n_rows = read_u64(buf)
    n_cols = read_u64(buf)
    n_per_row = read_u64(buf)
    hashes = torch.stack([bytes_to_digest(read_bytes(buf)) for _ in range(read_u64(buf))])

    def matrix(vals, limbs, width):
        if limbs is None:
            limbs = ints_to_limbs(vals, spec)
        return torch.from_numpy(np.asarray(limbs, np.int32).reshape(n_rows, width, -1)).to(device)

    return LcCommit(coeffs=matrix(coeff_vals, coeff_limbs, n_per_row),
                    comm=matrix(comm_vals, comm_limbs, n_cols), n_rows=n_rows,
                    n_cols=n_cols, n_per_row=n_per_row, hashes=hashes.to(device))


# -- JSON variants (networking wire format) ---------------------------------

def proof_to_json(proof, spec: FieldSpec) -> dict:
    return {
        "n_cols": proof.n_cols,
        "p_eval": [str(v) for v in proof.p_eval],
        "p_random_vec": [[str(v) for v in vec] for vec in proof.p_random_vec],
        "columns": [column_to_json(c) for c in proof.columns],
    }


def proof_from_json(obj: dict, spec: FieldSpec):

    def field(v) -> int:
        # validate at the deserialization boundary like the bincode path's
        # from_repr: the reference rejects non-canonical field encodings
        # before they reach the verifier
        x = int(v)
        if not 0 <= x < spec.modulus:
            raise ValueError("non-canonical field value in proof JSON")
        return x

    return LcEvalProof(
        n_cols=obj["n_cols"],
        p_eval=[field(v) for v in obj["p_eval"]],
        p_random_vec=[[field(v) for v in vec]
                      for vec in obj["p_random_vec"]],
        columns=[column_from_json(c, spec) for c in obj["columns"]],
    )


def column_to_json(column) -> dict:
    return {"col": [str(v) for v in column.col],
            "path": [p.hex() for p in column.path]}


def column_from_json(obj: dict, spec: FieldSpec | None = None):

    def field(v) -> int:
        # same canonicity gate as proof_from_json: the bincode path's
        # read_field_vec -> from_repr rejects out-of-range values at the
        # deserialization boundary, so the JSON wire path must too
        x = int(v)
        if spec is not None and not 0 <= x < spec.modulus:
            raise ValueError("non-canonical field value in column JSON")
        return x

    return LcColumn(col=[field(v) for v in obj["col"]],
                    path=[bytes.fromhex(p) for p in obj["path"]])
