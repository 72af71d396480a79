"""Out-of-core commit and prove: encode and hash in row batches, so the
encoded matrix never has to exist whole on the device.

Counterpart of ``lcpc_proof_of_storage_tpu/core/streamed.py``.  At Ligero
rho=1/4 ft255 2^29 the encoded matrix is 2^31 elements (137 GB as int32
limbs, 68.7 GB as 16-bit ones), past one H100's 80 GB, while the
coefficients are 17.2 GB as 16-bit limbs.  Commit needs the encoded matrix
only to hash its columns and to serve opened columns to prove, so each row
batch is encoded by the encoding's kernel, its part of every column message
is hashed into Blake3 chunk chaining values (K2's chunk-CV entry), and the
batch is kept on the device as 16-bit limbs, copied to host memory, or
dropped.  The batch goes to the encoding as stored and the 16-bit rows come
back from it (``LcEncoding.encode_stored``): on Ligero's ``stages`` route
K1 reads and writes them itself, with no widened copy, pad or narrowing.
Batches end on 1024-byte chunk boundaries (but the last), so the chunk CVs
are those of the one-shot column hash and K2's merge entry gives the same
leaves: roots and proofs are bit-identical to :func:`commit`'s.

Prove works from such a commitment too (core/storage.py, the reference's
collapse_streamed and open_columns_streamed): the collapse runs over row
batches with K3p (each batch's partial sum added mod p in the kernel),
uploading host-resident 16-bit coefficients one batch at a time, and a
commitment that kept no encoded matrix re-encodes its rows in batches and
gathers only the opened columns.  This is the reference's design; the Rust
reference holds the encoded matrix in host RAM instead
(lcpc-2d/src/lib.rs:1034-1123).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.field import FieldSpec
from ..fields.limb import narrow_limbs
from ..ops.blake3 import batch_chunks, chunk_cvs, merge_cvs
from .commit import LcCommit, commit, default_device, merkle_tree_device
from .encoding import LcEncoding
from .storage import BATCH_BYTES, DeviceRows, HostRows, as_rows, host_limb_matrix, limb_matrix

I64 = torch.int64
M32 = 0xFFFFFFFF
MAX_BATCH_ROWS = 1024


def _row_batches(n_rows: int, repr_bytes: int, target_rows: int) -> list[tuple[int, int]]:
    """Split rows into batches whose byte spans (with the 32-byte zero
    prefix before row 0) end on Blake3 chunk boundaries, but the last batch,
    which may end mid-chunk."""
    W = repr_bytes
    step = 1024 // int(np.gcd(1024, W))          # rows per whole-chunk stride
    r0 = next(r for r in range(1, step + 1) if (32 + r * W) % 1024 == 0)
    bounds = [0]
    pos = min(r0 + (max(target_rows - r0, 0) // step) * step, n_rows)
    if pos <= 0:
        pos = min(r0, n_rows)
    while pos < n_rows:
        bounds.append(pos)
        pos = min(pos + max(step, (target_rows // step) * step), n_rows)
    bounds.append(n_rows)
    return list(zip(bounds[:-1], bounds[1:]))


# --------------------------------------------------------------------------
# synthetic coefficients
# --------------------------------------------------------------------------

def _mul32(x, c: int):
    """Low 32 bits of x * c for x < 2^32 and a constant c < 2^32, with every
    intermediate below 2^63 (tensors or ints)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32(x):
    """A 32-bit integer hash (x < 2^32): xorshift-multiply rounds."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def synthetic_limbs(seed: int, start: int, count: int, spec: FieldSpec,
                    device=None) -> torch.Tensor:
    """Elements start .. start+count-1 of the synthetic coefficient vector of
    `seed`, as (count, L) 16-bit limbs stored as int16.  Limb j of element e
    is a counter hash of (seed, e * L + j) in int64 torch ops, so the CPU and
    a card give the same values; the top limb is masked below p's top limb,
    so every value is canonical."""
    L = spec.num_limbs16
    s0 = _mix32(seed & M32)
    s1 = _mix32(((seed >> 32) & M32) ^ 0x9E3779B9)
    ctr = (torch.arange(start, start + count, dtype=I64, device=device)[:, None] * L
           + torch.arange(L, dtype=I64, device=device))
    h = _mix32(_mix32((ctr & M32) ^ s0) ^ (ctr >> 32) ^ s1)
    v = h >> 16
    top = max((spec.modulus >> (16 * (L - 1))) - 1, 1)
    v[:, L - 1] &= top
    return narrow_limbs(v)


class SyntheticCoeffs:
    """A coefficient source made on the device from a seed: each row batch
    of a streamed commit is generated where it is encoded, so no coefficient
    matrix exists anywhere.  The values are :func:`synthetic_limbs`, and
    :func:`materialize` writes the same values out, so a synthetic root can
    be checked against a real commit.  The commitment keeps no coefficients
    and serves its root alone."""

    def __init__(self, length: int, seed: int = 0):
        self.length = length
        self.seed = seed

    def rows(self, r0: int, r1: int, n_per_row: int, spec: FieldSpec,
             device) -> torch.Tensor:
        """Rows r0..r1-1 of the padded (n_rows, n_per_row, L) matrix, int16;
        elements past `length` are zero."""
        start, stop = r0 * n_per_row, min(r1 * n_per_row, self.length)
        out = torch.zeros(((r1 - r0) * n_per_row, spec.num_limbs16), dtype=torch.int16,
                          device=device)
        if stop > start:
            out[:stop - start] = synthetic_limbs(self.seed, start, stop - start, spec, device)
        return out.reshape(r1 - r0, n_per_row, spec.num_limbs16)


def materialize(src: SyntheticCoeffs, spec: FieldSpec, device=None,
                chunk: int = 1 << 22) -> torch.Tensor:
    """The synthetic coefficients of `src` as one (length, L) int16 tensor on
    `device`, generated `chunk` elements at a time."""
    out = torch.empty((src.length, spec.num_limbs16), dtype=torch.int16, device=device)
    for s in range(0, src.length, chunk):
        n = min(chunk, src.length - s)
        out[s:s + n] = synthetic_limbs(src.seed, s, n, spec, device)
    return out


# --------------------------------------------------------------------------
# commit
# --------------------------------------------------------------------------

def commit_streamed(coeffs, enc: LcEncoding, target_batch_rows: int | None = None,
                    keep_comm: bool | str = True, device_coeffs: bool = True,
                    device=None) -> LcCommit:
    """:func:`~.commit.commit` with a row-batched encode and incremental
    column hashing, on `device` (default: the device of a CUDA coefficient
    tensor, else the current CUDA card; without one it raises unless given
    ``device="cpu"``).

    coeffs: python ints, an (n, L) limb array or tensor (16-bit limbs stay
    16-bit), or :class:`SyntheticCoeffs`.
    keep_comm: True copies each encoded batch to host memory (a uint16
    array); "device" keeps the encoded matrix on the device as 16-bit limbs;
    False drops it (prove re-encodes).
    device_coeffs: True keeps the coefficients on the device (16-bit where
    given as 16-bit limbs); False keeps them in host memory as uint16 and
    uploads one batch at a time.
    Batches hold about BATCH_BYTES of int32 encoded rows, at most
    MAX_BATCH_ROWS rows, unless `target_batch_rows` sets the count; every
    batch but the last ends on a 1024-byte chunk of the column messages, so a
    batch holds at least 1024 / gcd(1024, repr bytes) rows."""
    if keep_comm not in (True, False, "device"):
        raise ValueError(f"keep_comm must be True, False or 'device', not {keep_comm!r}")
    if device is None and isinstance(coeffs, torch.Tensor) and coeffs.is_cuda:
        device = coeffs.device
    device = default_device(device)
    spec = enc.spec
    L = spec.num_limbs16
    synthetic = isinstance(coeffs, SyntheticCoeffs)
    if synthetic:
        n_rows, n_per_row, n_cols = enc.get_dims(coeffs.length)
        src = None
    else:
        mat, (n_rows, n_per_row, n_cols) = (
            limb_matrix(coeffs, enc, device, keep16=True) if device_coeffs
            else host_limb_matrix(coeffs, enc))
        src = as_rows(mat, device)

    W = spec.repr_bytes
    total_chunks = -(-(32 + n_rows * W) // 1024)
    if total_chunks < 2:
        # single-chunk columns: nothing to stream
        if synthetic:
            raise ValueError("SyntheticCoeffs serves streamed sizes only")
        c = commit(coeffs, enc, device)
        if keep_comm == "device":
            kept = narrow_limbs(c.comm)
        elif keep_comm:
            kept = narrow_limbs(c.comm).cpu().numpy().view(np.uint16)
        else:
            kept = None
        return LcCommit(coeffs=c.coeff_rows, comm=kept, n_rows=n_rows, n_cols=n_cols,
                        n_per_row=n_per_row, hashes=c.hashes)

    if target_batch_rows is None:
        target_batch_rows = max(1, min(MAX_BATCH_ROWS, BATCH_BYTES // (n_cols * L * 4)))
    batches = _row_batches(n_rows, W, target_batch_rows)
    cvs = torch.empty((n_cols, total_chunks, 8), dtype=torch.int32, device=device)
    if keep_comm == "device":
        dst = DeviceRows(torch.empty((n_rows, n_cols, L), dtype=torch.int16, device=device))
    elif keep_comm:
        dst = HostRows(np.empty((n_rows, n_cols, L), np.uint16), device)
    else:
        dst = None

    chunk0 = 0
    for r0, r1 in batches:
        if synthetic:
            rows = coeffs.rows(r0, r1, n_per_row, spec, device)
        else:
            rows = src.rows(r0, r1)
        if keep_comm == "device":
            out16 = dst.data[r0:r1]
        elif keep_comm:
            out16 = torch.empty((r1 - r0, n_cols, L), dtype=torch.int16, device=device)
        else:
            out16 = None
        comm_b = enc.encode_stored(rows, out16)             # (rows_b, n_cols, L) int32
        first = r0 == 0
        k, span = batch_chunks(r1 - r0, spec, first)
        if r1 < n_rows and span % 1024:
            raise RuntimeError(f"rows {r0}..{r1} end mid-chunk")
        chunk_cvs(comm_b, spec, cvs, chunk0, first)
        if keep_comm is True:
            dst.put(r0, r1, out16)
        del comm_b, rows, out16
        chunk0 += k
    if keep_comm is True:
        dst.flush()
    if chunk0 != total_chunks:
        raise RuntimeError(f"batches covered {chunk0} chunks of {total_chunks}")

    hashes = merkle_tree_device(n_cols, cvs.device, lambda out: merge_cvs(cvs, out=out))
    return LcCommit(coeffs=src, comm=dst, n_rows=n_rows, n_cols=n_cols,
                    n_per_row=n_per_row, hashes=hashes)
