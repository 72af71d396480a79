"""The lcpc-2d evaluation proof (lib.rs:1034-1123) and its bincode bytes.

Given the coefficient matrix, the encoded matrix (already judged against
the reference's encoding) and the reference's Merkle tree, this replays the
prover's transcript and writes the bytes the proof must have:
n_cols; p_eval; the degree-test rows; the opened columns, each its values
and its sibling path, every value as its canonical [u64; limbs] repr and
every vector behind a u64 length.
"""

from __future__ import annotations

import torch

from . import blake3
from .chacha import ChaCha, field_random, uniform_below
from .field import Field, combine_rows
from .transcript import PySponge, Transcript

LABEL_DT, LABEL_PR, LABEL_PE, LABEL_CO = b"$l//DT", b"$l//PR", b"$l//PE", b"$l//CO"


def transcript(label: bytes, root: bytes) -> Transcript:
    """The transcript a prover and a verifier of the benchmark start from."""
    tr = Transcript(label)
    tr.append_message(b"polycommit", root)
    return tr


def _reprs(values: list[int], field: Field) -> bytes:
    return b"".join(v.to_bytes(field.repr_bytes, "little") for v in values)


def replay(label: bytes, root: bytes, rows_random: list[bytes], p_eval: bytes,
           n_cols: int, n_opens: int, width: int) -> tuple[list[bytes], list[int]]:
    """The prover's transcript over the given rows (each the packed
    `width`-byte reprs of one row): the degree-test challenges' ChaCha seeds
    and the opened columns.  The rows are appended as they are given, so the
    caller compares them with the reference's own."""
    try:
        return _replay(Transcript(label), root, rows_random, p_eval, n_cols, n_opens, width)
    except NotImplementedError:        # a PRF at a block boundary: the slow sponge
        return _replay(Transcript(label, PySponge()), root, rows_random, p_eval, n_cols,
                       n_opens, width)


def _replay(tr: Transcript, root: bytes, rows_random: list[bytes], p_eval: bytes,
            n_cols: int, n_opens: int, width: int) -> tuple[list[bytes], list[int]]:
    tr.append_message(b"polycommit", root)
    seeds = []
    for row in rows_random:
        seeds.append(tr.challenge_bytes(LABEL_DT, 32))
        tr.append_messages(LABEL_PR, row, width)
    tr.append_messages(LABEL_PE, p_eval, width)
    return seeds, uniform_below(ChaCha(tr.challenge_bytes(LABEL_CO, 32)), n_cols, n_opens)


def prove_bytes(coeffs: torch.Tensor, comm: torch.Tensor, levels: list[torch.Tensor],
                outer: list[int], seeds: list[bytes], cols: list[int],
                field: Field) -> tuple[bytes, list[bytes], bytes]:
    """(proof bytes, degree-test rows, p_eval row) of a proof against coeffs
    (n_rows, n_per_row, L) whose codewords are comm (n_rows, n_cols, L), for
    the degree-test seeds and opened columns the transcript gave; the rows as
    packed reprs."""
    n_rows = coeffs.shape[0]
    n_cols = comm.shape[1]
    rows_random = [_reprs(combine_rows(field_random(ChaCha(s), field.modulus, n_rows),
                                       coeffs, field), field) for s in seeds]
    p_eval = _reprs(combine_rows(outer, coeffs, field), field)
    n = coeffs.shape[1].to_bytes(8, "little")
    out = [n_cols.to_bytes(8, "little"), n + p_eval, len(rows_random).to_bytes(8, "little")]
    out += [n + r for r in rows_random]
    out.append(len(cols).to_bytes(8, "little"))
    taken = comm[:, torch.tensor(cols, device=comm.device)].to(torch.int32) & 0xFFFF
    taken = taken.transpose(0, 1).cpu().numpy().astype("<u2")              # (k, rows, L)
    for i, c in enumerate(cols):
        out.append(n_rows.to_bytes(8, "little") + taken[i].tobytes())
        path = blake3.merkle_path(levels, c)
        out.append(len(path).to_bytes(8, "little")
                   + b"".join((32).to_bytes(8, "little") + s for s in path))
    return b"".join(out), rows_random, p_eval


def proof_rows(data: bytes, width: int) -> tuple[list[bytes], bytes]:
    """The degree-test rows and p_eval of a proof's bytes, as packed reprs."""
    pos = 8
    n = int.from_bytes(data[pos:pos + 8], "little")
    p_eval = data[pos + 8:pos + 8 + n * width]
    pos += 8 + n * width
    ndt = int.from_bytes(data[pos:pos + 8], "little")
    pos += 8
    rows = []
    for _ in range(ndt):
        n = int.from_bytes(data[pos:pos + 8], "little")
        rows.append(data[pos + 8:pos + 8 + n * width])
        pos += 8 + n * width
    return rows, p_eval


def evaluation(inner: list[int], p_eval: list[int], field: Field) -> int:
    return sum(a * b for a, b in zip(inner, p_eval)) % field.modulus


def point_tensors(x: int, n_rows: int, n_per_row: int, field: Field):
    """outer[i] = x^(n_per_row i), inner[j] = x^j: <outer (x) inner, coeffs>
    is the coefficient polynomial at x."""
    p = field.modulus
    xr = pow(x, n_per_row, p)
    outer, inner = [1] * n_rows, [1] * n_per_row
    for i in range(1, n_rows):
        outer[i] = outer[i - 1] * xr % p
    for j in range(1, n_per_row):
        inner[j] = inner[j - 1] * x % p
    return outer, inner

