"""Tensor collapse v_t = sum_i t[t, i] * M[i, :] mod p.

Counterpart of the collapse that ``lcpc_proof_of_storage_tpu/core/commit.py``
runs as ``LimbField.dot`` over axis 0 (the plain version here) and of
``ops/collapse_pallas.py`` ``collapse_tensors_natural`` (kernel K3,
``csrc/collapse.cu``) and ``collapse_tensors`` with the streamed collapse's
per-batch field add (kernel K3p, the same entry given an accumulator).
This is lcpc-2d's collapse_columns (lib.rs:1126-1154) for T tensors at
once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from ..fields.field import FieldSpec
from ..fields.limb import limb_field, widen_limbs

MAX_ROWS = (1 << 31) - 1   # csrc/wide.cuh kMaxTerms: the kernel's sums are exact to this many rows
# csrc/wide.cuh: warps a block, tensors a thread sums
WARPS = 8
T_TILE = {2: 4, 4: 4, 6: 2, 8: 2}
_TARGET_WARPS = 132 * 32


@dataclass(frozen=True)
class CollapsePlan:
    """The kernel's launch for one shape, as csrc/wide.cuh collapse_row_warps
    and csrc/collapse.cu compute it.  Block x of the grid covers the columns
    [x * cols_a_block, (x + 1) * cols_a_block), in column groups of 32 (one a
    warp's lane); block y the tensors [y * t_tile, (y + 1) * t_tile).  A
    column group's `row_warps` warps split its rows: warp r sums the rows i
    with i % row_warps == r, and their exact partial sums are added in shared
    memory before the one reduction."""
    row_warps: int
    t_tile: int
    cols_a_block: int
    grid: tuple[int, int]

    def rows_of(self, warp: int, rows: int) -> range:
        return range(warp, rows, self.row_warps)


def collapse_plan(rows: int, npr: int, T: int, L: int) -> CollapsePlan:
    """The row warps double (to at most WARPS) while the grid's warps stay
    below 32 a streaming multiprocessor of an H100 and every row warp keeps at
    least 4 rows."""
    tt = T_TILE[L // 2]
    col_warps = -(-npr // 32) * -(-T // tt)
    rw = 1
    while rw < WARPS and col_warps * rw < _TARGET_WARPS and rows >= 8 * rw:
        rw *= 2
    cols = 32 * (WARPS // rw)
    return CollapsePlan(rw, tt, cols, (-(-npr // cols), -(-T // tt)))


def collapse_plain(coeffs: torch.Tensor, t: torch.Tensor, spec: FieldSpec,
                   acc: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, npr, L) int32 or 16-bit coefficients, (T, rows, L) tensors ->
    (T, npr, L) int32, one plain LimbField.dot per tensor; plus `acc` mod p
    where given."""
    lf = limb_field(spec)
    c = widen_limbs(coeffs)
    out = torch.stack([lf.dot(c, t[i][:, None, :], axis=0) for i in range(t.shape[0])])
    if acc is not None:
        out = lf.add(acc, out)
    return out.to(torch.int32)


def collapse(coeffs: torch.Tensor, t: torch.Tensor, spec: FieldSpec,
             acc: torch.Tensor | None = None) -> torch.Tensor:
    """Collapse of T tensors, plus the (T, npr, L) accumulator `acc` mod p
    where given (K3, or K3p with `acc`, on CUDA; :func:`collapse_plain` on
    CPU).  The coefficients are int32 limbs or 16-bit limbs stored as int16."""
    rows, npr, L = coeffs.shape
    T = t.shape[0]
    if t.dim() != 3 or t.shape[1:] != (rows, L) or L != spec.num_limbs16:
        raise ValueError(f"collapse: coeffs {tuple(coeffs.shape)} and tensors "
                         f"{tuple(t.shape)} do not match ({spec.name})")
    if acc is not None and acc.shape != (T, npr, L):
        raise ValueError(f"collapse: accumulator {tuple(acc.shape)}, expected {(T, npr, L)}")
    if coeffs.device.type == "cpu":
        return collapse_plain(coeffs, t, spec, acc)
    bits = {torch.int32: 32, torch.int16: 16}.get(coeffs.dtype)
    if bits is None:
        raise TypeError(f"collapse: coefficients of {coeffs.dtype}, expected int32 or int16")
    kernels.check_cuda("collapse coeffs", coeffs, coeffs.dtype)
    kernels.check_cuda("collapse tensors", t, torch.int32)
    if acc is not None:
        kernels.check_cuda("collapse accumulator", acc, torch.int32)
    if any(x.device != coeffs.device for x in (t, acc) if x is not None):
        raise ValueError("collapse: inputs on different devices")
    vec = 16 if bits == 32 or L % 8 == 0 else 8
    if (L not in (4, 8, 12, 16) or rows > MAX_ROWS or T * npr >= (1 << 31)
            or -(-T // T_TILE[L // 2]) > 65535):
        raise ValueError(f"collapse kernel: unsupported shape {tuple(coeffs.shape)}, T={T}")
    if coeffs.data_ptr() % vec or (acc is not None and acc.data_ptr() % 16):
        raise ValueError("collapse kernel: coefficients or accumulator not aligned for "
                         "vector loads")
    p, mu = limb_field(spec).wide_consts
    out = torch.empty((T, npr, L), dtype=torch.int32, device=coeffs.device)
    if T * npr == 0:
        return out
    kernel = kernels.COLLAPSE if acc is None else kernels.COLLAPSE_ACC
    with torch.cuda.device(coeffs.device):
        kernel(kernels.ptr(coeffs), bits, kernels.ptr(t), None if acc is None else kernels.ptr(acc),
               kernels.ptr(out), rows, npr, T, L, kernels.ptr(p), kernels.ptr(mu), len(mu),
               kernels.stream_of(coeffs))
    return out
