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

import numpy as np
import torch

from .. import kernels
from ..fields.field import FieldSpec
from ..fields.limb import limb_field, widen_limbs

MAX_ROWS = 1 << 27   # the kernel's 64-bit digit sums are exact below 2^28 rows


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
    if L not in (4, 8, 12, 16) or rows > MAX_ROWS or T * npr >= (1 << 31):
        raise ValueError(f"collapse kernel: unsupported shape {tuple(coeffs.shape)}")
    lf = limb_field(spec)
    p = np.asarray(lf.p, dtype=np.uint32)
    mu = np.asarray(lf.mu(2 * L + 2), dtype=np.uint32)
    out = torch.empty((T, npr, L), dtype=torch.int32, device=coeffs.device)
    kernel = kernels.COLLAPSE if acc is None else kernels.COLLAPSE_ACC
    with torch.cuda.device(coeffs.device):
        kernel(kernels.ptr(coeffs), bits, kernels.ptr(t), None if acc is None else kernels.ptr(acc),
               kernels.ptr(out), rows, npr, T, L, kernels.ptr(p), kernels.ptr(mu), len(mu),
               kernels.stream_of(coeffs))
    return out
