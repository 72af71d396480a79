"""Tensor collapse v_t = sum_i t[t, i] * M[i, :] mod p.

Counterpart of the collapse that ``lcpc_proof_of_storage_tpu/core/commit.py``
runs as ``LimbField.dot`` over axis 0 (the plain version here) and of
``ops/collapse_pallas.py`` ``collapse_tensors_natural`` (kernel K3,
``csrc/collapse.cu``).  This is lcpc-2d's collapse_columns
(lib.rs:1126-1154) for T tensors at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..fields.field import FieldSpec
from ..fields.limb import limb_field

MAX_ROWS = 1 << 27   # the kernel's 64-bit digit sums are exact below 2^28 rows


def collapse_plain(coeffs: torch.Tensor, t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(rows, npr, L) coefficients, (T, rows, L) tensors -> (T, npr, L) int32,
    one plain LimbField.dot per tensor."""
    lf = limb_field(spec)
    return torch.stack([lf.dot(coeffs, t[i][:, None, :], axis=0) for i in range(t.shape[0])]
                       ).to(torch.int32)


def collapse(coeffs: torch.Tensor, t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Collapse of T tensors (K3 on CUDA, :func:`collapse_plain` on CPU)."""
    rows, npr, L = coeffs.shape
    if t.dim() != 3 or t.shape[1:] != (rows, L) or L != spec.num_limbs16:
        raise ValueError(f"collapse: coeffs {tuple(coeffs.shape)} and tensors "
                         f"{tuple(t.shape)} do not match ({spec.name})")
    if coeffs.device.type == "cpu":
        return collapse_plain(coeffs, t, spec)
    kernels.check_cuda("collapse coeffs", coeffs, torch.int32)
    kernels.check_cuda("collapse tensors", t, torch.int32)
    if coeffs.device != t.device:
        raise ValueError(f"collapse: coeffs on {coeffs.device}, tensors on {t.device}")
    if L not in (4, 8, 12, 16) or rows > MAX_ROWS or t.shape[0] * npr >= (1 << 31):
        raise ValueError(f"collapse kernel: unsupported shape {tuple(coeffs.shape)}")
    lf = limb_field(spec)
    p = np.asarray(lf.p, dtype=np.uint32)
    mu = np.asarray(lf.mu(2 * L + 2), dtype=np.uint32)
    out = torch.empty((t.shape[0], npr, L), dtype=torch.int32, device=coeffs.device)
    with torch.cuda.device(coeffs.device):
        kernels.COLLAPSE(kernels.ptr(coeffs), kernels.ptr(t), kernels.ptr(out), rows, npr,
                         t.shape[0], L, kernels.ptr(p), kernels.ptr(mu), len(mu),
                         kernels.stream_of(coeffs))
    return out
