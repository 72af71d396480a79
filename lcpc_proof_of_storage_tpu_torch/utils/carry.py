"""Carry state from the JAX package into the port, through numpy.

Duck-typed on the reference's objects, so this module imports neither JAX
nor the reference's ``core``/``codes`` modules.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.ligero import LigeroEncoding
from ..core.commit import LcColumn, LcCommit, LcEvalProof, _LimbRow


def encoding_from_reference(enc) -> LigeroEncoding:
    """Port encoding with the reference LigeroEncoding's field, dims and rate."""
    return LigeroEncoding(enc.spec, enc.n_per_row, enc.n_cols, (enc.rho_num, enc.rho_den))


def _limbs(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.int32))


def commit_from_reference(comm, device=None) -> LcCommit:
    """Port commitment on `device` (default CPU) from a reference LcCommit."""
    hashes = np.array(comm.hashes, dtype=np.uint32).view(np.int32)
    return LcCommit(coeffs=_limbs(comm.coeffs).to(device), comm=_limbs(comm.comm).to(device),
                    n_rows=comm.n_rows, n_cols=comm.n_cols, n_per_row=comm.n_per_row,
                    hashes=torch.from_numpy(hashes).to(device))


def _row(v) -> _LimbRow:
    limbs = getattr(v, "_limbs", None)
    return _LimbRow(list(v), None if limbs is None else np.asarray(limbs, np.uint32))


def proof_from_reference(proof) -> LcEvalProof:
    """Port proof from a reference LcEvalProof (values, rows and paths)."""
    columns = []
    for c in proof.columns:
        if c._col is None:
            columns.append(LcColumn(col_limbs=np.asarray(c._limbs, np.uint32),
                                    spec=c._spec, path=c.path))
        else:
            columns.append(LcColumn(col=list(c._col), path=c.path))
    return LcEvalProof(n_cols=proof.n_cols, p_eval=_row(proof.p_eval),
                       p_random_vec=[_row(v) for v in proof.p_random_vec], columns=columns)
