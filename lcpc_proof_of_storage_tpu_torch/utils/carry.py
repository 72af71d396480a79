"""Carry state from the JAX package into the port, through numpy.

Duck-typed on the reference's objects, so this module imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codes.brakedown import BrakedownEncoding
from ..codes.ligero import LigeroEncoding
from ..core.commit import LcColumn, LcCommit, LcEvalProof, _LimbRow, default_device
from ..fields.field import FIELDS, FieldSpec
from ..ops.expander import ExpanderEncoder, GatherMat, SdigSpec


def field_from_reference(spec) -> FieldSpec:
    """The port's FieldSpec of the reference's field of the same name."""
    mine = FIELDS[spec.name]
    if (mine.modulus, mine.generator, mine.endianness) != (
            spec.modulus, spec.generator, spec.endianness):
        raise ValueError(f"field {spec.name} differs between the packages")
    return mine


def encoding_from_reference(enc) -> LigeroEncoding:
    """Port encoding with the reference LigeroEncoding's field, dims and rate."""
    return LigeroEncoding(field_from_reference(enc.spec), enc.n_per_row, enc.n_cols,
                          (enc.rho_num, enc.rho_den))


def brakedown_encoding_from_reference(enc) -> BrakedownEncoding:
    """Port encoding built from a reference BrakedownEncoding's own tables:
    its ExpanderEncoder's numpy GatherMats (idx, vals) and Vandermonde
    matrix, with no matgen run."""
    ref = enc._enc

    def level(gm) -> GatherMat:
        return GatherMat(rows=gm.rows, cols=gm.cols, idx=np.asarray(gm.idx),
                         vals=np.asarray(gm.vals))

    code = ref.spec
    return BrakedownEncoding(ExpanderEncoder(
        field_from_reference(ref.field),
        SdigSpec(code.alpha_num, code.alpha_den, code.beta_num, code.beta_den, code.r_num,
                 code.r_den, code.baselen),
        [level(gm) for gm in ref.precodes],
        [level(gm) for gm in ref.postcodes], vander=np.asarray(ref.vander)))


def _limbs(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.int32))


def commit_from_reference(comm, device=None) -> LcCommit:
    """Port commitment on `device` (default: the current CUDA card; without
    one it raises unless given ``device="cpu"``) from a reference LcCommit."""
    device = default_device(device)
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
                                    spec=field_from_reference(c._spec), path=c.path))
        else:
            columns.append(LcColumn(col=list(c._col), path=c.path))
    return LcEvalProof(n_cols=proof.n_cols, p_eval=_row(proof.p_eval),
                       p_random_vec=[_row(v) for v in proof.p_random_vec], columns=columns)
