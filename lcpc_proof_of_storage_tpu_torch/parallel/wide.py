"""Wide-row commitments: the encoded-column axis sharded over a mesh.

Counterpart of ``lcpc_proof_of_storage_tpu/parallel/wide.py``.  The
reference cannot commit a matrix whose rows outgrow one host
(proof-of-storage/limitations.md:8-10).  Here the column axis of the
encoded matrix is sharded over the mesh: Ligero rows are encoded by the
cross-device NTT (``parallel/cross_chip_ntt.py``), Brakedown rows by the
row-sharded expander levels (``ops/expander.py encode_wide``), each shard
hashes its own columns (K2's leaves), and K2's tree builds the Merkle array
from the gathered leaves (``core/commit.py wide_commit_from_matrix``, which
``commit`` runs for an encoding with a mesh).  A wide commitment is
bit-identical to the one-device one; prove, verify and the serde are the
core engine's, reading the column-sharded matrix through ``core/storage.py
ShardedRows``.

    enc = LigeroEncoding.new_from_dims(npr, n_cols, spec).with_mesh(mesh)
    comm = commit(coeffs, enc)            # the wide pipeline
    proof = prove(comm, outer, enc, tr)   # unchanged
"""

from __future__ import annotations

from ..core.commit import LcCommit, commit
from ..core.encoding import LcEncoding
from .mesh import Mesh


def wide_commit(coeffs, enc: LcEncoding, mesh: Mesh, device=None) -> LcCommit:
    """Commit with the encoded-column axis sharded over `mesh`."""
    return commit(coeffs, enc.with_mesh(mesh), device=device)
