"""Row-sharded commitment pipeline over a mesh.

Counterpart of ``lcpc_proof_of_storage_tpu/parallel/sharded.py``:

* the coefficient matrix is row-sharded over the mesh and each shard
  encodes its rows (K1 or K5), with no traffic: the reference's
  row-parallel encode (lcpc-2d/src/lib.rs:677-682) as data parallelism;
* one all-to-all turns the encoded matrix column-sharded, so each shard
  hashes a block of whole columns (K2's leaves);
* the leaves are gathered into one Merkle array built by K2's tree;
* the collapses v = t^T M reduce over the row axis: each shard's partial
  sum goes through K3 with the running sum as its accumulator, moved from
  shard to shard (:func:`sharded_collapse`), an exact modular sum.

Row counts need not divide the mesh: rows are zero-padded before the encode
and the padding rows are sliced off before the leaves; columns are
zero-padded for the all-to-all and their digests sliced off before the
Merkle tree, which pads with zero digests as the one-device path does
(lcpc-2d/src/lib.rs:685-694).  Rows wider than a device can hold at full
width (:func:`row_sharded_col_budget`) go to the wide pipeline
(``parallel/wide.py``), where a device holds 1/D of each row.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..core.commit import LcCommit, default_device, merkle_tree_device, wide_commit_from_matrix
from ..core.encoding import LcEncoding
from ..core.storage import limb_matrix
from ..fields.field import FieldSpec
from ..ops.blake3 import hash_columns
from ..ops.collapse import collapse
from .mesh import Mesh, all_to_all, gather, make_mesh, scatter

__all__ = ["make_mesh", "sharded_commit", "sharded_collapse", "training_step"]

# Copies of a shard's rows at full encoded width that the row-sharded commit
# holds at once on its device: the zero-padded rows, their codewords, the
# codewords padded for the all-to-all, and the column blocks it returns.
ROW_PATH_COPIES = 4


def free_bytes(device: torch.device) -> int:
    """Memory `device` can still give: a card's free memory plus what its
    caching allocator holds unused; the host's available memory for the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def row_sharded_col_budget(mesh: Mesh, n_rows: int, limbs: int) -> int:
    """The widest rows, in encoded columns, that the row-sharded commit may
    take on `mesh`: a device holds ceil(n_rows / D) rows at full width as
    int32 limbs for each shard it carries, ROW_PATH_COPIES times over, and the
    budget is what the device with the least room fits."""
    per_col = -(-n_rows // mesh.size) * limbs * 4 * ROW_PATH_COPIES
    return min(free_bytes(dev) // (per_col * mesh.devices.count(dev))
               for dev in set(mesh.devices))


def _encode_and_hash(row_blocks: list[torch.Tensor], enc: LcEncoding, mesh: Mesh,
                     n_rows: int, n_cols: int):
    """Encode each shard's rows, all-to-all to column blocks, drop the
    padding rows, hash each block's columns.  Returns (the column blocks
    trimmed to n_cols columns, the (n_cols, 8) leaves on the mesh's first
    device)."""
    D = mesh.size
    cols_pad = -n_cols % D
    comm = [F.pad(enc.encode(rows), (0, 0, 0, cols_pad)) for rows in row_blocks]
    comm = [c[:n_rows] for c in all_to_all(comm, mesh, 1, 0)]
    leaves = gather([hash_columns(c, enc.spec) for c in comm], mesh.devices[0], 0)[:n_cols]
    width = (n_cols + cols_pad) // D
    comm = [c[:, :max(0, min(width, n_cols - k * width))] for k, c in enumerate(comm)]
    return comm, leaves


def sharded_commit(coeffs, enc: LcEncoding, mesh: Mesh, device=None,
                   col_budget: int | None = None) -> LcCommit:
    """``commit`` with the encode row-sharded over `mesh`: a commitment
    bit-identical to the one-device path's, for Ligero and Brakedown.  Its
    coefficients stay on `device` (default: the mesh's first device), its
    encoded matrix column-sharded.  An encoding with a mesh, or rows wider
    than `col_budget` columns (default: :func:`row_sharded_col_budget`), go
    through the wide pipeline."""
    device = default_device(mesh.devices[0] if device is None else device)
    coeff_mat, dims = limb_matrix(coeffs, enc, device)
    n_rows, n_per_row, n_cols = dims
    if col_budget is None and enc.mesh is None:
        col_budget = row_sharded_col_budget(mesh, n_rows, coeff_mat.shape[2])
    if enc.mesh is not None or n_cols > col_budget:
        return wide_commit_from_matrix(coeff_mat, dims, enc.with_mesh(mesh))
    rows = scatter(coeff_mat, mesh, 0, n_rows + (-n_rows % mesh.size))
    comm, leaves = _encode_and_hash(rows, enc, mesh, n_rows, n_cols)
    hashes = merkle_tree_device(n_cols, leaves.device, lambda out: out.copy_(leaves))
    return LcCommit(coeffs=coeff_mat, comm=comm, n_rows=n_rows, n_cols=n_cols,
                    n_per_row=n_per_row, hashes=hashes)


def sharded_collapse(coeffs, t: torch.Tensor, spec: FieldSpec, mesh: Mesh) -> torch.Tensor:
    """(T, n_per_row, L) int32 collapse v = t^T M of the (T, n_rows, L)
    tensors `t` against row-sharded coefficients: `coeffs` as a tensor
    (sharded here by :func:`parallel.mesh.scatter`) or as its row blocks.
    Shard by shard, on each shard's device, K3 adds the shard's partial sum
    to the running sum (K3's accumulator, moved on from the shard before),
    so the psum is an exact modular sum.  Returns the sum on t's device."""
    blocks = coeffs if isinstance(coeffs, (list, tuple)) else scatter(coeffs, mesh, 0)
    acc = None
    r0 = 0
    for block, dev in zip(blocks, mesh.devices):
        r1 = r0 + block.shape[0]
        if r1 > r0:
            tk = t[:, r0:r1].to(dev, copy=True, memory_format=torch.contiguous_format)
            acc = collapse(block, tk, spec, acc=None if acc is None else acc.to(dev))
        r0 = r1
    if r0 != t.shape[1]:
        raise ValueError(f"sharded_collapse: {r0} coefficient rows, tensors of {t.shape[1]}")
    return acc.to(t.device)


def training_step(enc: LcEncoding, mesh: Mesh):
    """One sharded step: encode + hash + Merkle leaves + the two tensor
    collapses (a degree test's and the evaluation's), the device work of
    commit and prove.  Returns fn(coeff_mat, rand_tensor, outer_tensor) ->
    (column blocks of the encoded matrix, (n_cols, 8) leaves, p_random,
    p_eval), for a (n_rows, n_per_row, L) int32 matrix whose row count the
    mesh size divides (the commit pads; this step keeps shapes exact) and
    (n_rows, L) tensors; the outputs on the mesh's first device."""
    D = mesh.size

    def step(coeff_mat: torch.Tensor, rand_tensor: torch.Tensor, outer_tensor: torch.Tensor):
        n_rows = coeff_mat.shape[0]
        if n_rows % D:
            raise ValueError(f"training_step: {n_rows} rows do not divide over {D} shards")
        rows = scatter(coeff_mat, mesh, 0)
        comm, leaves = _encode_and_hash(rows, enc, mesh, n_rows, enc.n_cols)
        t = torch.stack([rand_tensor, outer_tensor]).to(mesh.devices[0])
        p = sharded_collapse(rows, t, enc.spec, mesh)
        return comm, leaves, p[0], p[1]

    return step
