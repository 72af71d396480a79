"""Port collapse (plain PyTorch) against the JAX package's LimbField.dot
over axis 0, the XLA path that core/commit.py _collapse_fn runs and the
reference for its natural Pallas kernel.  Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields.field import FT63, FT127, FT191, FT255, ints_to_limbs
from lcpc_proof_of_storage_tpu.fields.limb import limb_field as jax_limb_field
from lcpc_proof_of_storage_tpu_torch.ops.collapse import collapse, collapse_plain, collapse_plan

torch.set_num_threads(1)


def _limbs(spec, shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(n)]
    vals[0] = spec.modulus - 1
    return ints_to_limbs(vals, spec).reshape(*shape, -1)


def _reference(coeffs, t, spec):
    lf = jax_limb_field(spec)
    return np.stack([np.asarray(lf.dot(jnp.asarray(coeffs), jnp.asarray(t[i])[:, None, :],
                                       axis=0)) for i in range(t.shape[0])]).astype(np.int32)


@pytest.mark.parametrize("spec,rows,npr,T", [
    (FT63, 3000, 4, 2),      # more rows than the TPU kernel's 2048-row chunk
    (FT255, 9, 16, 2),
    (FT127, 9, 8, 2),
    (FT191, 7, 8, 1),
], ids=["ft63-3000rows", "ft255", "ft127", "ft191"])
def test_collapse_plain_matches_reference(spec, rows, npr, T):
    coeffs = _limbs(spec, (rows, npr), 1)
    t = _limbs(spec, (T, rows), 2)
    got = collapse(torch.from_numpy(coeffs.astype(np.int32)),
                   torch.from_numpy(t.astype(np.int32)), spec)
    assert got.dtype == torch.int32 and got.shape == (T, npr, spec.num_limbs16)
    np.testing.assert_array_equal(got.numpy(), _reference(coeffs, t, spec))


def test_collapse_shape_mismatch_raises():
    c = torch.zeros((4, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        collapse(c, torch.zeros((1, 5, 4), dtype=torch.int32), FT63)
    with pytest.raises(ValueError):
        collapse(c, torch.zeros((1, 4, 16), dtype=torch.int32), FT255)


def test_collapse_off_cpu_never_falls_back_to_plain():
    c = torch.zeros((4, 8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        collapse(c, torch.zeros((1, 4, 4), dtype=torch.int32, device="meta"), FT63)


@pytest.mark.parametrize("rows,npr,T,L", [
    (128, 8192, 2, 16),      # Ligero 2^20 prove: few columns, 8 row warps
    (585, 16384, 1, 4),      # the PoS left-multiply
    (128, 262144, 2, 16),    # a 2^29 prove batch: one row warp
    (18, 117587, 2, 16), (37, 100, 9, 4), (20, 3000, 3, 12), (9, 70, 1, 8), (3, 5, 7, 16),
])
def test_collapse_plan_covers_every_row_and_output_once(rows, npr, T, L):
    """The kernel's plan (mirrored from csrc/collapse.cu): every output (t, j)
    belongs to one thread and tensor slot of one block, and the rows of every
    output are split over its column group's row warps, each row once."""
    plan = collapse_plan(rows, npr, T, L)
    rw, tt_n, (gx, gy) = plan.row_warps, plan.t_tile, plan.grid
    assert rw in (1, 2, 4, 8) and plan.cols_a_block * rw == 32 * 8
    assert rw == 1 or rows >= 4 * rw
    finished = np.zeros((T, npr), np.int64)      # the thread that reduces and stores (t, j)
    summed = np.zeros((T, npr), np.int64)        # rows summed into (t, j)
    bx = np.arange(gx)[:, None, None]
    for by in range(gy):
        for warp in range(8):
            cg, wr = divmod(warp, rw)
            j = ((bx * (8 // rw) + cg) * 32 + np.arange(32)[None, None, :]).ravel()
            j = j[j < npr]
            for tt in range(tt_n):
                t = by * tt_n + tt
                if t >= T:
                    continue
                summed[t, j] += len(plan.rows_of(wr, rows))
                if tt % rw == wr:
                    finished[t, j] += 1
    assert (finished == 1).all() and (summed == rows).all()
    seen = np.zeros(rows, np.int64)
    for wr in range(rw):
        seen[list(plan.rows_of(wr, rows))] += 1
    assert (seen == 1).all()
