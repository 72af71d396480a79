"""Port collapse (plain PyTorch) against the JAX package's LimbField.dot
over axis 0, the XLA path that core/commit.py _collapse_fn runs and the
reference for its natural Pallas kernel.  Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields.field import FT63, FT127, FT191, FT255, ints_to_limbs
from lcpc_proof_of_storage_tpu.fields.limb import limb_field as jax_limb_field
from lcpc_proof_of_storage_tpu_torch.ops.collapse import collapse, collapse_plain

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
