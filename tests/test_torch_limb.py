"""Port LimbField (plain PyTorch, int64) against the JAX LimbField.

Exact equality: field arithmetic on canonical limbs.  Inputs are drawn with
numpy from a seed and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields.field import (FT63, FT253_192, FT255, ints_to_limbs,
                                                  limbs_to_ints)
from lcpc_proof_of_storage_tpu.fields.limb import limb_field as jax_limb_field
from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field

torch.set_num_threads(1)

SPECS = [FT63, FT255, FT253_192]


def _elems(spec, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(n)]
    vals[:3] = [0, 1, spec.modulus - 1]
    return ints_to_limbs(vals, spec)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a.astype(np.int64))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out).astype(np.int64), torch_out.numpy())


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg"])
def test_modular_ops_match_reference(spec, op):
    ja, ta = _both(_elems(spec, 48, 1))
    jb, tb = _both(_elems(spec, 48, 2)[::-1].copy())
    jf, tf = jax_limb_field(spec), limb_field(spec)
    if op == "neg":
        _eq(jf.neg(ja), tf.neg(ta))
    else:
        _eq(getattr(jf, op)(ja, jb), getattr(tf, op)(ta, tb))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_barrett_reduce_matches_reference(spec):
    L = spec.num_limbs16
    rng = np.random.default_rng(3)
    for m in (L, 2 * L, 2 * L + 2):
        z = rng.integers(0, 1 << 16, size=(40, m), dtype=np.uint32)
        z[0] = 0xFFFF                                   # the widest value
        jz, tz = _both(z)
        _eq(jax_limb_field(spec).barrett_reduce(jz), limb_field(spec).barrett_reduce(tz))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_dot_matches_reference(spec):
    a = _elems(spec, 60, 4).reshape(20, 3, -1)
    b = _elems(spec, 20, 5).reshape(20, 1, -1)
    ja, ta = _both(a)
    jb, tb = _both(b)
    got = limb_field(spec).dot(ta, tb, axis=0)
    _eq(jax_limb_field(spec).dot(ja, jb, axis=0), got)
    av = np.array(limbs_to_ints(a), dtype=object).reshape(20, 3)
    bv = np.array(limbs_to_ints(b), dtype=object).reshape(20, 1)
    assert limbs_to_ints(got.numpy()) == [v % spec.modulus for v in (av * bv).sum(axis=0)]


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_sum_matches_reference(spec):
    ja, ta = _both(_elems(spec, 90, 6).reshape(30, 3, -1))
    _eq(jax_limb_field(spec).sum(ja, axis=0), limb_field(spec).sum(ta, axis=0))


def test_array_round_trips_python_ints():
    lf = limb_field(FT255)
    vals = [0, 1, FT255.modulus - 1, 12345678901234567890]
    t = lf.array(vals)
    assert t.dtype == torch.int32 and t.shape == (4, 16)
    np.testing.assert_array_equal(t.numpy(), ints_to_limbs(vals, FT255))
