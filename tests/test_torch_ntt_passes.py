"""K1's and K4's pass plan and index map (``ops/ntt.py`` ntt_pass_plan,
ntt_pass_tiles, ntt_passes_plain; ``csrc/ntt.cu``) on the CPU.

The plan must split the stages 0 .. log2(n)-1 into consecutive groups of at
most k_max; each pass's tiles must hold every position of a row once; and
the passes, run tile by tile as the kernel gathers them (k_max forced to 3
so that small n take several passes), must give ``ntt_plain`` and
``intt_plain`` at every size and, at one size a field, the JAX package's
``ntt`` on zero-padded rows and its ``intt``, exactly (integer field
arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.ops import ntt as jax_ntt
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
from lcpc_proof_of_storage_tpu_torch.ops import ntt

torch.set_num_threads(1)

SPECS = (FT63, FT127, FT191, FT255, FT253_192)


@pytest.mark.parametrize("k_max", [3, 10, 11])
def test_pass_plan_covers_each_stage_once(k_max):
    for log_n in range(1, 23):
        plan = ntt.ntt_pass_plan(1 << log_n, k_max)
        assert plan[0][0] == 0 and plan[-1][1] == log_n
        assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
        assert all(1 <= hi - lo <= k_max for lo, hi in plan)
        assert len(plan) == -(-log_n // k_max)


def test_pass_plan_of_the_kernel():
    assert ntt.K_MAX == 10
    assert ntt.ntt_pass_plan(1 << 10) == [(0, 10)]
    assert ntt.ntt_pass_plan(1 << 15) == [(0, 8), (8, 15)]
    assert ntt.ntt_pass_plan(1 << 20) == [(0, 10), (10, 20)]
    assert ntt.ntt_pass_plan(1 << 21) == [(0, 7), (7, 14), (14, 21)]
    for bad in (1, 3, 12):
        with pytest.raises(ValueError):
            ntt.ntt_pass_plan(bad)


@pytest.mark.parametrize("log_n", [1, 5, 11, 15])
def test_pass_tiles_hold_each_position_once(log_n):
    n = 1 << log_n
    for k_max in (1, 3, 10):
        for g, (s_lo, s_hi) in enumerate(ntt.ntt_pass_plan(n, k_max)):
            pos, lo = ntt.ntt_pass_tiles(n, s_lo, s_hi, g == 0)
            assert pos.shape == (n >> (s_hi - s_lo), 1 << (s_hi - s_lo))
            assert torch.equal(pos.flatten().sort().values, torch.arange(n))
            assert torch.equal(pos % (1 << s_lo), lo[:, None].expand_as(pos))


def _rows(spec, n, seed):
    """Four canonical rows of n values from a numpy seed."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(4 * n)]
    return jax_field.ints_to_limbs(vals, spec).reshape(4, n, -1).astype(np.int32)


# the one size a field is also held against the JAX package at: each JAX call
# compiles a program of its own (1-4 s), so every size is covered once
JAX_LOG_N = {"ft63": 11, "ft127": 7, "ft191": 4, "ft255": 1, "ft253_192": 7}


@pytest.mark.parametrize("log_n", [1, 4, 7, 11])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_passes_plain_matches_reference(spec, log_n):
    """Three passes or more (k_max = 3) against ntt_plain / intt_plain on rows
    zero past n_nonzero in {0, 1, ragged, n}; at the field's JAX_LOG_N, the
    forward rows also against the JAX package's ntt, and the inverse through
    it: ntt(inverse(y)) == y, so the inverse is the JAX package's intt."""
    n = 1 << log_n
    x = _rows(spec, n, 100 * log_n + spec.num_limbs16)
    nnzs = (0, 1, max(1, n * 5 // 8 - 1), n)    # the third ragged where n allows it
    padded = x.copy()
    for r, nnz in enumerate(nnzs):
        padded[r, nnz:] = 0
    tables = ntt.NttTables(spec, n)
    xt = torch.from_numpy(x)
    fwd = torch.cat([ntt.ntt_passes_plain(xt[r:r + 1], tables, nnz, k_max=3)
                     for r, nnz in enumerate(nnzs)])
    inv = ntt.ntt_passes_plain(xt, tables, inverse=True, k_max=3)
    assert torch.equal(fwd, ntt.ntt_plain(torch.from_numpy(padded), spec, None, tables))
    assert torch.equal(inv, ntt.intt_plain(xt, spec, tables))
    if JAX_LOG_N[spec.name] != log_n:
        return
    rows = np.concatenate([padded, inv.numpy()]).astype(np.uint32)
    want = np.asarray(jax_ntt.ntt(jnp.asarray(rows), jax_field.FIELDS[spec.name]))
    np.testing.assert_array_equal(fwd.numpy(), want[:4].astype(np.int32))
    np.testing.assert_array_equal(x, want[4:].astype(np.int32))
