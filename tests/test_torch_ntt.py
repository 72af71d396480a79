"""Port NTT (plain PyTorch) against the JAX package's ops.ntt.ntt.

Exact equality.  Rows are zero past n_nonzero, as the Ligero encode gives
them; the port reads only the first n_nonzero positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields.field import FT63, FT127, FT191, FT255, ints_to_limbs
from lcpc_proof_of_storage_tpu.ops import ntt as jax_ntt
from lcpc_proof_of_storage_tpu_torch.ops.ntt import NttTables, ntt, ntt_plain

torch.set_num_threads(1)


def _rows(spec, batch, n, n_nonzero, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(batch * n)]
    x = ints_to_limbs(vals, spec).reshape(batch, n, -1)
    x[:, n_nonzero:] = 0
    return x


@pytest.mark.parametrize("log_n", range(4, 11))
def test_ntt_plain_matches_reference(log_n):
    n = 1 << log_n
    nnz = max(1, n // 4 + 3)
    x = _rows(FT63, 3, n, nnz, log_n)
    want = np.asarray(jax_ntt.ntt(jnp.asarray(x), FT63)).astype(np.int32)
    got = ntt_plain(torch.from_numpy(x.astype(np.int32)), FT63, n_nonzero=nnz)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ntt_plain_matches_reference_ft255():
    x = _rows(FT255, 2, 64, 16, 7)
    want = np.asarray(jax_ntt.ntt(jnp.asarray(x), FT255)).astype(np.int32)
    got = ntt(torch.from_numpy(x.astype(np.int32)), FT255, n_nonzero=16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", [FT127, FT191], ids=lambda s: s.name)
def test_ntt_plain_matches_reference_mid_widths(spec):
    x = _rows(spec, 2, 32, 9, 8)
    want = np.asarray(jax_ntt.ntt(jnp.asarray(x), spec)).astype(np.int32)
    got = ntt(torch.from_numpy(x.astype(np.int32)), spec, n_nonzero=9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_n_nonzero_reads_only_the_head():
    """Positions at or past n_nonzero are read as zero, whatever they hold."""
    full = torch.from_numpy(_rows(FT63, 2, 32, 32, 9).astype(np.int32))
    head = full.clone()
    head[:, 10:] = 0
    torch.testing.assert_close(ntt(full, FT63, n_nonzero=10), ntt(head, FT63), rtol=0, atol=0)


def test_tables_are_buffers_that_move():
    t = NttTables(FT63, 16)
    assert {n for n, _ in t.named_buffers()} == {"tw", "tw_mont"}
    assert t.tw.shape == (8, 4) and t.tw_mont.shape == (8, 2)
    assert t.to("meta").device.type == "meta"


def test_bad_inputs_raise():
    x = torch.zeros((1, 16, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt(torch.zeros((1, 12, 4), dtype=torch.int32), FT63)
    with pytest.raises(ValueError):
        ntt(x, FT63, n_nonzero=17)
    with pytest.raises(ValueError):
        ntt(x, FT63, tables=NttTables(FT63, 32))
    with pytest.raises(ValueError, match="no kernel"):
        ntt(x.to("meta"), FT63)
