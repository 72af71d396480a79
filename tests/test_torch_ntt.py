"""Port NTT (plain PyTorch) against the JAX package's ops.ntt.

Exact equality.  Rows are zero past n_nonzero, as the Ligero encode gives
them; the port reads only the first n_nonzero positions.  The inverse
(K4's plain version), the Ligero row encode / decode and
``LigeroEncoding.decode`` are held against the reference's ``intt``,
``encode_rows``, ``decode_rows`` and ``LigeroEncoding.decode``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.codes.ligero import LigeroEncoding as JaxLigero
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.fields.field import FT63, FT127, FT191, FT255, ints_to_limbs
from lcpc_proof_of_storage_tpu.ops import ntt as jax_ntt
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.fields import field as port_field
from lcpc_proof_of_storage_tpu_torch.ops.ntt import (NttTables, decode_rows, encode_rows, intt,
                                                     intt_plain, ntt, ntt_plain)

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
    assert {n for n, _ in t.named_buffers()} == {"tw", "tw_mont", "tw_inv", "tw_inv_mont",
                                                 "n_inv"}
    assert t.tw.shape == (8, 4) and t.tw_mont.shape == (8, 2)
    assert t.tw_inv.shape == (8, 4) and t.tw_inv_mont.shape == (8, 2)
    assert t.n_inv.shape == (4,) and t.n_inv_mont.shape == (2,)
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


# the wide fields' reference graphs take seconds each to compile on the CPU,
# so they run at the two ends of the range; ft63 runs every size
INV_CASES = ([("ft63", k) for k in range(4, 13)]
             + [(f, k) for f in ("writeable_ft63", "ft255", "ft253_192") for k in (4, 12)])


@pytest.mark.parametrize("field,log_n", INV_CASES, ids=[f"{f}-2^{k}" for f, k in INV_CASES])
def test_intt_and_row_codec_match_reference(field, log_n):
    """intt and decode_rows against the reference's decode_rows (which is
    its intt cut to n_per_row: here all n), and encode_rows against its
    encode_rows at n_per_row = n/2, as the PoS dims give it; exactly."""
    jspec, tspec = jax_field.FIELDS[field], port_field.FIELDS[field]
    n = 1 << log_n
    x = _rows(jspec, 2, n, n, 30 + log_n)
    want = np.asarray(jax_ntt.decode_rows(jnp.asarray(x), jspec, n)).astype(np.int32)
    xt = torch.from_numpy(x.astype(np.int32))
    np.testing.assert_array_equal(intt(xt, tspec).numpy(), want)
    np.testing.assert_array_equal(decode_rows(xt, tspec, n // 2).numpy(), want[:, : n // 2])
    rows = x[:, : n // 2]
    np.testing.assert_array_equal(
        encode_rows(torch.from_numpy(rows.astype(np.int32)), tspec, n).numpy(),
        np.asarray(jax_ntt.encode_rows(jnp.asarray(rows), jspec, n)).astype(np.int32))


@pytest.mark.parametrize("spec", [port_field.FT63, port_field.FT191, port_field.FT253_192],
                         ids=lambda s: s.name)
def test_intt_inverts_ntt(spec):
    x = torch.from_numpy(_rows(spec, 3, 64, 64, 11).astype(np.int32))
    tables = NttTables(spec, 64)
    np.testing.assert_array_equal(intt(ntt(x, spec, tables=tables), spec, tables).numpy(),
                                  x.numpy())
    np.testing.assert_array_equal(ntt(intt_plain(x, spec), spec).numpy(), x.numpy())


def test_ligero_decode_matches_reference():
    """LigeroEncoding.decode returns all n_cols coefficients, as the
    reference's does; decode(encode(rows)) gives the rows back, zero-padded."""
    jenc = JaxLigero.new_from_dims(16, 64, FT63)
    tenc = LigeroEncoding.new_from_dims(16, 64, port_field.FT63)
    cw = _rows(FT63, 3, 64, 64, 12)
    want = np.asarray(jenc.decode(jnp.asarray(cw))).astype(np.int32)
    got = tenc.decode(torch.from_numpy(cw.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    rows = torch.from_numpy(_rows(FT63, 2, 16, 16, 13).astype(np.int32))
    back = tenc.decode(tenc.encode(rows))
    np.testing.assert_array_equal(back[:, :16].numpy(), rows.numpy())
    assert not back[:, 16:].any()


def test_intt_bad_inputs_raise():
    with pytest.raises(ValueError):
        intt(torch.zeros((1, 12, 4), dtype=torch.int32), port_field.FT63)
    with pytest.raises(ValueError, match="no kernel"):
        intt(torch.zeros((1, 16, 4), dtype=torch.int32).to("meta"), port_field.FT63)
