"""The port's expander (ops/expander.py) against the JAX package's.

- matgen: the port's generate gives the reference's GatherMat tables through
  the native walk and through the numpy stream simulation, with a level
  large enough (n * d >= 4096) that the vectorized path runs;
- gather_matvec_plain (K5's plain twin) equals the reference's XLA
  gather_matvec on the CPU, which tests/test_brakedown.py holds bit-equal to
  the Pallas kernel;
- ExpanderEncoder.encode equals the reference's, on the reference's own
  tables carried over by brakedown_encoding_from_reference.

Inputs come from np.random.default_rng; every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.codes.brakedown import BrakedownEncoding as JaxBrakedown
from lcpc_proof_of_storage_tpu.crypto.chacha import ChaChaRng as JaxChaCha
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.ops import expander as jax_ex
from lcpc_proof_of_storage_tpu_torch import native
from lcpc_proof_of_storage_tpu_torch.crypto.chacha import ChaChaRng
from lcpc_proof_of_storage_tpu_torch.fields import FIELDS, FT63, ints_to_limbs
from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field
from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
from lcpc_proof_of_storage_tpu_torch.utils.carry import brakedown_encoding_from_reference

torch.set_num_threads(1)


def _x(spec, b, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(b * n)]
    vals[0] = spec.modulus - 1
    return ints_to_limbs(vals, spec).reshape(b, n, -1)


def _host_library(use_native: bool, monkeypatch) -> None:
    """Keep the port's C++ host library, or switch it off so matgen runs its
    numpy stream simulation."""
    if use_native:
        assert native.native() is not None, "the host library did not build"
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)


def _same_tables(got: ex.GatherMat, want) -> None:
    assert (got.rows, got.cols) == (want.rows, want.cols)
    assert np.array_equal(got.idx, np.asarray(want.idx))
    assert np.array_equal(got.vals, np.asarray(want.vals))


@pytest.mark.parametrize("name,n,use_native", [
    ("ft63", 3000, True), ("ft63", 3000, False), ("ft255", 700, True),
    ("ft253_192", 700, False)])
def test_generate_matches_reference(name, n, use_native, monkeypatch):
    """Every precode and postcode level of (n, seed 3), as GatherMat tables."""
    _host_library(use_native, monkeypatch)
    spec = FIELDS[name]
    jspec = jax_field.FIELDS[name]
    pre, post = ex.generate(n, 3, spec, ex.SDIG_CODE_3)
    jpre, jpost = jax_ex.generate(n, 3, jspec, jax_ex.SDIG_CODE_3)
    assert pre[0].idx_np is not None and pre[0].cols * pre[0].idx_np.shape[1] >= 4096
    for got, want in zip(pre + post, jpre + jpost):
        _same_tables(ex.to_gather(got, spec), jax_ex.to_gather(want, jspec))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_gen_code_matches_draw_by_draw(use_native, monkeypatch):
    """Vectorized gen_code against the port's and the reference's sequential
    oracle, including collision-heavy columns (small m), and the same RNG
    consumption."""
    _host_library(use_native, monkeypatch)
    for n, m, d in [(2000, 700, 8), (1500, 24, 6)]:
        seed = bytes((i * 7 + 3) & 0xFF for i in range(32))
        r1, r2, r3 = ChaChaRng(seed, 20), ChaChaRng(seed, 20), JaxChaCha(seed, 20)
        a = ex.gen_code(n, m, d, r1, FT63)
        b = ex.gen_code_seq(n, m, d, r2, FT63)
        c = jax_ex.gen_code_seq(n, m, d, r3, jax_field.FT63)
        assert a.idx_np is not None
        assert a.col_indices == b.col_indices == c.col_indices
        assert a.col_values == b.col_values == c.col_values
        assert (r1.next_u64_array(8) == r2.next_u64_array(8)).all()


@pytest.mark.parametrize("name,n,b", [("ft255", 300, 2), ("ft253_192", 300, 1)])
def test_gather_matvec_plain_matches_reference(name, n, b):
    """The first postcode level (the widest K) of an n-column code."""
    spec, jspec = FIELDS[name], jax_field.FIELDS[name]
    _, jpost = jax_ex.generate(n, 5, jspec, jax_ex.SDIG_CODE_3)
    jgm = jax_ex.to_gather(jpost[0], jspec)
    x = _x(spec, b, jgm.cols, n)
    want = np.asarray(jax_ex.gather_matvec(jgm, jnp.asarray(x), jspec)).astype(np.int32)
    tab = ex.GatherTables(ex.GatherMat(jgm.rows, jgm.cols, jgm.idx, jgm.vals))
    xt = torch.from_numpy(x.astype(np.int32))
    assert np.array_equal(ex.gather_matvec_plain(tab, xt, spec).numpy(), want)
    assert np.array_equal(ex.gather_matvec(tab, xt, spec).numpy(), want)


def test_gather_tables_layout_and_counts():
    """K5's tables: vals is (K, W, rows) 32-bit words; the rows are ordered
    by slot count, longest first (table row r holds output row order[r]);
    counts stop at each row's last nonzero slot; read back through the order,
    the tables hold every (row, slot) of the GatherMat once; padded slots
    (index 0, value 0) add nothing."""
    rng = np.random.default_rng(11)
    K, rows, cols, L = 5, 7, 9, FT63.num_limbs16
    W = L // 2
    idx = rng.integers(0, cols, size=(K, rows)).astype(np.int32)
    vals = _x(FT63, K, rows, 11).astype(np.uint32)
    vals[3:, 0] = 0                      # row 0 uses 3 slots
    vals[:, 1] = 0                       # row 1 none
    vals[2, 2] = 0                       # row 2: a zero inside, 5 slots counted
    vals[4:, 3] = 0                      # row 3 uses 4
    tab = ex.GatherTables(ex.GatherMat(rows, cols, idx, vals))
    order, counts = tab.order.numpy(), tab.counts.numpy()
    assert tab.vals.shape == (K, W, rows) and tab.idx.shape == (K, rows)
    assert sorted(order.tolist()) == list(range(rows))
    assert (np.diff(counts) <= 0).all()
    assert counts[np.argsort(order)].tolist() == [3, 0, 5, 4, 5, 5, 5]
    covered = [(int(order[r]), s) for r in range(rows) for s in range(counts[r])]
    assert len(covered) == len(set(covered)) == counts.sum()
    assert set(covered) == {(r, s) for r, n in enumerate([3, 0, 5, 4, 5, 5, 5])
                            for s in range(n)}
    words = tab.vals.numpy().view(np.uint32)
    limbs = np.stack([words & 0xFFFF, words >> 16], axis=2).reshape(K, L, rows)
    back_vals = np.empty_like(vals)
    back_vals[:, order] = limbs.transpose(0, 2, 1)
    back_idx = np.empty_like(idx)
    back_idx[:, order] = tab.idx.numpy()
    assert np.array_equal(back_vals, vals) and np.array_equal(back_idx, idx)
    x = torch.from_numpy(_x(FT63, 2, cols, 12).astype(np.int32))
    y = ex.gather_matvec(tab, x, FT63)
    assert not y[:, 1].any()
    want = limb_field(FT63).dot(torch.from_numpy(vals[:3, 0].astype(np.int32))[None],
                  x[:, torch.from_numpy(idx[:3, 0]).long()], axis=1)
    assert torch.equal(y[:, 0], want.to(torch.int32))


def test_encode_matches_reference_on_its_tables():
    """ExpanderEncoder.encode (its ft63 levels through gather_matvec) on
    tables carried over from the reference (no port matgen) equals the
    reference's encode, and the port's own matgen builds the same encoder."""
    spec, jspec, length = FT63, jax_field.FT63, 3000
    jenc = JaxBrakedown.new(length, seed=2, field=jspec)
    enc = brakedown_encoding_from_reference(jenc)
    assert (enc.n_per_row, enc.n_cols) == (jenc.n_per_row, jenc.n_cols)
    x = _x(spec, 2, jenc.n_per_row, length)
    want = np.asarray(jax.jit(jenc._enc.encode)(jnp.asarray(x))).astype(np.int32)
    got = enc.encoder.encode(torch.from_numpy(x.astype(np.int32)))
    assert np.array_equal(got.numpy(), want)
    own = ex.ExpanderEncoder.build(jenc.n_per_row, 2, spec, ex.SDIG_CODE_3)
    for a, b in zip([*own.pre, *own.post], [*enc.encoder.pre, *enc.encoder.post]):
        assert torch.equal(a.idx, b.idx) and torch.equal(a.vals, b.vals)
    assert torch.equal(own.vander, enc.encoder.vander)


def test_encoder_copies_per_device():
    """on() keeps one copy per device and the CPU copy is the encoder itself."""
    enc = ex.ExpanderEncoder.build(100, 0, FT63, ex.SDIG_CODE_3)
    assert enc.on(torch.device("cpu")) is enc
    assert enc.codeword_len == (enc.n_per_row + enc.post[-1].cols
                                + sum(t.rows for t in enc.pre[:-1])
                                + sum(t.rows for t in enc.post))
