"""The port's K1 entry on rows as they are stored (``ops/ntt.py ntt_rows``,
``csrc/ntt.cu lcpc_ntt_forward_rows``) on the CPU.

- int16 (16-bit limbs) and int32 rows narrower than n give ``ntt`` of the
  zero-padded int32 rows, and ``out16`` gets those evaluations as 16-bit
  limbs, for widths that are not powers of two, n_nonzero of 1, the width
  and a ragged value, at one-pass and two-pass sizes of K1's plan;
- the byte identity the kernel relies on: 16-bit limbs stored as int16 are
  the values' 32-bit words (``pack_words``), so K1 loads and stores them as
  words;
- bad shapes, dtypes and devices raise;
- ``LcEncoding.encode_stored`` on every Ligero route and Brakedown equals
  the widen, ``encode`` and narrow it replaces.

No JAX: the reference is the port's own ``ntt`` on padded rows.
"""

import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu_torch.codes.brakedown import BrakedownEncoding
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT191, FT255
from lcpc_proof_of_storage_tpu_torch.fields.limb import narrow_limbs, widen_limbs
from lcpc_proof_of_storage_tpu_torch.ops.expander import SDIG_CODE_3, ExpanderEncoder
from lcpc_proof_of_storage_tpu_torch.ops.ntt import (K_MAX, NttTables, ntt, ntt_pass_plan,
                                                     ntt_rows, pack_words)

torch.set_num_threads(1)

# (field, n, width): K1 takes one pass at 2^10 and two at 2^11 (ntt_pass_plan)
SHAPES = [(FT63, 1 << K_MAX, 300), (FT255, 1 << (K_MAX + 1), 1000),
          (FT191, 1 << (K_MAX + 1), 1 << (K_MAX + 1))]


def _rows(spec, batch, width, seed):
    """Canonical random (batch, width, L) limbs as uint16."""
    rng = np.random.default_rng(seed)
    L = spec.num_limbs16
    x = rng.integers(0, 1 << 16, size=(batch, width, L))
    x[..., L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=(batch, width))
    return x.astype(np.uint16)


def _padded_ntt(rows16: np.ndarray, spec, n: int, n_nonzero: int, tables) -> torch.Tensor:
    batch, width, L = rows16.shape
    padded = np.zeros((batch, n, L), np.int32)
    padded[:, :width] = rows16
    return ntt(torch.from_numpy(padded), spec, n_nonzero, tables)


@pytest.mark.parametrize("nnz", ["one", "width", "ragged"])
@pytest.mark.parametrize("spec,n,width", SHAPES,
                         ids=[f"{s.name}-n{n}-w{w}" for s, n, w in SHAPES])
def test_ntt_rows_equals_padded_ntt(spec, n, width, nnz):
    assert len(ntt_pass_plan(n)) == (1 if n <= 1 << K_MAX else 2)
    n_nonzero = {"one": 1, "width": width, "ragged": width * 5 // 7 + 3}[nnz]
    tables = NttTables(spec, n)
    rows16 = _rows(spec, 2, width, n + width + n_nonzero)
    want = _padded_ntt(rows16, spec, n, n_nonzero, tables)
    want16 = want.numpy().astype(np.uint16)
    for x in (torch.from_numpy(rows16.view(np.int16)),
              torch.from_numpy(rows16.astype(np.int32))):
        out16 = torch.full(want.shape, 7, dtype=torch.int16)
        got = ntt_rows(x, spec, n, n_nonzero, tables, out16=out16)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert np.array_equal(out16.numpy().view(np.uint16), want16)
    got = ntt_rows(torch.from_numpy(rows16.view(np.int16)), spec, n, n_nonzero, tables)
    assert torch.equal(got, want)


def test_ntt_rows_default_n_nonzero_and_row_slice_destination():
    """n_nonzero defaults to the width; out16 may be a row slice of a larger
    int16 matrix (the streamed commit's kept rows), whose other rows stay."""
    spec, n, width = FT63, 64, 24
    tables = NttTables(spec, n)
    rows16 = _rows(spec, 3, width, 5)
    kept = torch.full((7, n, spec.num_limbs16), -1, dtype=torch.int16)
    got = ntt_rows(torch.from_numpy(rows16.view(np.int16)), spec, n, tables=tables,
                   out16=kept[2:5])
    want = _padded_ntt(rows16, spec, n, width, tables)
    assert torch.equal(got, want)
    assert torch.equal(kept[2:5], narrow_limbs(want))
    assert (kept[:2] == -1).all() and (kept[5:] == -1).all()


@pytest.mark.parametrize("spec", [FT63, FT191, FT255], ids=lambda s: s.name)
def test_int16_limbs_are_the_kernels_words(spec):
    """A value's 16-bit limbs stored as int16 are, byte for byte, its W
    little-endian 32-bit words: K1 loads the rows and stores out16 as words."""
    rows16 = torch.from_numpy(_rows(spec, 3, 11, 9).view(np.int16))
    assert torch.equal(rows16.view(torch.int32), pack_words(widen_limbs(rows16)))
    limbs = widen_limbs(rows16)
    assert torch.equal(narrow_limbs(limbs).view(torch.int32), pack_words(limbs))


def test_ntt_rows_bad_inputs_raise():
    spec, n = FT63, 32
    L = spec.num_limbs16
    x = torch.zeros((2, 20, L), dtype=torch.int16)
    with pytest.raises(ValueError, match="rows of 40 values"):
        ntt_rows(torch.zeros((2, 40, L), dtype=torch.int16), spec, n)
    with pytest.raises(ValueError, match="power of two"):
        ntt_rows(x, spec, 48)
    with pytest.raises(ValueError, match="n_nonzero"):
        ntt_rows(x, spec, n, 21)
    with pytest.raises(ValueError, match="expected"):
        ntt_rows(torch.zeros((2, 20, L + 1), dtype=torch.int16), spec, n)
    with pytest.raises(TypeError, match="int16 or int32"):
        ntt_rows(x.to(torch.int64), spec, n)
    with pytest.raises(ValueError, match="out16 must be"):
        ntt_rows(x, spec, n, out16=torch.empty((2, n // 2, L), dtype=torch.int16))
    with pytest.raises(TypeError, match="out16 must be int16"):
        ntt_rows(x, spec, n, out16=torch.empty((2, n, L), dtype=torch.int32))
    with pytest.raises(ValueError, match="out16 must be"):
        ntt_rows(x, spec, n, out16=torch.empty((2, n, L), dtype=torch.int16, device="meta"))


def _encodings(spec):
    yield "ligero-stages", LigeroEncoding(spec, 24, 64)
    yield "ligero-four_step", LigeroEncoding(spec, 24, 64, ntt="four_step")
    yield "ligero-fused_small", LigeroEncoding(spec, 24, 64, ntt="fused_small")
    yield "brakedown", BrakedownEncoding(ExpanderEncoder.build(24, 0, spec, SDIG_CODE_3))


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
def test_encode_stored_equals_widen_encode_narrow(spec):
    """encode_stored of int16 and int32 rows: the codewords of encode on the
    widened rows, and out16 their narrowing, on every code and route."""
    rows16 = _rows(spec, 3, 24, 17)
    for name, enc in _encodings(spec):
        want = enc.encode(torch.from_numpy(rows16.astype(np.int32)))
        for x in (torch.from_numpy(rows16.view(np.int16)),
                  torch.from_numpy(rows16.astype(np.int32))):
            out16 = torch.empty(want.shape, dtype=torch.int16)
            assert torch.equal(enc.encode_stored(x, out16), want), name
            assert torch.equal(out16, narrow_limbs(want)), name
            assert torch.equal(enc.encode_stored(x), want), name
