"""The port's streamed (out-of-core) commit and prove against the JAX package.

- row batches aligned to Blake3 chunks, chunk chaining values and their
  merge, equal to the reference's functions;
- the streamed collapse step (K3p's plain version: 16-bit coefficients and
  an accumulator) against the reference's packed collapse kernel, run in
  Pallas interpret mode with its row chunking forced;
- every keep_comm x device_coeffs mode: root equal to the reference's
  streamed root and to the port's one-shot root, proof bytes equal to the
  reference's streamed proof, and the proofs verify under both packages;
- the golden pins `streamed_boundary_root` and `streamed_proof_sha`, a
  multi-chunk Brakedown streamed root, and the port's own synthetic pin;
- Ligero on two routes and Brakedown, every keep_comm mode: root and kept
  16-bit matrix equal to the one-shot commit's; Ligero's batches reach the
  encoding's encode as stored.

All comparisons are exact.  The reference side runs ft63 (its ft255 graphs
compile for tens of seconds each on the CPU); the port side also runs ft255
and ft253_192.
"""

import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lcpc_proof_of_storage_tpu.codes.ligero import LigeroEncoding as JaxLigero
from lcpc_proof_of_storage_tpu.core import commit as jax_core
from lcpc_proof_of_storage_tpu.core import streamed as jax_streamed
from lcpc_proof_of_storage_tpu.crypto.transcript import Transcript as JaxTranscript
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.fields.limb import limb_field as jax_limb_field
from lcpc_proof_of_storage_tpu.ops import blake3_jax
from lcpc_proof_of_storage_tpu.utils import serde as jax_serde
from lcpc_proof_of_storage_tpu_torch.codes.brakedown import BrakedownEncoding
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.core import commit as port
from lcpc_proof_of_storage_tpu_torch.core import storage, streamed
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT253_192, FT255, ints_to_limbs
from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field, narrow_limbs
from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse
from lcpc_proof_of_storage_tpu_torch.ops.expander import SDIG_CODE_3, ExpanderEncoder
from lcpc_proof_of_storage_tpu_torch.utils import serde

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden_vectors.json").read_text())
# Root of the port's streamed commit of SyntheticCoeffs(SYNTHETIC_LENGTH,
# seed=SYNTHETIC_SEED) under Ligero ft63 (4, 16).  chip_smoke.py reads these
# three constants and reproduces the root on CUDA.
SYNTHETIC_SEED = 42
SYNTHETIC_LENGTH = 1203
SYNTHETIC_PIN = "ff0c4b992056a5c620d98493bf4c4baec683e7d4d29dc360ff30b1dcb0901736"
X = 123456789


def _tr(root: bytes, cls=Transcript):
    tr = cls(b"streamed")
    tr.append_message(b"polycommit", root)
    return tr


def _outer_inner(spec, n_rows, n_per_row, x=X):
    p = spec.modulus
    xr = pow(x, n_per_row, p)
    return [pow(xr, i, p) for i in range(n_rows)], [pow(x, j, p) for j in range(n_per_row)]


def _horner(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


# -- batches, chunk CVs -------------------------------------------------------

@pytest.mark.parametrize("spec", [FT63, FT255, FT253_192], ids=lambda s: s.name)
def test_row_batches_match_reference(spec):
    W = spec.repr_bytes
    for n_rows in (1, 7, 31, 64, 97, 215, 501, 2048):
        for target in (1, 16, 40, 64, 100, 1024):
            got = streamed._row_batches(n_rows, W, target)
            assert got == jax_streamed._row_batches(n_rows, W, target)
            for _, end in got[:-1]:
                assert (32 + end * W) % 1024 == 0


@pytest.mark.parametrize("k,tail_len,chunk0", [(1, 1024, 0), (3, 1024, 5), (2, 392, 7),
                                               (1, 32, 64)])
def test_chunk_cvs_words_and_merge_match_reference(k, tail_len, chunk0):
    rng = np.random.default_rng(k * 1000 + tail_len)
    words = rng.integers(0, 1 << 32, size=(5, k * 256), dtype=np.uint64).astype(np.uint32)
    words[:, (k - 1) * 256 + -(-tail_len // 4):] = 0          # zero past the message end
    counters = np.arange(chunk0, chunk0 + k, dtype=np.uint32)
    want = np.asarray(blake3_jax.chunk_cvs_words(jnp.asarray(words), jnp.asarray(counters),
                                                 tail_len))
    got = blake3.chunk_cvs_words(torch.from_numpy(words.astype(np.int64)),
                                 torch.from_numpy(counters.astype(np.int64)), tail_len)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    both = np.concatenate([want, want[:, ::-1]], axis=1)        # >= 2 chunks to merge
    assert np.array_equal(
        blake3.merge_cvs(torch.from_numpy(both.view(np.int32).copy())).numpy().view(np.uint32),
        np.asarray(blake3_jax.merge_chunk_cvs(jnp.asarray(both))))


@pytest.mark.parametrize("spec,n_rows,target", [(FT63, 301, 100), (FT255, 97, 40),
                                                (FT253_192, 70, 33)],
                         ids=["ft63", "ft255", "ft253_192"])
def test_batch_chunk_cvs_merge_to_reference_leaves(spec, n_rows, target):
    """The chunk CVs of every chunk-aligned row batch (the first with the 32
    zero bytes, the last with a partial chunk), merged, are the reference's
    one-shot column leaves."""
    rng = np.random.default_rng(n_rows)
    L = spec.num_limbs16
    comm = rng.integers(0, 1 << 16, size=(n_rows, 9, L)).astype(np.int32)
    comm[..., L - 1] &= 0x3FFF
    total = -(-(32 + n_rows * spec.repr_bytes) // 1024)
    cvs = torch.empty((9, total, 8), dtype=torch.int32)
    chunk0 = 0
    for r0, r1 in streamed._row_batches(n_rows, spec.repr_bytes, target):
        blake3.chunk_cvs(torch.from_numpy(comm[r0:r1]), spec, cvs, chunk0, r0 == 0)
        chunk0 += blake3.batch_chunks(r1 - r0, spec, r0 == 0)[0]
    assert chunk0 == total
    want = np.asarray(blake3_jax.hash_columns(jnp.asarray(comm.astype(np.uint32)),
                                              jax_field.FIELDS[spec.name]))
    assert np.array_equal(blake3.merge_cvs(cvs).numpy().view(np.uint32), want)


# -- K3p plain version against the reference's packed kernel ------------------

@pytest.fixture()
def interpret_pallas(monkeypatch):
    """The reference's packed collapse in Pallas interpret mode, with its
    2048-row chunking forced down to 4 rows."""
    import lcpc_proof_of_storage_tpu.ops.collapse_pallas as cp
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(cp, "_MAX_ROWS", 4)
    cp._collapse_call.cache_clear()
    yield cp
    cp._collapse_call.cache_clear()


def test_collapse_step_matches_packed_kernel(interpret_pallas):
    """K3p's plain version on 16-bit coefficients (int16 bit patterns, limbs
    above 2^15 included), with and without an accumulator, against the
    reference's collapse_tensors over uint16 input (11 rows: three 4-row
    chunks) plus its field add."""
    spec, jspec = FT63, jax_field.FT63
    rng = np.random.default_rng(7)
    rows, npr, T = 11, 140, 2
    c16 = rng.integers(0, 1 << 16, size=(rows, npr, 4)).astype(np.uint16)
    c16[..., 3] &= 0x3FFF
    t = rng.integers(0, 1 << 16, size=(T, rows, 4)).astype(np.uint32)
    t[..., 3] &= 0x3FFF
    acc = rng.integers(0, 1 << 16, size=(T, npr, 4)).astype(np.uint32)
    acc[..., 3] &= 0x3FFF
    want = np.asarray(interpret_pallas.collapse_tensors(jnp.asarray(c16), jnp.asarray(t), jspec))
    want_acc = np.asarray(jax_limb_field(jspec).add(jnp.asarray(acc), jnp.asarray(want)))
    c_port = torch.from_numpy(c16.view(np.int16).copy())
    t_port = torch.from_numpy(t.astype(np.int32))
    assert np.array_equal(collapse.collapse(c_port, t_port, spec).numpy(), want.astype(np.int32))
    got_acc = collapse.collapse(c_port, t_port, spec, acc=torch.from_numpy(acc.astype(np.int32)))
    assert np.array_equal(got_acc.numpy(), want_acc.astype(np.int32))


# -- the streamed path against the reference ----------------------------------

@pytest.fixture(scope="module")
def case():
    """Ligero ft63 (4, 16), 301 rows (3 chunks a column), batches of 124,
    128 and 49 rows; the reference's streamed commit (keep_comm=False) and
    its proof."""
    spec, jspec = FT63, jax_field.FT63
    rng = np.random.default_rng(20261016)
    length = 4 * 300 + 3
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=length)]
    jenc = JaxLigero(jspec, 4, 16)
    jcomm = jax_streamed.commit_streamed(coeffs, jenc, target_batch_rows=100, keep_comm=False)
    root = jcomm.get_root().root
    outer, inner = _outer_inner(spec, jcomm.n_rows, 4)
    jblob = jax_serde.serialize_proof(jax_core.prove(jcomm, outer, jenc, _tr(root, JaxTranscript)),
                                      jspec)
    enc = LigeroEncoding(spec, 4, 16)
    return dict(spec=spec, jspec=jspec, coeffs=coeffs, jenc=jenc, jcomm=jcomm, root=root,
                outer=outer, inner=inner, jblob=jblob, enc=enc,
                value=_horner(coeffs, X, spec.modulus))


def _coeff_input(case, form):
    if form == "ints":
        return case["coeffs"]
    return ints_to_limbs(case["coeffs"], case["spec"]).astype(np.uint16)


@pytest.mark.parametrize("device_coeffs,form", [(True, "ints"), (True, "uint16"),
                                                (False, "uint16")])
@pytest.mark.parametrize("keep_comm", [True, False, "device"])
def test_streamed_modes_match_reference(case, keep_comm, device_coeffs, form, monkeypatch):
    """Root equal to the reference's streamed root and to the port's
    one-shot root; the proof, made with 3-row collapse and re-encode batches
    where the commitment keeps no encoded matrix, equal in bytes to the
    reference's streamed proof and verified by the port."""
    spec, enc = case["spec"], case["enc"]
    comm = streamed.commit_streamed(_coeff_input(case, form), enc, target_batch_rows=100,
                                    keep_comm=keep_comm, device_coeffs=device_coeffs,
                                    device="cpu")
    assert comm.get_root().root == case["root"]
    assert port.commit(case["coeffs"], enc, device="cpu").get_root().root == case["root"]
    if keep_comm is True:
        assert isinstance(comm.comm, np.ndarray) and comm.comm.dtype == np.uint16
    elif keep_comm == "device":
        assert comm.comm.dtype == torch.int16
    else:
        assert comm.comm is None
    if device_coeffs:
        assert comm.coeffs.dtype == (torch.int32 if form == "ints" else torch.int16)
    else:
        assert isinstance(comm.coeffs, np.ndarray) and comm.coeffs.dtype == np.uint16
    monkeypatch.setattr(storage, "BATCH_BYTES", 3 * 16 * 4 * 4)
    proof = port.prove(comm, case["outer"], enc, _tr(case["root"]))
    assert serde.serialize_proof(proof, spec) == case["jblob"]
    assert port.verify(case["root"], case["outer"], case["inner"], proof, enc,
                       _tr(case["root"]), device="cpu") == case["value"]


def test_proofs_cross_verify(case):
    """The reference's streamed proof verifies under the port, and the port's
    (host coefficients, no encoded matrix kept) under the reference."""
    spec, enc = case["spec"], case["enc"]
    blob_proof = serde.deserialize_proof(case["jblob"], spec)
    assert port.verify(case["root"], case["outer"], case["inner"], blob_proof, enc,
                       _tr(case["root"]), device="cpu") == case["value"]
    comm = streamed.commit_streamed(_coeff_input(case, "uint16"), enc, target_batch_rows=100,
                                    keep_comm=False, device_coeffs=False, device="cpu")
    blob = serde.serialize_proof(port.prove(comm, case["outer"], enc, _tr(case["root"])), spec)
    jproof = jax_serde.deserialize_proof(blob, case["jspec"])
    assert jax_core.verify(case["root"], case["outer"], case["inner"], jproof, case["jenc"],
                           _tr(case["root"], JaxTranscript)) == case["value"]


def test_streamed_pieces_in_small_batches(case):
    """The batched collapse (K3p's step) and re-encode of opened columns over
    2-row batches of host coefficients equal the one-shot collapse and
    column gather; the host store keeps one pinned-staging pair for the
    commitment's life (none on the CPU)."""
    spec, enc = case["spec"], case["enc"]
    lf = limb_field(spec)
    one = port.commit(case["coeffs"], enc, device="cpu")
    host = streamed.commit_streamed(_coeff_input(case, "uint16"), enc, target_batch_rows=100,
                                    keep_comm=False, device_coeffs=False, device="cpu")
    assert isinstance(host.coeff_rows, storage.HostRows) and host.comm_rows is None
    tensors = [case["outer"], list(range(1, one.n_rows + 1))]
    t = torch.stack([lf.array(tv) for tv in tensors])
    want = collapse.collapse(one.coeffs, t, spec)
    assert torch.equal(host.coeff_rows.collapse(t, spec, target_batch_rows=2), want)
    assert torch.equal(one.coeff_rows.collapse(t, spec), want)
    cols = [0, 5, 15, 5]
    want_cols = one.comm[:, cols].numpy().astype(np.uint32)
    assert np.array_equal(one.comm_rows.gather(cols), want_cols)
    for rows in (host.coeff_rows, one.coeff_rows):
        assert np.array_equal(rows.open_columns(enc, host.n_cols, cols, target_batch_rows=2),
                              want_cols)
    assert host.coeff_rows.staging_bytes() == 0


def test_commitments_without_matrix_or_coefficients(case):
    """A streamed commitment that kept no encoded matrix opens columns only
    inside prove; a synthetic one cannot prove."""
    enc = case["enc"]
    slim = streamed.commit_streamed(case["coeffs"], enc, target_batch_rows=100,
                                    keep_comm=False, device="cpu")
    with pytest.raises(port.ProverError):
        port.open_column(slim, 3)
    syn = streamed.commit_streamed(streamed.SyntheticCoeffs(SYNTHETIC_LENGTH, 1), enc,
                                   keep_comm=False, device="cpu")
    assert syn.coeffs is None and syn.comm is None
    with pytest.raises(port.ProverError):
        port.prove(syn, case["outer"], enc, _tr(syn.get_root().root))


def test_synthetic_pin(case):
    """The port's own synthetic generator: the streamed root of
    SyntheticCoeffs is the pin, and equals the root that the reference's
    streamed commit gives for the materialized values."""
    src = streamed.SyntheticCoeffs(SYNTHETIC_LENGTH, seed=SYNTHETIC_SEED)
    syn = streamed.commit_streamed(src, case["enc"], target_batch_rows=100, keep_comm=False,
                                   device="cpu")
    assert syn.get_root().root.hex() == SYNTHETIC_PIN
    values = streamed.materialize(src, case["spec"]).numpy().view(np.uint16)
    assert values.dtype == np.uint16 and values.shape == (SYNTHETIC_LENGTH, 4)
    assert (values[:, 3] < FT63.modulus >> 48).all()
    jroot = jax_streamed.commit_streamed(values.astype(np.uint32), case["jenc"],
                                         target_batch_rows=100, keep_comm=False)
    assert jroot.get_root().root.hex() == SYNTHETIC_PIN
    other = streamed.commit_streamed(streamed.SyntheticCoeffs(SYNTHETIC_LENGTH, seed=43),
                                     case["enc"], target_batch_rows=100, keep_comm=False,
                                     device="cpu")
    assert other.get_root().root.hex() != SYNTHETIC_PIN


# -- pins and other codes -------------------------------------------------------

def test_golden_streamed_pins():
    """streamed_boundary_root and streamed_proof_sha: 32 ft63 rows in batches
    of 6 (a single chunk a column, so the one-shot commit), no encoded
    matrix kept, proved by re-encoding."""
    spec = FT63
    coeffs = [(i * 2654435761 + 12345) % spec.modulus for i in range(512)]
    enc = LigeroEncoding.new_from_dims(16, 64, spec)
    comm = streamed.commit_streamed(coeffs, enc, target_batch_rows=6, keep_comm=False,
                                    device="cpu")
    assert comm.comm is None
    root = comm.get_root().root
    tr = Transcript(b"golden")
    tr.append_message(b"polycommit", root)
    outer, _ = _outer_inner(spec, comm.n_rows, comm.n_per_row)
    blob = serde.serialize_proof(port.prove(comm, outer, enc, tr), spec)
    assert root.hex() == GOLDEN["streamed_boundary_root"]
    assert hashlib.sha256(blob).hexdigest() == GOLDEN["streamed_proof_sha"]


def test_brakedown_streamed_root_multi_chunk():
    """Brakedown ft63, 300 rows (3 chunks a column) in batches of 124, 128
    and 48 rows: the streamed root equals the one-shot root, and a proof
    from the streamed commitment (host coefficients, no matrix kept)
    verifies."""
    spec = FT63
    enc = BrakedownEncoding(ExpanderEncoder.build(32, 0, spec, SDIG_CODE_3))
    rng = np.random.default_rng(31)
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=32 * 300)]
    one = port.commit(coeffs, enc, device="cpu")
    assert one.n_rows == 300
    st = streamed.commit_streamed(coeffs, enc, target_batch_rows=128, keep_comm=False,
                                  device_coeffs=False, device="cpu")
    root = st.get_root().root
    assert root == one.get_root().root
    outer, inner = _outer_inner(spec, st.n_rows, st.n_per_row)
    proof = port.prove(st, outer, enc, _tr(root))
    assert serde.serialize_proof(proof, spec) == serde.serialize_proof(
        port.prove(one, outer, enc, _tr(root)), spec)
    assert port.verify(root, outer, inner, proof, enc, _tr(root), device="cpu") == \
        _horner(coeffs, X, spec.modulus)


def _kept_case_encoding(code):
    """(spec, encoding, n_rows, target rows a batch): every case has at least
    two Blake3 chunks a column and a ragged last batch."""
    if code == "brakedown":
        return FT63, BrakedownEncoding(ExpanderEncoder.build(32, 0, FT63, SDIG_CODE_3)), 300, 128
    if code == "ligero-stages":
        return FT255, LigeroEncoding(FT255, 4, 16), 70, 31
    return FT63, LigeroEncoding(FT63, 4, 16, ntt="four_step"), 301, 100


@pytest.mark.parametrize("form", ["uint16", "ints"])
@pytest.mark.parametrize("keep_comm", [True, False, "device"])
@pytest.mark.parametrize("code", ["ligero-stages", "ligero-four_step", "brakedown"])
def test_streamed_kept_matrix_matches_one_shot(code, keep_comm, form):
    """The streamed commit's root and kept 16-bit matrix (written by the
    encoding's encode_stored: on Ligero's stages route, K1's own 16-bit
    rows) equal the one-shot commit's root and the narrowing of its
    matrix."""
    spec, enc, n_rows, target = _kept_case_encoding(code)
    npr = enc.get_dims(1)[1]
    rng = np.random.default_rng(n_rows + len(code))
    length = n_rows * npr - npr // 2                      # a ragged last row
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=length)]
    one = port.commit(coeffs, enc, device="cpu")
    assert one.n_rows == n_rows
    given = coeffs if form == "ints" else ints_to_limbs(coeffs, spec).astype(np.uint16)
    st = streamed.commit_streamed(given, enc, target_batch_rows=target, keep_comm=keep_comm,
                                  device="cpu")
    assert len(streamed._row_batches(n_rows, spec.repr_bytes, target)) >= 3
    assert st.get_root().root == one.get_root().root
    want = narrow_limbs(one.comm)
    if keep_comm == "device":
        assert st.comm.dtype == torch.int16 and torch.equal(st.comm, want)
    elif keep_comm:
        assert st.comm.dtype == np.uint16
        assert np.array_equal(st.comm, want.numpy().view(np.uint16))
    else:
        assert st.comm is None


@pytest.mark.parametrize("keep_comm", [True, False, "device"])
def test_streamed_ligero_batches_go_through_encode(keep_comm):
    """Each row batch of a streamed Ligero commit reaches the encoding's
    encode as stored (16-bit rows, with the destination of its kept 16-bit
    codewords), so a wrapper set on an instance's encode sees and can alter
    every batch: what was kept is what the wrapper returned or wrote."""
    spec, enc, n_rows, target = _kept_case_encoding("ligero-stages")
    npr = enc.get_dims(1)[1]
    rng = np.random.default_rng(5)
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=n_rows * npr)]
    seen = []
    encode = enc.encode

    def spy(rows, *args, **kwargs):
        seen.append((rows.dtype, rows.shape[0], args))
        return encode(rows, *args, **kwargs)

    enc.encode = spy
    st = streamed.commit_streamed(ints_to_limbs(coeffs, spec).astype(np.uint16), enc,
                                  target_batch_rows=target, keep_comm=keep_comm, device="cpu")
    batches = streamed._row_batches(n_rows, spec.repr_bytes, target)
    assert [(d, b) for d, b, _ in seen] == [(torch.int16, r1 - r0) for r0, r1 in batches]
    assert all((a[0] is None) == (keep_comm is False) for _, _, a in seen)
    assert st.get_root().root == port.commit(coeffs, LigeroEncoding(spec, 4, 16),
                                             device="cpu").get_root().root


@pytest.mark.parametrize("spec,dims", [(FT63, (16, 64)), (FT255, (4, 16))], ids=["ft63", "ft255"])
def test_serialized_proof_len(spec, dims):
    """serialized_proof_len gives the bytes of a serialized proof (chip_smoke
    holds the 2^29 proof to it)."""
    enc = LigeroEncoding(spec, *dims)
    coeffs = list(range(1, 20 * dims[0]))
    comm = port.commit(coeffs, enc, device="cpu")
    outer, _ = _outer_inner(spec, comm.n_rows, comm.n_per_row)
    blob = serde.serialize_proof(port.prove(comm, outer, enc, _tr(comm.get_root().root)), spec)
    assert len(blob) == serde.serialized_proof_len(
        comm.n_rows, comm.n_per_row, comm.n_cols, enc.get_n_degree_tests(),
        enc.get_n_col_opens(), spec)
