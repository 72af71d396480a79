"""The port's proof-of-storage row and column API against the JAX package's.

The single-row and single-column entry points of ``pos/storage.py``,
``pos/file_handler.py`` and ``pos/online.py`` on the same files and inputs
as the reference's, on the CPU (the plain versions of K1 and K2):
- encoded rows, written rows and the files they leave;
- a row replaced by its decoded bytes, then the recalculated tree, against
  the reference handler's and a fresh writer's over the edited raw bytes;
- the handler's digests, the server's retrieved columns and the columns of
  a one-shot commit;
- both checks without full columns: honest inputs pass, a flipped digest or
  path byte fails;
- the inner product, and the accumulator's and writer's finalisers.

All comparisons are exact (integer fields and hashes).
"""

import random

import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields import field as jf
from lcpc_proof_of_storage_tpu.pos import file_handler as jfh
from lcpc_proof_of_storage_tpu.pos import online as jon
from lcpc_proof_of_storage_tpu.pos import storage as js
from lcpc_proof_of_storage_tpu_torch.fields import field as tf
from lcpc_proof_of_storage_tpu_torch.pos import file_handler as tfh
from lcpc_proof_of_storage_tpu_torch.pos import online as ton
from lcpc_proof_of_storage_tpu_torch.pos import storage as ts

torch.set_num_threads(1)
CPU = "cpu"
N_PRE, N_ENC = 8, 32
SPECS = {"writeable_ft63": (jf.WRITEABLE_FT63, tf.WRITEABLE_FT63),
         "ft253_192": (jf.FT253_192, tf.FT253_192)}


def _data(n, seed):
    rnd = random.Random(seed)
    return bytes(rnd.randrange(256) for _ in range(n))


def _handlers(tmp_path, data, field="writeable_ft63"):
    jspec, tspec = SPECS[field]
    fh_t = tfh.FileHandler.create_from_bytes(data, N_PRE, N_ENC, tspec, base=tmp_path / "t",
                                             device=CPU)
    fh_j = jfh.FileHandler.create_from_bytes(data, N_PRE, N_ENC, jspec, base=tmp_path / "j")
    return fh_t, fh_j


@pytest.mark.parametrize("field", sorted(SPECS))
def test_encoded_row_and_its_replacement_match_reference(tmp_path, field):
    fh_t, fh_j = _handlers(tmp_path, _data(9000, 1), field)
    for r in (0, 5, fh_t.rows_written - 1):
        want = fh_j.get_encoded_row(r)
        np.testing.assert_array_equal(fh_t.get_encoded_row(r), want)
        np.testing.assert_array_equal(fh_t.reader.get_encoded_row(r), want)
    # another row's limbs written over row 3, as a host array and as a tensor
    row = fh_j.get_encoded_row(7)
    fh_j.reader.replace_encoded_row(3, row)
    fh_t.reader.replace_encoded_row(3, row)
    fh_t.reader.flush()
    fh_j.reader.flush()
    assert fh_t.paths["enc"].read_bytes() == fh_j.paths["enc"].read_bytes()
    fh_t.reader.replace_encoded_row(4, torch.from_numpy(row.astype(np.int32)))
    fh_t.reader.flush()
    np.testing.assert_array_equal(fh_t.get_encoded_row(4), row)


@pytest.mark.parametrize("field", sorted(SPECS))
def test_row_from_decoded_bytes_then_recalculated_tree(tmp_path, field):
    """A row replaced by its own bytes leaves the root; by new bytes, the
    recalculated tree equals the reference's and a fresh writer's over the
    edited raw bytes, and the handler stores and writes it."""
    tspec = SPECS[field][1]
    data = _data(20000, 2)
    fh_t, fh_j = _handlers(tmp_path, data, field)
    row_bytes = fh_t.row_data_bytes
    root = fh_t.get_commit_root()
    assert fh_t.edit_bytes(0, data[:1])[1].root() == root      # builds the chunk-CV cache
    fh_t.reader.replace_row_with_decoded_bytes(2, data[2 * row_bytes: 3 * row_bytes])
    fh_t.reader.flush()
    assert fh_t.recalculate_merkle_tree().root() == root

    r = 9
    new = _data(row_bytes, 3)
    for fh in (fh_t, fh_j):
        fh.reader.replace_row_with_decoded_bytes(r, new)
        fh.reader.flush()
    tree_t, tree_j = fh_t.recalculate_merkle_tree(), fh_j.recalculate_merkle_tree()
    assert tree_t.digests == tree_j.digests and tree_t.root() != root
    assert fh_t.paths["enc"].read_bytes() == fh_j.paths["enc"].read_bytes()
    edited = data[:r * row_bytes] + new + data[(r + 1) * row_bytes:]
    fresh = tmp_path / "edited.porraw"
    fresh.write_bytes(edited)
    _, want = ts.EncodedFileWriter.convert_unencoded_file(
        fresh, tmp_path / "fresh.porenc", None, None, N_PRE, N_ENC, tspec, device=CPU)
    assert tree_t.digests == want.digests
    assert fh_t.merkle_tree is tree_t
    assert fh_t.paths["tree"].read_bytes() == tree_t.to_bytes()

    # an edit after the recalculation starts from the file as it now is,
    # not from the chunk-CV cache built before the row was replaced
    at = (fh_t.rows_written - 2) * row_bytes + 3        # a chunk of the columns past row r's
    edited = edited[:at] + b"\x01\x02" + edited[at + 2:]
    fresh.write_bytes(edited)
    _, want = ts.EncodedFileWriter.convert_unencoded_file(
        fresh, tmp_path / "fresh.porenc", None, None, N_PRE, N_ENC, tspec, device=CPU)
    assert fh_t.edit_bytes(at, b"\x01\x02")[1].digests == want.digests

    # a short last row is zero-padded as the reference pads it
    last = fh_t.rows_written - 1
    for fh in (fh_t, fh_j):
        fh.reader.replace_row_with_decoded_bytes(last, b"\x07" * 5)
        fh.reader.flush()
    np.testing.assert_array_equal(fh_t.get_encoded_row(last), fh_j.get_encoded_row(last))
    with pytest.raises(ValueError):
        fh_t.reader.replace_row_with_decoded_bytes(0, bytes(row_bytes + 1))


def test_digests_and_retrieved_columns_match_reference(tmp_path):
    data = _data(12000, 4)
    fh_t, fh_j = _handlers(tmp_path, data)
    cols = [0, 3, 17, 31]
    assert fh_t.read_only_digests(cols) == fh_j.read_only_digests(cols)
    assert fh_t.read_only_digests() == fh_j.read_only_digests()
    assert fh_t.read_only_digests(cols) == [fh_t.merkle_tree[c] for c in cols]

    spec_j, spec_t = SPECS["writeable_ft63"]
    comm_t = ton.commit_file_data(data, N_PRE, N_ENC, spec_t, CPU)
    comm_j = jon.commit_file_data(data, N_PRE, N_ENC, spec_j)
    got = ton.server_retrieve_columns(comm_t, cols)
    want = jon.server_retrieve_columns(comm_j, cols)
    assert [(c.col, c.path) for c in got] == [(c.col, c.path) for c in want]
    got = ton.columns_with_path_for_file_data(data, N_PRE, N_ENC, cols, spec_t, CPU)
    want = jon.columns_with_path_for_file_data(data, N_PRE, N_ENC, cols, spec_j)
    assert [(c.col, c.path) for c in got] == [(c.col, c.path) for c in want]
    # the file's columns are the one-shot commit's
    assert [c.col for c in got] == [c.col for c in fh_t.read_full_columns(cols)]


@pytest.mark.parametrize("tamper", ["none", "digest", "path"])
def test_checks_without_full_columns(tmp_path, tamper):
    """Both packages accept honest digests and paths, and reject a flipped
    bit of one digest or of one path entry."""
    data = _data(12000, 5)
    spec_t = SPECS["writeable_ft63"][1]
    comm = ton.commit_file_data(data, N_PRE, N_ENC, spec_t, CPU)
    root = comm.get_root().root
    need = ton.get_pos_soundness_n_cols(N_PRE, N_ENC)
    requested = ton.get_column_indices_from_random_seed(1337, need, N_ENC)
    assert requested == jon.get_column_indices_from_random_seed(1337, need, N_ENC)
    local = ton.leaves_for_file_data(data, N_PRE, N_ENC, requested, spec_t, CPU)
    cols = ton.server_retrieve_columns(comm, requested)
    digests = [ton.hash_column_to_digest(c, spec_t) for c in cols]
    paths = [list(c.path) for c in cols]
    assert digests == local
    if tamper == "digest":
        digests[2] = bytes([digests[2][0] ^ 1]) + digests[2][1:]
    elif tamper == "path":
        paths[1][-1] = bytes([paths[1][-1][0] ^ 0x80]) + paths[1][-1][1:]
    checks = [(mod, lambda mod=mod: mod.verify_column_paths_without_full_columns(
                  root, requested, digests, paths)) for mod in (ton, jon)]
    checks += [(mod, lambda mod=mod: mod.client_verify_commitment_without_full_columns(
                   root, local, requested, digests, paths, need)) for mod in (ton, jon)]
    for mod, check in checks:
        if tamper == "none":
            check()
        else:
            with pytest.raises(mod.VerificationError):
                check()
    with pytest.raises(ton.VerificationError):
        ton.client_verify_commitment_without_full_columns(root, local, requested, digests,
                                                          paths, need - 1)
    with pytest.raises(ton.VerificationError):
        ton.verify_column_paths_without_full_columns(root, requested, digests, paths[:-1])


def test_vector_multiply_matches_reference():
    rnd = random.Random(6)
    for jspec, tspec in SPECS.values():
        p = tspec.modulus
        a = [rnd.randrange(p) for _ in range(300)]
        b = [rnd.randrange(p) for _ in range(300)]
        assert ton.vector_multiply(a, b, tspec) == jon.vector_multiply(a, b, jspec)
        assert ton.vector_multiply(a, b, tspec) == sum(x * y for x, y in zip(a, b)) % p


@pytest.mark.parametrize("n_rows", [1, 124, 300])
def test_accumulator_finalize_to_commit_and_width(n_rows):
    spec_j, spec_t = SPECS["writeable_ft63"]
    rng = np.random.default_rng(n_rows)
    rows = rng.integers(0, 1 << 16, size=(n_rows, N_ENC, 4)).astype(np.uint32)
    rows[..., 3] &= 0x3FFF
    acc_t = ts.ColumnDigestAccumulator(N_ENC, spec_t, device=CPU)
    acc_j = js.ColumnDigestAccumulator(N_ENC, spec_j)
    acc_t.update_batch(rows)
    acc_j.update_batch(rows)
    assert acc_t.get_width() == acc_j.get_width() == N_ENC
    assert ts.ColumnDigestAccumulator(N_ENC, spec_t, columns=[1, 4], device=CPU).get_width() == 2
    assert acc_t.finalize_to_commit() == acc_j.finalize_to_commit()


@pytest.mark.parametrize("field", sorted(SPECS))
def test_writer_finalize_to_column_digests(tmp_path, field):
    jspec, tspec = SPECS[field]
    data = _data(7000, 7)
    out = {}
    for name, mod, spec, kw in (("j", js, jspec, {}), ("t", ts, tspec, {"device": CPU})):
        w = mod.EncodedFileWriter(N_PRE, N_ENC, len(data), tmp_path / f"{name}.porenc", spec,
                                  **kw)
        w.push_bytes(data)
        meta, digests = w.finalize_to_column_digests()
        out[name] = (meta.rows_written, meta.row_capacity, meta.bytes_of_data, digests,
                     (tmp_path / f"{name}.porenc").read_bytes())
    assert out["t"] == out["j"]
    assert ts.MerkleTree.new(out["t"][3]).digests == tfh.FileHandler.create_from_bytes(
        data, N_PRE, N_ENC, tspec, base=tmp_path / "h", device=CPU).merkle_tree.digests
