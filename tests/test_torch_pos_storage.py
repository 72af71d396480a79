"""The port's proof-of-storage storage layer against the JAX package's.

Same bytes in, same bytes out, on the CPU (the plain versions of K1, K2,
K3p and K4's inverse):
- the ``.porenc``, ``.portree`` and ``.meta`` files of the writer, for
  writeable_ft63 and ft253_192 at dims (8, 32) and (64, 256), a file that
  ends mid-row and one that grows its capacity;
- reader rows, columns and decode, and the read paths of ``pos/readers.py``;
- edit and append fuzz: every tree equal to the reference handler's and to
  a fresh writer's over the same raw bytes;
- the column digest accumulator at chunk boundaries, the specified-column
  digests, the streamed client leaves, the row generator;
- the left-multiply and the evaluation vector;
- the ``pos_root`` and ``challenge_cols_seed1337`` pins;
- a quadruple written by either package served by the other's handler.

All comparisons are exact (integer fields and hashes).
"""

import dataclasses
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields import field as jf
from lcpc_proof_of_storage_tpu.pos import file_handler as jfh
from lcpc_proof_of_storage_tpu.pos import online as jon
from lcpc_proof_of_storage_tpu.pos import row_generator as jrg
from lcpc_proof_of_storage_tpu.pos import storage as js
from lcpc_proof_of_storage_tpu_torch.crypto.blake3_ref import blake3
from lcpc_proof_of_storage_tpu_torch.fields import field as tf
from lcpc_proof_of_storage_tpu_torch.pos import file_handler as tfh
from lcpc_proof_of_storage_tpu_torch.pos import online as ton
from lcpc_proof_of_storage_tpu_torch.pos import row_generator as trg
from lcpc_proof_of_storage_tpu_torch.pos import storage as ts

torch.set_num_threads(1)
CPU = "cpu"
GOLDEN = json.loads((Path(__file__).parent / "golden_vectors.json").read_text())
SPECS = {"writeable_ft63": (jf.WRITEABLE_FT63, tf.WRITEABLE_FT63),
         "ft253_192": (jf.FT253_192, tf.FT253_192)}


def _data(n, seed):
    rnd = random.Random(seed)
    return bytes(rnd.randrange(256) for _ in range(n))


def _files(d: Path, stem: str) -> dict:
    return {k: d / f"{stem}.{k}" for k in ("enc", "tree", "meta")}


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("dims,nbytes", [((8, 32), 4321), ((64, 256), 70001)],
                         ids=["8x32-mid-row", "64x256"])
def test_writer_files_equal_reference(tmp_path, field, dims, nbytes):
    jspec, tspec = SPECS[field]
    raw = tmp_path / "f.porraw"
    raw.write_bytes(_data(nbytes, nbytes))
    out = {}
    for name, mod, spec, kw in (("j", js, jspec, {}), ("t", ts, tspec, {"device": CPU})):
        f = _files(tmp_path, name)
        mod.EncodedFileWriter.convert_unencoded_file(raw, f["enc"], f["tree"], f["meta"],
                                                     *dims, spec, ulid="U", **kw)
        out[name] = {k: p.read_bytes() for k, p in f.items()}
    assert out["t"] == out["j"]


@pytest.mark.parametrize("field", sorted(SPECS))
def test_writer_capacity_growth_equals_reference(tmp_path, field):
    """A writer told a smaller file size grows its capacity (the column
    streams move on disk) as the reference's does."""
    jspec, tspec = SPECS[field]
    data = _data(9000, 3)
    got = {}
    for name, mod, spec, kw in (("j", js, jspec, {}), ("t", ts, tspec, {"device": CPU})):
        path = tmp_path / f"{name}.porenc"
        w = mod.EncodedFileWriter(8, 32, 500, path, spec, **kw)
        for i in range(0, len(data), 777):
            w.push_bytes(data[i:i + 777])
        meta, tree = w.finalize_to_merkle_tree()
        got[name] = (path.read_bytes(), tree.to_bytes(), dataclasses.asdict(meta))
    assert got["t"][2]["row_capacity"] > 2 * 2       # grew past the first guess
    assert got["t"] == got["j"]


def test_reader_rows_columns_and_decode(tmp_path):
    data = _data(40000, 5)
    fh_t = tfh.FileHandler.create_from_bytes(data, 8, 32, tf.WRITEABLE_FT63,
                                             base=tmp_path / "t", device=CPU)
    fh_j = jfh.FileHandler.create_from_bytes(data, 8, 32, jf.WRITEABLE_FT63,
                                             base=tmp_path / "j")
    rt, rj = fh_t.reader, fh_j.reader
    np.testing.assert_array_equal(rt.get_encoded_rows(100, 40), rj.get_encoded_rows(100, 40))
    np.testing.assert_array_equal(rt.encoded_rows_tensor(3, 5).numpy(),
                                  rj.get_encoded_rows(3, 5).astype(np.int32))
    for c in (0, 17, 31):
        np.testing.assert_array_equal(rt.get_encoded_column_without_path(c),
                                      rj.get_encoded_column_without_path(c))
    for r in (0, 300, fh_t.rows_written - 1):
        np.testing.assert_array_equal(rt.get_unencoded_row(r), rj.get_unencoded_row(r))
        assert fh_t.get_decoded_row_bytes(r) == fh_j.get_decoded_row_bytes(r)
    assert rt.decode_to_bytes() == rj.decode_to_bytes()
    assert rt.decode_to_bytes()[: len(data)] == data
    assert rt.process_file_to_merkle_tree().digests == fh_j.merkle_tree.digests


def _fresh_tree(raw: Path, d: Path) -> bytes:
    _, tree = ts.EncodedFileWriter.convert_unencoded_file(
        raw, d / "fresh.porenc", None, None, 8, 32, tf.WRITEABLE_FT63, device=CPU)
    return tree.to_bytes()


def test_edit_fuzz_matches_reference(tmp_path):
    """Random edits of a multi-chunk file (715 rows, six chunks a column):
    every incremental tree equals the reference handler's and a fresh
    writer's over the edited raw file."""
    rnd = random.Random(77)
    data = _data(40000, 77)
    fh_t = tfh.FileHandler.create_from_bytes(data, 8, 32, tf.WRITEABLE_FT63,
                                             base=tmp_path / "t", device=CPU)
    fh_j = jfh.FileHandler.create_from_bytes(data, 8, 32, jf.WRITEABLE_FT63,
                                             base=tmp_path / "j")
    for it in range(6):
        start = rnd.randrange(len(data) - 300)
        new = _data(rnd.randrange(1, 300), it)
        orig_t, tree_t = fh_t.edit_bytes(start, new)
        orig_j, tree_j = fh_j.edit_bytes(start, new)
        assert orig_t == orig_j
        assert tree_t.digests == tree_j.digests
        assert tree_t.to_bytes() == _fresh_tree(fh_t.paths["raw"], tmp_path)
    assert fh_t.paths["enc"].read_bytes() == fh_j.paths["enc"].read_bytes()
    fh_t.verify_all_files_agree()


def test_append_fuzz_matches_reference(tmp_path):
    """Appends across rows, chunks and capacity doublings."""
    rnd = random.Random(8)
    data = _data(500, 8)
    fh_t = tfh.FileHandler.create_from_bytes(data, 8, 32, tf.WRITEABLE_FT63,
                                             base=tmp_path / "t", ulid="A", device=CPU)
    fh_j = jfh.FileHandler.create_from_bytes(data, 8, 32, jf.WRITEABLE_FT63,
                                             base=tmp_path / "j", ulid="A")
    for i in range(5):
        add = _data(rnd.randrange(1, 3000), 100 + i)
        assert fh_t.append_bytes(add).digests == fh_j.append_bytes(add).digests
        assert (dataclasses.asdict(fh_t.get_encoded_metadata())
                == dataclasses.asdict(fh_j.get_encoded_metadata()))
        assert fh_t.merkle_tree.to_bytes() == _fresh_tree(fh_t.paths["raw"], tmp_path)
    assert fh_t.reader.decode_to_bytes() == fh_j.reader.decode_to_bytes()
    assert fh_t.paths["meta"].read_bytes() == fh_j.paths["meta"].read_bytes()
    fh_t.verify_all_files_agree()


@pytest.mark.parametrize("n_rows", [0, 1, 123, 124, 125, 252, 253, 700])
def test_accumulator_at_chunk_boundaries(n_rows):
    """One row at a time, then in uneven batches: the digests equal one-shot
    Blake3 of every column stream (124 rows of ft63 fill the first chunk
    exactly)."""
    spec = tf.WRITEABLE_FT63
    rng = np.random.default_rng(n_rows)
    rows = rng.integers(0, 1 << 16, size=(n_rows, 4, 4)).astype(np.int32)
    rows[..., 3] &= 0x3FFF
    want = [blake3(b"\x00" * 32 + ts.limbs_to_repr_bytes_np(rows[:, c], spec).tobytes())
            for c in range(4)]
    one = ts.ColumnDigestAccumulator(4, spec, device=CPU)
    for r in range(n_rows):
        one.update(rows[r])
    assert one.get_column_digests() == want
    uneven = ts.ColumnDigestAccumulator(4, spec, columns=[3, 1], device=CPU)
    for s in range(0, n_rows, 97):
        uneven.update_batch(torch.from_numpy(rows[s:s + 97]))
    assert uneven.get_column_digests() == [want[3], want[1]]


def test_specified_column_digests_and_client_leaves(tmp_path):
    data = _data(30000, 1)
    path = tmp_path / "f.bin"
    path.write_bytes(data)
    cols = [3, 17, 30]
    want = jon.leaves_for_file_data(data, 8, 32, cols, jf.WRITEABLE_FT63)
    assert ton.leaves_for_file_data(data, 8, 32, cols, tf.WRITEABLE_FT63, CPU) == want
    assert ton.streaming_leaves_for_file(path, 8, 32, cols, tf.WRITEABLE_FT63, CPU) == want
    vals = [random.Random(2).randrange(tf.WRITEABLE_FT63.modulus) for _ in range(2000)]
    assert (trg.RowGenerator(vals, 8, 32, tf.WRITEABLE_FT63, CPU)
            .get_specified_column_digests(cols)
            == jrg.RowGenerator(vals, 8, 32, jf.WRITEABLE_FT63).get_specified_column_digests(cols))
    got = trg.RowGenerator(vals, 8, 32, tf.WRITEABLE_FT63, CPU).get_full_columns(cols)
    ref = jrg.RowGenerator(vals, 8, 32, jf.WRITEABLE_FT63).get_full_columns(cols)
    assert [(c.col, c.path) for c in got] == [(c.col, c.path) for c in ref]


def test_row_generator_root_builds_the_tree_from_the_digest_tensor(monkeypatch):
    """convert_to_commit_root equals the reference's, and its Merkle layers
    are built from the accumulator's digest tensor (on the generator's
    device), never from a list of digest bytes."""
    vals = [random.Random(4).randrange(tf.WRITEABLE_FT63.modulus) for _ in range(8 * 700)]
    want = jrg.RowGenerator(vals, 8, 32, jf.WRITEABLE_FT63).convert_to_commit_root()
    new = ts.MerkleTree.new.__func__

    def tensor_only(cls, leaves):
        assert isinstance(leaves, torch.Tensor)
        return new(cls, leaves)

    monkeypatch.setattr(ts.MerkleTree, "new", classmethod(tensor_only))
    assert trg.RowGenerator(vals, 8, 32, tf.WRITEABLE_FT63, CPU).convert_to_commit_root() == want


def test_clone_hands_over_the_chunk_cv_cache(tmp_path, monkeypatch):
    """A clone takes a copy of its source's chunk CVs: neither the clone nor
    its edits and appends rebuild the cache from the file, every tree
    equals a fresh writer's, and the source's CVs stay as they were."""
    data = _data(40000, 9)
    fh = tfh.FileHandler.create_from_bytes(data, 8, 32, tf.WRITEABLE_FT63, base=tmp_path,
                                           device=CPU)
    fh.edit_bytes(1000, b"built")
    src_cvs = fh._cv_cache.cvs.clone()
    fresh = ts.ColumnCVCache(fh.paths["enc"], tf.WRITEABLE_FT63, 32, fh.row_capacity,
                             fh.rows_written, CPU)

    def no_rebuild(*a, **k):
        raise AssertionError("the chunk-CV cache was rebuilt from the file")

    monkeypatch.setattr(ts.ColumnCVCache, "__init__", no_rebuild)
    clone = fh.clone_to_new_ulid()
    assert clone._cv_cache.path == clone.paths["enc"]
    assert torch.equal(clone._cv_cache.cvs, fresh.cvs)
    _, tree = clone.edit_bytes(30000, b"edited in the clone")
    assert tree.to_bytes() == _fresh_tree(clone.paths["raw"], tmp_path)
    clone2 = clone.clone_to_new_ulid()
    tree = clone2.append_bytes(_data(5000, 10))
    assert tree.to_bytes() == _fresh_tree(clone2.paths["raw"], tmp_path)
    assert torch.equal(fh._cv_cache.cvs, src_cvs)
    assert fh.merkle_tree.to_bytes() == _fresh_tree(fh.paths["raw"], tmp_path)


def test_left_multiply_and_evaluation_vector_match_reference(tmp_path):
    """Several left-multiply batches (the batch size is cut to 10 rows)."""
    data = _data(13210, 41)
    fh_t = tfh.FileHandler.create_from_bytes(data, 8, 32, tf.WRITEABLE_FT63,
                                             base=tmp_path / "t", device=CPU)
    fh_j = jfh.FileHandler.create_from_bytes(data, 8, 32, jf.WRITEABLE_FT63,
                                             base=tmp_path / "j")
    rnd = random.Random(42)
    left = [rnd.randrange(tf.WRITEABLE_FT63.modulus) for _ in range(fh_t.rows_written)]
    want = fh_j.left_multiply_unencoded_matrix_by_vector(left)
    old = tfh.LEFT_MULTIPLY_BYTES
    tfh.LEFT_MULTIPLY_BYTES = 10 * fh_t.row_data_bytes
    try:
        assert fh_t.left_multiply_unencoded_matrix_by_vector(left) == want
    finally:
        tfh.LEFT_MULTIPLY_BYTES = old
    v = fh_t.verifiable_polynomial_evaluation(left)
    assert v == fh_j.verifiable_polynomial_evaluation(left)
    comm = ton.commit_file_data(data, 8, 32, tf.WRITEABLE_FT63, CPU)
    assert ton.verifiable_polynomial_evaluation(comm, left, tf.WRITEABLE_FT63) == v
    assert ton.decode_row(v, tf.WRITEABLE_FT63, CPU) == jon.decode_row(v, jf.WRITEABLE_FT63)


def test_golden_pos_pins():
    data = bytes((i * 7 + 3) % 256 for i in range(1000))
    comm = ton.commit_file_data(data, 8, 32, tf.WRITEABLE_FT63, CPU)
    assert comm.get_root().root.hex() == GOLDEN["pos_root"]
    assert ton.get_column_indices_from_random_seed(1337, 6, 32) == \
        GOLDEN["challenge_cols_seed1337"]
    raw_tree = ts.MerkleTree.new(ton.leaves_for_file_data(data, 8, 32, list(range(32)),
                                                          tf.WRITEABLE_FT63, CPU))
    assert raw_tree.root().hex() == GOLDEN["pos_root"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quadruple_served_by_the_other_package(tmp_path, writer):
    """A quadruple written by one package is attached and served by the
    other's FileHandler: the same columns and paths, the same evaluation,
    the same tree after an edit."""
    data = _data(20000, 9)
    mk_t = lambda: tfh.FileHandler.create_from_bytes(data, 8, 32, tf.WRITEABLE_FT63,  # noqa: E731
                                                     base=tmp_path, device=CPU)
    mk_j = lambda: jfh.FileHandler.create_from_bytes(data, 8, 32, jf.WRITEABLE_FT63,  # noqa: E731
                                                     base=tmp_path)
    first = mk_j() if writer == "jax" else mk_t()
    ulid = first.ulid
    first.reader.close()
    other = (tfh.FileHandler.attach(ulid, tf.WRITEABLE_FT63, base=tmp_path, device=CPU)
             if writer == "jax" else jfh.FileHandler.attach(ulid, jf.WRITEABLE_FT63,
                                                            base=tmp_path))
    assert other.get_commit_root() == first.get_commit_root()
    cols = jon.get_column_indices_from_random_seed(1337, 9, 32)
    columns = other.read_full_columns(cols)
    jon.verify_column_paths(first.get_commit_root(), cols, columns, jf.WRITEABLE_FT63)
    ton.verify_column_paths(first.get_commit_root(), cols, columns, tf.WRITEABLE_FT63)
    left = [(i * 31337 + 5) % tf.WRITEABLE_FT63.modulus for i in range(other.rows_written)]
    assert (other.verifiable_polynomial_evaluation(left)
            == jon.verifiable_polynomial_evaluation(
                jon.commit_file_data(data, 8, 32, jf.WRITEABLE_FT63), left))
    _, tree = other.edit_bytes(1234, b"edited by the other package")
    edited = bytearray(data)
    edited[1234:1234 + 27] = b"edited by the other package"
    fresh = jfh.FileHandler.create_from_bytes(bytes(edited), 8, 32, jf.WRITEABLE_FT63,
                                              base=tmp_path / "fresh")
    assert tree.digests == fresh.merkle_tree.digests
    other.verify_all_files_agree()


@pytest.mark.parametrize("field", sorted(SPECS))
def test_size_formulas_match_reference(field):
    jspec, tspec = SPECS[field]
    for size, n_pre, n_enc in ((0, 8, 32), (1, 8, 32), (4321, 8, 32), (70001, 64, 256),
                               (1 << 30, 16384, 32768)):
        assert (ts.get_encoded_file_size_from_rate(size, n_pre, n_enc, tspec)
                == js.get_encoded_file_size_from_rate(size, n_pre, n_enc, jspec))
        assert (ts.get_decoded_file_size_from_rate(size, n_pre, n_enc, tspec)
                == js.get_decoded_file_size_from_rate(size, n_pre, n_enc, jspec))


@pytest.mark.parametrize("field", ["writeable_ft63", "ft255", "ft253_192"])
@pytest.mark.parametrize("size", [0, 37, 12_345])
def test_readers_match_reference(tmp_path, field, size):
    """The port's read paths (whole, sync and async streams, by path) and
    the write-back give the reference's elements and bytes."""
    import asyncio

    from lcpc_proof_of_storage_tpu.pos import readers as jr
    from lcpc_proof_of_storage_tpu_torch.pos import readers as tr
    jspec, tspec = jf.FIELDS[field], tf.FIELDS[field]
    p = tmp_path / "f.bin"
    p.write_bytes(_data(size, size))
    want = jr.read_file_path_to_field_elements(p, jspec)
    with open(p, "rb") as f:
        n, whole = tr.read_file_to_field_elements(f, tspec)
    with open(p, "rb") as f:
        _, sync = tr.stream_file_to_field_elements_sync(f, tspec, buf_mult=7)
    _, asyn = asyncio.run(tr.stream_file_to_field_elements_async(p, tspec, buf_mult=5))
    assert n == size
    for got in (whole, sync, asyn, tr.read_file_path_to_field_elements(p, tspec)):
        np.testing.assert_array_equal(got, want)
    tr.field_elements_to_file(tmp_path / "t.bin", want, tspec)
    jr.field_elements_to_file(tmp_path / "j.bin", want, jspec)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_reshape_attach_and_merkle_bytes(tmp_path):
    data = _data(2000, 10)
    fh = tfh.FileHandler.create_from_bytes(data, 8, 32, tf.WRITEABLE_FT63, base=tmp_path,
                                           device=CPU)
    root_before = fh.get_commit_root()
    meta, tree = fh.reshape(16, 64)
    assert fh.get_commit_root() != root_before
    assert fh.reader.decode_to_bytes()[: len(data)] == data
    assert tree.digests == jfh.FileHandler.create_from_bytes(
        data, 16, 64, jf.WRITEABLE_FT63, base=tmp_path / "j").merkle_tree.digests
    fh.verify_all_files_agree()
    fh2 = tfh.FileHandler.attach(fh.ulid, tf.WRITEABLE_FT63, base=tmp_path, device=CPU)
    assert fh2.get_commit_root() == fh.get_commit_root()
    assert fh2.get_dimensions() == fh.get_dimensions()
    assert ts.MerkleTree.from_bytes(tree.to_bytes()) == tree
    assert tree.get_path(5) == js.MerkleTree.from_bytes(tree.to_bytes()).get_path(5)
    fh2.reader.close()
    fh.delete_all_files()
