"""K2's leaves and tree kernels, step by step, without a card:

- ``hash_columns_chunked_plain`` (the leaves kernel's plan, its block-wise
  reads of the limb matrix, every slot's CV and the merge at strides inside
  a block) against ``hash_columns_plain``, the byte-level Blake3 and the JAX
  package's ``ops/blake3_jax.py hash_columns``, on five fields and messages
  of 1, 2, 5 and more chunks than a block has threads, a 32-byte tail chunk
  among them;
- ``merkle_tree_tiles_plain`` (the tree kernel's launches and subtrees)
  against ``merkle_tree_plain`` and the JAX package's ``core/commit.py
  merkle_tree_device``, at widths 2 to 2^16;
- ``csrc/blake3.cuh`` compiled with the host C++ compiler: the leaves
  computed slot by slot and merged as the kernel merges them, the Merkle
  array from its layer offsets, and the plans against their Python mirrors.
Exact.
"""

import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.core import commit as jcommit
from lcpc_proof_of_storage_tpu.fields import field as jfield
from lcpc_proof_of_storage_tpu.ops import blake3_jax
from lcpc_proof_of_storage_tpu_torch.core.commit import merkle_tree_device
from lcpc_proof_of_storage_tpu_torch.crypto.blake3_ref import blake3
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
from lcpc_proof_of_storage_tpu_torch.ops import blake3 as b3

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / "lcpc_proof_of_storage_tpu_torch" / "csrc"
CPU = torch.device("cpu")


def _limbs(rng, shape, spec):
    L = spec.num_limbs16
    x = rng.integers(0, 1 << 16, size=(*shape, L), dtype=np.int64)
    x[..., L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=shape)
    return torch.from_numpy(x.astype(np.int32))


def _digests(rng, n):
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(n, 8)).astype(np.int32))


# (field, rows, cols, threads): chunks a message and the plan's path
LEAF_CASES = [
    (FT63, 1, 300, b3.LEAF_THREADS),        # 1 chunk, one block of 256 columns and a part
    (FT255, 31, 5, b3.LEAF_THREADS),        # exactly 1024 bytes: 1 chunk, ROOT on block 16
    (FT253_192, 33, 4, b3.LEAF_THREADS),    # big-endian reprs, 2 chunks
    (FT127, 70, 3, b3.LEAF_THREADS),        # 2 chunks
    (FT191, 50, 66, b3.LEAF_THREADS),       # 2 chunks, blocks start inside an element
    (FT255, 128, 40, b3.LEAF_THREADS),      # the Ligero commit's 5 chunks, a 32-byte tail
    (FT63, 128, 7, b3.LEAF_THREADS),        # 1056 bytes: 2 chunks, a 32-byte tail
    (FT191, 300, 3, 2),                     # 8 chunks in groups of 4
    (FT255, 300, 5, 4),                     # 10 chunks: groups of 4, a short last group
    (FT253_192, 300, 5, 2),                 # big-endian, groups of 8
]


@pytest.mark.parametrize("spec,rows,cols,threads", LEAF_CASES,
                         ids=[f"{c[0].name}-{c[1]}x{c[2]}-t{c[3]}" for c in LEAF_CASES])
def test_chunked_leaves_match_plain(spec, rows, cols, threads):
    m = _limbs(np.random.default_rng(rows * cols), (rows, cols), spec)
    want = b3.hash_columns_plain(m, spec)
    assert torch.equal(b3.hash_columns_chunked_plain(m, spec, threads), want)
    plan = b3.leaf_plan(rows, spec.repr_bytes, threads)
    assert plan.slots * plan.cols <= threads and plan.group * plan.slots >= plan.nchunks


@pytest.mark.parametrize("spec,rows,cols,threads", [LEAF_CASES[5], (FT253_192, 70, 3, 2)],
                         ids=["ft255-5chunks", "ft253_192-grouped"])
def test_chunked_leaves_match_the_jax_package(spec, rows, cols, threads):
    m = _limbs(np.random.default_rng(rows * cols), (rows, cols), spec)
    jspec = getattr(jfield, spec.name.upper())
    want = np.asarray(blake3_jax.hash_columns(jnp.asarray(m.numpy().astype(np.uint32)),
                                                jspec)).view(np.int32)
    np.testing.assert_array_equal(b3.hash_columns_chunked_plain(m, spec, threads).numpy(), want)


def test_leaves_past_a_block_of_chunks():
    """258 chunks a message: more than a block's 256 threads, so each
    thread hashes an aligned pair of chunks; against the byte-level hash."""
    spec, rows = FT63, 33000
    plan = b3.leaf_plan(rows, spec.repr_bytes)
    assert (plan.nchunks, plan.group, plan.slots, plan.cols) == (258, 2, 129, 1)
    m = _limbs(np.random.default_rng(9), (rows, 2), spec)
    got = b3.digests_to_bytes(b3.hash_columns_chunked_plain(m, spec))
    assert got == b3.digests_to_bytes(b3.hash_columns_plain(m, spec))
    col = m[:, 1].to(torch.int64).numpy()
    reprs = b"".join(int(sum(int(v) << (16 * i) for i, v in enumerate(e))).to_bytes(8, "little")
                     for e in col)
    assert got[1] == blake3(b"\0" * 32 + reprs)


def test_hash_columns_and_merge_cvs_write_into_the_merkle_array():
    rng = np.random.default_rng(3)
    m = _limbs(rng, (40, 5), FT255)
    hashes = b3.merkle_array(5, CPU)
    assert b3.hash_columns(m, FT255, out=hashes[:5]).data_ptr() == hashes.data_ptr()
    assert torch.equal(hashes[:5], b3.hash_columns_plain(m, FT255))
    assert not hashes[5:8].any()
    cvs = _digests(rng, 15).reshape(5, 3, 8)
    b3.merge_cvs(cvs, out=hashes[:5])
    assert torch.equal(hashes[:5], b3.merge_cvs_plain(cvs))
    with pytest.raises(ValueError):
        b3.hash_columns(m, FT255, out=hashes[:4])


TREE_WIDTHS = [2, 3, 4, 5, 9, 1023, 1024, 1025, 2049, 1 << 15, (1 << 15) + 1, 1 << 16]


@pytest.mark.parametrize("n_cols", TREE_WIDTHS)
def test_tree_tiles_match_the_layer_loop(n_cols):
    rng = np.random.default_rng(n_cols)
    hashes = b3.merkle_array(n_cols, CPU)
    hashes[:n_cols] = _digests(rng, n_cols)
    want = b3.merkle_tree_plain(hashes.clone())
    np2 = (hashes.shape[0] + 1) // 2
    assert len(b3.tree_plan(np2)) <= 2
    assert torch.equal(b3.merkle_tree_tiles_plain(hashes.clone()), want)
    # more launches than the kernel makes at these widths: 3 levels a launch
    assert torch.equal(b3.merkle_tree_tiles_plain(hashes.clone(), levels=3), want)
    assert torch.equal(b3.merkle_tree(hashes), want)


@pytest.mark.parametrize("n_cols", [3, 9])
def test_tree_matches_the_jax_package(n_cols):
    """merkle_tree_device (the leaves written into the array, the layers by
    merkle_tree) against the JAX package's, on n_cols just above a power of
    two."""
    rng = np.random.default_rng(n_cols)
    leaves = _digests(rng, n_cols)
    want = np.asarray(jcommit.merkle_tree_device(jnp.asarray(leaves.numpy().view(np.uint32)),
                                                 n_cols)).view(np.int32)
    got = merkle_tree_device(n_cols, CPU, lambda out: out.copy_(leaves))
    np.testing.assert_array_equal(got.numpy(), want)
    tiles = b3.merkle_array(n_cols, CPU)
    tiles[:n_cols] = leaves
    np.testing.assert_array_equal(b3.merkle_tree_tiles_plain(tiles, levels=1).numpy(), want)


def test_tree_plan():
    assert b3.tree_plan(1) == []
    assert b3.tree_plan(2) == [(0, 1)]
    assert b3.tree_plan(1 << 10) == [(0, 10)]
    assert b3.tree_plan(1 << 15) == [(0, 10), (10, 5)]
    assert b3.tree_plan(1 << 20) == [(0, 10), (10, 10)]
    assert [b3.tree_layer_row(8, k) for k in range(4)] == [0, 8, 12, 14]


# --------------------------------------------------------------------------
# csrc/blake3.cuh with the host compiler
# --------------------------------------------------------------------------

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "blake3.cuh"
using namespace b3;
// argv: mode W big_endian
//   plan:   stdin "n_rows" lines; prints msg_len nchunks group slots cols
//   leaves: stdin n_rows n_cols, then the limbs; prints each column's leaf
//           words, its slots' CVs merged at strides as the kernel merges them
//   tree:   stdin np2 and the np2 leaves' words; prints the Merkle array
template <int W, bool GROUPED>
void leaves(const std::vector<int32_t>& m, int64_t n_rows, int64_t n_cols, bool be,
            const LeafPlan& p) {
    std::vector<uint32_t> node((size_t)p.slots * 8);
    for (int64_t c = 0; c < n_cols; ++c) {
        for (int slot = 0; slot < p.slots; ++slot)
            leaf_slot_cv<W, GROUPED>(&node[slot * 8], m.data(), n_rows, n_cols, c, be, p, slot);
        for (int s = 1; s < p.slots; s *= 2)
            for (int slot = 0; slot < p.slots; ++slot)
                if (merges_at(slot, s, p.slots))
                    parent_cv(&node[slot * 8], &node[slot * 8], &node[(slot + s) * 8],
                              merge_flags(s, p.slots));
        for (int i = 0; i < 8; ++i) printf("%u ", node[i]);
        printf("\n");
    }
}
template <int W> int run(const char* mode, bool be) {
    if (!strcmp(mode, "plan")) {
        long long n;
        while (scanf("%lld", &n) == 1) {
            LeafPlan p = leaf_plan(n, W);
            printf("%lld %lld %lld %d %d\n", (long long)p.msg_len, (long long)p.nchunks,
                   (long long)p.group, p.slots, p.cols);
        }
        return 0;
    }
    if (!strcmp(mode, "tree")) {
        long long np2;
        if (scanf("%lld", &np2) != 1) return 1;
        std::vector<uint32_t> a((size_t)(2 * np2 - 1) * 8);
        for (long long i = 0; i < np2 * 8; ++i) if (scanf("%u", &a[i]) != 1) return 1;
        for (int k = 0; (np2 >> (k + 1)) >= 1; ++k)
            for (long long j = 0; j < (np2 >> (k + 1)); ++j) {
                uint32_t h[8];
                const uint32_t* lr = &a[(tree_layer_row(np2, k) + 2 * j) * 8];
                parent_cv(h, lr, lr + 8, CHUNK_START | CHUNK_END | ROOT);
                memcpy(&a[(tree_layer_row(np2, k + 1) + j) * 8], h, 32);
            }
        for (size_t i = 0; i < a.size(); ++i) printf("%u%s", a[i], i % 8 == 7 ? "\n" : " ");
        return 0;
    }
    long long n_rows, n_cols;
    if (scanf("%lld %lld", &n_rows, &n_cols) != 2) return 1;
    std::vector<int32_t> m((size_t)(n_rows * n_cols * 2 * W));
    for (auto& v : m) if (scanf("%d", &v) != 1) return 1;
    LeafPlan p = leaf_plan(n_rows, W);
    if (p.group > 1) leaves<W, true>(m, n_rows, n_cols, be, p);
    else leaves<W, false>(m, n_rows, n_cols, be, p);
    return 0;
}
int main(int argc, char** argv) {
    bool be = argv[3][0] == '1';
    switch (argv[2][0] - '0') {
        case 2: return run<2>(argv[1], be);
        case 4: return run<4>(argv[1], be);
        case 6: return run<6>(argv[1], be);
        case 8: return run<8>(argv[1], be);
    }
    return 1;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("blake3")
    (d / "harness.cc").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", f"-I{CSRC}", str(d / "harness.cc"),
                    "-o", str(d / "harness")], check=True)
    return d / "harness"


def _run(harness, mode: str, spec, body: str) -> np.ndarray:
    out = subprocess.run([str(harness), mode, str(spec.num_limbs16 // 2),
                          str(int(spec.endianness == "big"))], input=body, capture_output=True,
                         text=True, check=True).stdout
    return np.array([line.split() for line in out.splitlines()], dtype=np.int64)


@pytest.mark.parametrize("spec,rows,cols", [
    (FT63, 1, 3), (FT63, 300, 4), (FT127, 70, 3), (FT191, 50, 3), (FT191, 300, 2),
    (FT255, 31, 2), (FT255, 128, 5), (FT253_192, 33, 4), (FT253_192, 143, 3),
    (FT63, 33000, 1)], ids=lambda v: getattr(v, "name", str(v)))
def test_header_leaves_match_plain(harness, spec, rows, cols):
    m = _limbs(np.random.default_rng(rows + cols), (rows, cols), spec)
    body = f"{rows} {cols}\n" + " ".join(map(str, m.reshape(-1).tolist()))
    got = _run(harness, "leaves", spec, body).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, b3.hash_columns_plain(m, spec).numpy())


def test_header_tree_matches_plain(harness):
    rng = np.random.default_rng(12)
    hashes = b3.merkle_array(1 << 9, CPU)
    hashes[:1 << 9] = _digests(rng, 1 << 9)
    body = f"{1 << 9}\n" + " ".join(map(str, hashes[:1 << 9].numpy().view(np.uint32)
                                        .reshape(-1).tolist()))
    got = _run(harness, "tree", FT63, body).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, b3.merkle_tree_plain(hashes).numpy())


@pytest.mark.parametrize("spec", [FT63, FT127, FT191, FT255], ids=lambda s: s.name)
def test_header_leaf_plan_matches_python(harness, spec):
    rows = [0, 1, 31, 32, 33, 128, 143, 585, 2048, 9363, 32767, 32768, 33000, 1 << 20]
    got = _run(harness, "plan", spec, "\n".join(map(str, rows)))
    assert [tuple(r) for r in got.tolist()] == [tuple(b3.leaf_plan(n, spec.repr_bytes))
                                                for n in rows]
