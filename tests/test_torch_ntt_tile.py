"""What the redesigned KT and KM (``csrc/ntt_tile.cu``) compute on the host
side, checked without a card:

- KM's two forms of a * b mod p (``csrc/montgomery.cuh``: the broadcast
  row's one product, mont_mul(a, mont_mul(b, R^2 mod p)), and mul_normal's
  two), compiled with the host C++ compiler (the PTX carry flag emulated),
  against Python integers and against ``mul_mod_plain`` on the five fields,
  with edge values;
- KT's block plan (``ops/ntt.py tile_plan``, which the wrapper hands to the
  kernel as its log_span): every block holds whole runs, the blocks cover
  every value once, the plan keeps enough blocks for the card, and running
  the blocks one by one through ``ntt_tile_stages_plain`` gives the
  one-call result.

All comparisons are exact.  Inputs are drawn from fixed seeds.
"""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
from lcpc_proof_of_storage_tpu_torch.ops import ntt

CSRC = Path(__file__).resolve().parents[1] / "lcpc_proof_of_storage_tpu_torch" / "csrc"
FIELDS = [FT63, FT127, FT191, FT255, FT253_192]

HARNESS = r"""
#include <cstdio>
#include "montgomery.cuh"
// stdin: p's and r2's W words, then pairs of W-word values a, b;
// stdout: mont_mul(a, mont_mul(b, r2)) (KM's broadcast form), mul_normal(a, b)
template <int W> int run() {
    uint32_t p[W], r2[W], a[W], b[W], bm[W], r[W];
    for (int i = 0; i < W; ++i) if (scanf("%u", &p[i]) != 1) return 1;
    for (int i = 0; i < W; ++i) if (scanf("%u", &r2[i]) != 1) return 1;
    const Mod<W> m = make_mod<W>(p);
    for (;;) {
        for (int i = 0; i < W; ++i) if (scanf("%u", &a[i]) != 1) return 0;
        for (int i = 0; i < W; ++i) if (scanf("%u", &b[i]) != 1) return 1;
        mont_mul<W>(bm, b, r2, m);
        mont_mul<W>(r, a, bm, m);
        for (int i = 0; i < W; ++i) printf("%u ", r[i]);
        mul_normal<W>(r, a, b, r2, m);
        for (int i = 0; i < W; ++i) printf("%u ", r[i]);
        printf("\n");
    }
}
int main(int argc, char** argv) {
    switch (argv[1][0] - '0') {
        case 2: return run<2>();
        case 4: return run<4>();
        case 6: return run<6>();
        case 8: return run<8>();
    }
    return 1;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("km")
    (d / "harness.cc").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", f"-I{CSRC}", str(d / "harness.cc"),
                    "-o", str(d / "harness")], check=True)
    return d / "harness"


def _words(v: int, W: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(W)]


def _limbs(vals: list[int], L: int) -> torch.Tensor:
    return torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(L)] for v in vals],
                        dtype=torch.int32)


@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
def test_km_product_forms_match_integers_and_plain(harness, spec):
    p, W, L = spec.modulus, spec.num_limbs16 // 2, spec.num_limbs16
    R = 1 << (32 * W)
    edge = [0, 1, 2, p - 1, p - 2, p // 2, (p + 1) // 2, R // 2 % p, (1 << 32) % p, (R - 1) % p,
            R % p, R * R % p, pow(R, -1, p)]
    edge += [(p - (1 << (32 * i))) % p for i in range(W)]
    edge += [((1 << (32 * i)) - 1) % p for i in range(1, W)]
    rng = random.Random(100 + L)
    pairs = [(a, b) for a in edge for b in edge]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(1000)]
    _, r2 = ntt._mul_mod_consts(spec)
    stdin = (" ".join(map(str, _words(p, W))) + "\n" + " ".join(map(str, r2.tolist())) + "\n"
             + "\n".join(" ".join(map(str, _words(a, W) + _words(b, W))) for a, b in pairs))
    out = subprocess.run([str(harness), str(W)], input=stdin, capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert len(out) == len(pairs)
    got = [[sum(x << (32 * i) for i, x in enumerate(v[k * W:(k + 1) * W])) for k in range(2)]
           for v in (list(map(int, line.split())) for line in out)]
    for (a, b), (broadcast, rows) in zip(pairs, got):
        assert broadcast == rows == a * b % p, (hex(a), hex(b))
    # the same products through mul_mod_plain, row by row and by one broadcast row
    a_limbs = _limbs([a for a, _ in pairs], L)
    plain = ntt.mul_mod_plain(a_limbs, _limbs([b for _, b in pairs], L), spec)
    assert torch.equal(plain, _limbs([g[1] for g in got], L))
    b0 = edge[3]
    cut = len(edge) ** 2
    plain = ntt.mul_mod_plain(a_limbs[:cut], _limbs([b0], L), spec)
    want = [g[0] for (a, b), g in zip(pairs[:cut], got) if b == b0]
    assert torch.equal(plain[[i for i, (_, b) in enumerate(pairs[:cut]) if b == b0]],
                       _limbs(want, L))


def _block_counts(W: int, s1: int) -> list[int]:
    """Counts of whole runs: one run, fewer blocks than the plan's minimum,
    the minimum exactly, and more with a last block only partly full."""
    lb = max(s1, 10 if W <= 4 else 11)
    return sorted({1 << s1, 5 << s1, ntt.TILE_MIN_BLOCKS << lb,
                   (ntt.TILE_MIN_BLOCKS << lb) + (3 << s1)})


@pytest.mark.parametrize("W", [2, 4, 6, 8])
@pytest.mark.parametrize("s1", [1, 7, 9, 10, 11, 12])
def test_tile_plan_holds_whole_runs_and_enough_blocks(W, s1):
    lb = max(s1, 10 if W <= 4 else 11)
    for count in _block_counts(W, s1):
        log_span = ntt.tile_plan(count, s1, W)
        span = 1 << log_span
        blocks = -(-count // span)
        assert s1 <= log_span <= lb                   # whole runs, at most K1's block
        starts = [b * span for b in range(blocks)]
        ends = [min(s + span, count) for s in starts]
        assert starts[0] == 0 and ends[-1] == count   # every value once, in order
        assert all(e == s for e, s in zip(ends, starts[1:]))
        assert all((e - s) % (1 << s1) == 0 for s, e in zip(starts, ends))
        if log_span > s1:                             # halving stops at the minimum
            assert blocks >= ntt.TILE_MIN_BLOCKS
        if log_span < lb:                             # and not before it
            assert -(-count // (span * 2)) < ntt.TILE_MIN_BLOCKS


@pytest.mark.parametrize("spec,s0,s1,diag,inverse", [
    (FT63, 0, 1, False, False), (FT255, 0, 1, False, False),
    (FT63, 2, 7, True, False), (FT191, 2, 7, True, False),
    (FT191, 0, 9, False, True), (FT255, 0, 9, False, True),
    (FT63, 3, 11, True, True)], ids=lambda v: getattr(v, "name", str(v)))
def test_tile_blocks_one_by_one_give_the_one_call_result(spec, s0, s1, diag, inverse):
    """Each block of the plan runs stages s0 .. s1-1 on its own runs: the
    blocks' results, one plain call each, put together, are the one-call
    result (and the diagonal twiddle, by position in a row of n, goes with
    the values).  An odd count of runs (of rows, with the twiddle) leaves
    the last block of two partly full."""
    W = spec.num_limbs16 // 2
    tables = ntt.NttTables(spec, 1 << 11, "four_step")
    count = 3 << max(s1, 11) if diag else 5 << s1
    rng = np.random.default_rng(s1 * 10 + spec.num_limbs16)
    L = spec.num_limbs16
    x = rng.integers(0, 1 << 16, size=(count, L), dtype=np.int64)
    x[:, L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=count)
    x = torch.from_numpy(x.astype(np.int32))
    want = ntt.ntt_tile_stages_plain(x, tables, s0, s1, diag, inverse)
    # the plan's own blocks (one run each at so small a count), and blocks of
    # two runs (of whole rows of n with the diagonal twiddle)
    spans = {1 << ntt.tile_plan(count, s1, W), max(2 << s1, tables.n if diag else 0)}
    for span in sorted(s for s in spans if not diag or s % tables.n == 0):
        pieces = [ntt.ntt_tile_stages_plain(x[i:i + span], tables, s0, s1, diag, inverse)
                  for i in range(0, count, span)]
        assert torch.equal(torch.cat(pieces), want)
