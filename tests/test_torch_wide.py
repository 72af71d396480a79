"""The sums of products that K3, K3p and K5 run (``csrc/wide.cuh``: mac,
fold, add_wide, reduce_wide on 32-bit carry chains) compiled with the host
C++ compiler, where each PTX carry instruction is emulated, against Python
integers on the five fields:

- sums of seeded random products and of edge values (0, 1, p - 1, words of
  all ones, which are not canonical), with every carry counter at most twice
  the number of products;
- the reduction at the largest sum the guards admit, kMaxTerms products of
  (p - 1)^2, and at the largest 2W+1-word value, with the guards
  (ops/expander.py MAX_SLOTS, ops/collapse.py MAX_ROWS) equal to kMaxTerms;
- the kernels' launch plans against their Python mirrors.
"""

import random
import shutil
import subprocess
from pathlib import Path

import pytest

from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field
from lcpc_proof_of_storage_tpu_torch.ops import collapse, expander

CSRC = Path(__file__).resolve().parents[1] / "lcpc_proof_of_storage_tpu_torch" / "csrc"
SPECS = [FT63, FT127, FT191, FT255, FT253_192]

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include "wide.cuh"
// argv: mode W.  stdin: p's 2W limbs, mu's limb count and limbs, then
//   sum:    groups of "n" and n pairs of W-word values; each group prints the
//           folded sum (2W+1 words), its reduction (W words), the largest counter
//   reduce: 2W+1-word values; each prints its reduction
//   plan:   "rows npr T" lines; each prints collapse_row_warps and, for b = rows,
//           expander_b_tile
template <int W> int run(const char* mode) {
    if (!strcmp(mode, "plan")) {
        printf("%u %d %d\n", kMaxTerms, collapse_t_tile(W), kCollapseWarps);
        int rows, npr, T;
        while (scanf("%d %d %d", &rows, &npr, &T) == 3)
            printf("%d %d\n", collapse_row_warps(rows, npr, T, W), expander_b_tile(W, rows));
        return 0;
    }
    uint32_t p[2 * W], mu[2 * W + 4], r[W], z[2 * W + 1];
    int mu_len;
    for (int i = 0; i < 2 * W; ++i) if (scanf("%u", &p[i]) != 1) return 1;
    if (scanf("%d", &mu_len) != 1 || mu_len > 2 * W + 4) return 1;
    for (int i = 0; i < mu_len; ++i) if (scanf("%u", &mu[i]) != 1) return 1;
    Barrett<W> k;
    if (!make_barrett<W>(k, p, mu, mu_len)) return 1;
    for (;;) {
        if (!strcmp(mode, "reduce")) {
            for (int i = 0; i < 2 * W + 1; ++i) if (scanf("%u", &z[i]) != 1) return 0;
        } else {
            long n;
            if (scanf("%ld", &n) != 1) return 0;
            Wide<W> s;
            wide_zero<W>(s);
            uint32_t a[W], b[W];
            for (long t = 0; t < n; ++t) {
                for (int i = 0; i < W; ++i) if (scanf("%u", &a[i]) != 1) return 1;
                for (int i = 0; i < W; ++i) if (scanf("%u", &b[i]) != 1) return 1;
                mac<W>(s, a, b);
            }
            fold<W>(s, z);
            uint32_t top = 0;
            for (int i = 0; i <= W; ++i) top = s.c[i] > top ? s.c[i] : top;
            for (int i = 0; i < 2 * W + 1; ++i) printf("%u ", z[i]);
            printf("%u ", top);
        }
        reduce_wide<W>(z, k, r);
        for (int i = 0; i < W; ++i) printf("%u ", r[i]);
        printf("\n");
    }
}
int main(int argc, char** argv) {
    switch (argv[2][0] - '0') {
        case 2: return run<2>(argv[1]);
        case 4: return run<4>(argv[1]);
        case 6: return run<6>(argv[1]);
        case 8: return run<8>(argv[1]);
    }
    return 1;
}
"""

MAX_TERMS = (1 << 31) - 1


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("wide")
    (d / "harness.cc").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", f"-I{CSRC}", str(d / "harness.cc"),
                    "-o", str(d / "harness")], check=True)
    return d / "harness"


def _words(v: int, n: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _int(words) -> int:
    return sum(int(x) << (32 * i) for i, x in enumerate(words))


def _run(harness, mode: str, spec, body: str) -> list[list[int]]:
    lf = limb_field(spec)
    W = spec.num_limbs16 // 2
    mu = lf.mu(4 * W + 2)
    head = " ".join(map(str, lf.p)) + f"\n{len(mu)} " + " ".join(map(str, mu)) + "\n"
    out = subprocess.run([str(harness), mode, str(W)], input=head + body, capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return [list(map(int, line.split())) for line in out]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_sums_of_products_match_integers(harness, spec):
    p, W = spec.modulus, spec.num_limbs16 // 2
    ones = (1 << (32 * W)) - 1
    edge = [0, 1, 2, p - 1, p - 2, p // 2, (1 << 32) % p, ones, ones - 1, 1 << (32 * W - 1)]
    edge += [(1 << (32 * i)) - 1 for i in range(1, W)]
    rng = random.Random(spec.num_limbs16)
    groups = [[(a, b)] for a in edge for b in edge]
    groups += [[(a, b) for a in edge for b in edge]]
    groups += [[(p - 1, p - 1)] * 3000, [(ones, ones)] * 3000]
    groups += [[(rng.randrange(p), rng.randrange(p)) for _ in range(n)] for n in (7, 300, 2000)]
    groups += [[(rng.choice([rng.getrandbits(32 * W), ones, p - 1]),
                 rng.choice([rng.getrandbits(32 * W), 0, ones])) for _ in range(500)]]
    body = "\n".join(f"{len(g)} " + " ".join(" ".join(map(str, _words(a, W) + _words(b, W)))
                                              for a, b in g) for g in groups)
    out = _run(harness, "sum", spec, body)
    assert len(out) == len(groups)
    for g, v in zip(groups, out):
        want = sum(a * b for a, b in g)
        assert _int(v[:2 * W + 1]) == want, [hex(a) for a, _ in g[:2]]
        assert v[2 * W + 1] <= 2 * len(g)            # each product adds at most 2 to a counter
        assert _int(v[2 * W + 2:]) == want % p


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_reduction_at_the_largest_admitted_sum(harness, spec):
    p, W = spec.modulus, spec.num_limbs16 // 2
    assert expander.MAX_SLOTS == collapse.MAX_ROWS == MAX_TERMS
    top = MAX_TERMS * ((1 << (32 * W)) - 1) ** 2      # any W-word values, not only canonical
    assert top < 1 << (32 * (2 * W + 1))
    rng = random.Random(7 * W)
    zs = [0, 1, p - 1, p, 2 * p, 3 * p - 1, MAX_TERMS * (p - 1) ** 2, top,
          (1 << (32 * (2 * W + 1))) - 1, p << (32 * (W + 1))]
    zs += [rng.getrandbits(32 * (2 * W + 1)) for _ in range(2000)]
    zs += [rng.randrange(MAX_TERMS) * rng.randrange(p) ** 2 for _ in range(500)]
    out = _run(harness, "reduce", spec,
               "\n".join(" ".join(map(str, _words(z, 2 * W + 1))) for z in zs))
    assert [_int(v) for v in out] == [z % p for z in zs]


@pytest.mark.parametrize("W", [2, 4, 6, 8])
def test_launch_plans_match_python(harness, W):
    shapes = [(128, 8192, 2), (585, 16384, 1), (128, 262144, 2), (143, 235172, 2),
              (18, 117587, 2), (3000, 512, 2), (2500, 64, 1), (7, 8, 1), (1000, 40, 5),
              (64, 1, 3), (31, 100, 9), (32, 100, 2), (2, 100, 2), (1, 7, 1)]
    out = subprocess.run([str(harness), "plan", str(W)], capture_output=True, text=True,
                         check=True, input="\n".join(" ".join(map(str, s)) for s in shapes))
    lines = out.stdout.splitlines()
    assert list(map(int, lines[0].split())) == [
        MAX_TERMS, collapse.T_TILE[W], collapse.WARPS]
    for (rows, npr, T), line in zip(shapes, lines[1:]):
        plan = collapse.collapse_plan(rows, npr, T, 2 * W)
        assert list(map(int, line.split())) == [plan.row_warps, expander.b_tile(W, rows)], \
            (rows, npr, T)
