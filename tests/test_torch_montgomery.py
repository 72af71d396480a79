"""The kernels' field arithmetic (``csrc/montgomery.cuh``: add_mod, sub_mod,
mont_mul on 32-bit carry chains) compiled with the host C++ compiler, where
each PTX carry instruction is emulated, against Python integers on the five
fields: edge values (0, 1, p - 1, words of all ones) and seeded random ones.
K1, K4's inverse, KT and KM all run this arithmetic on the card."""

import random
import shutil
import subprocess
from pathlib import Path

import pytest

from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255

CSRC = Path(__file__).resolve().parents[1] / "lcpc_proof_of_storage_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdio>
#include "montgomery.cuh"
// stdin: p's W words, then pairs of W-word values; stdout: a*b/R, a+b, a-b mod p
template <int W> int run() {
    uint32_t p[W], a[W], b[W], r[W];
    for (int i = 0; i < W; ++i) if (scanf("%u", &p[i]) != 1) return 1;
    const Mod<W> m = make_mod<W>(p);
    for (;;) {
        for (int i = 0; i < W; ++i) if (scanf("%u", &a[i]) != 1) return 0;
        for (int i = 0; i < W; ++i) if (scanf("%u", &b[i]) != 1) return 1;
        mont_mul<W>(r, a, b, m);
        for (int i = 0; i < W; ++i) printf("%u ", r[i]);
        add_mod<W>(r, a, b, m);
        for (int i = 0; i < W; ++i) printf("%u ", r[i]);
        sub_mod<W>(r, a, b, m);
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
    d = tmp_path_factory.mktemp("montgomery")
    (d / "harness.cc").write_text(HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", f"-I{CSRC}", str(d / "harness.cc"),
                    "-o", str(d / "harness")], check=True)
    return d / "harness"


def _words(v: int, W: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(W)]


@pytest.mark.parametrize("spec", [FT63, FT127, FT191, FT255, FT253_192], ids=lambda s: s.name)
def test_carry_chain_arithmetic_matches_integers(harness, spec):
    p, W = spec.modulus, spec.num_limbs16 // 2
    R = 1 << (32 * W)
    edge = [0, 1, 2, p - 1, p - 2, p // 2, (p + 1) // 2, R // 2 % p, (1 << 32) % p, (R - 1) % p]
    edge += [(p - (1 << (32 * i))) % p for i in range(W)]
    edge += [((1 << (32 * i)) - 1) % p for i in range(1, W)]
    rng = random.Random(spec.num_limbs16)
    pairs = [(a, b) for a in edge for b in edge]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(3000)]
    pairs += [tuple(sum(rng.choice([0, 0xFFFFFFFF, rng.getrandbits(32)]) << (32 * i)
                        for i in range(W)) % p for _ in range(2)) for _ in range(1000)]
    stdin = " ".join(map(str, _words(p, W))) + "\n" + "\n".join(
        " ".join(map(str, _words(a, W) + _words(b, W))) for a, b in pairs)
    out = subprocess.run([str(harness), str(W)], input=stdin, capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert len(out) == len(pairs)
    r_inv = pow(R, -1, p)
    for (a, b), line in zip(pairs, out):
        v = list(map(int, line.split()))
        got = [sum(x << (32 * i) for i, x in enumerate(v[k * W:(k + 1) * W])) for k in range(3)]
        assert got == [a * b * r_inv % p, (a + b) % p, (a - b) % p], (hex(a), hex(b))
