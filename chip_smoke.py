#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (lcpc_proof_of_storage_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one or more lines each: environment; kernel build from csrc/; each
hand-written kernel against its plain PyTorch version on the card
(bit-exact); the golden pins of tests/golden_vectors.json with every tensor
on CUDA; the main path (Ligero rho=1/4, ft255, 2^20 coefficients: one
commit, then prove + verify at three points) with the kernels' launch
counts; timings.  It prints a JSON line of per-kernel results and, last,
{"ok": true, "device": {...}}.  Any failure exits non-zero without that
line, as does a machine with no CUDA device or a directory without the port.
It imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG2_MAIN = 20
N_POINTS = 3
N_TIMED = 3
SEED = 20261016


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def random_limbs(rng, shape, spec):
    """Canonical (< p) random 16-bit limbs: the top limb stays below p's."""
    import numpy as np
    L = spec.num_limbs16
    x = rng.integers(0, 1 << 16, size=(*shape, L), dtype=np.int64)
    x[..., L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=shape)
    return x.astype(np.int32)


class Results:
    """Per kernel: max error over the comparisons, main-path launches, and
    timings."""

    def __init__(self):
        self.err: dict[str, int] = {}
        self.launches: dict[str, int] = {}
        self.ms: dict[str, float] = {}
        self.plain_ms: dict[str, float] = {}

    def compare(self, name: str, what: str, got, want) -> None:
        import torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        self.err[name] = max(self.err.get(name, 0), err)
        if err:
            raise AssertionError(f"{name} {what}: kernel differs from plain (max abs err {err})")
        say(f"kernel {name} {what}: bit-exact against plain")


def cuda_ms(fn, runs: int = N_TIMED) -> float:
    """Median milliseconds of fn() over `runs` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def merkle_array(leaves, parents):
    """Every layer above a power-of-two number of leaves, concatenated."""
    import torch
    layers = [leaves]
    while layers[-1].shape[0] > 1:
        layers.append(parents(layers[-1]))
    return torch.cat(layers)


def check_kernels(res: Results, dev) -> None:
    """Every kernel against its plain version on the card, bit-exact."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
    from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse, ntt

    rng = np.random.default_rng(SEED)
    for spec in (FT63, FT127, FT191, FT255, FT253_192):
        for batch, n, nnz in ((3, 64, 64), (2, 1 << 10, 700), (4, 1 << 15, 1 << 13)):
            x = torch.from_numpy(random_limbs(rng, (batch, n), spec)).to(dev)
            tables = ntt.NttTables(spec, n).to(dev)
            res.compare("ntt", f"{spec.name} batch={batch} n={n} n_nonzero={nnz}",
                        ntt.ntt(x, spec, nnz, tables), ntt.ntt_plain(x, spec, nnz, tables))

    for spec, rows, cols in ((FT255, 128, 1024), (FT63, 1, 300), (FT255, 128, 189),
                             (FT253_192, 40, 100), (FT63, 300, 77), (FT127, 128, 189),
                             (FT191, 70, 300)):
        m = torch.from_numpy(random_limbs(rng, (rows, cols), spec)).to(dev)
        res.compare("blake3_leaves", f"{spec.name} rows={rows} cols={cols}",
                    blake3.hash_columns(m, spec), blake3.hash_columns_plain(m, spec))
    leaves = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(1 << 15, 8),
                                           dtype=np.int64).astype(np.int32)).to(dev)
    res.compare("blake3_parents", "Merkle tree over 32768 leaves (all 15 layers)",
                merkle_array(leaves, blake3.merkle_parents),
                merkle_array(leaves, blake3.merkle_parents_plain))

    for spec, rows, npr, T in ((FT255, 128, 8192, 2), (FT63, 3000, 512, 2),
                               (FT255, 2500, 64, 1), (FT127, 128, 1024, 2),
                               (FT191, 2100, 256, 2)):
        c = torch.from_numpy(random_limbs(rng, (rows, npr), spec)).to(dev)
        t = torch.from_numpy(random_limbs(rng, (T, rows), spec)).to(dev)
        res.compare("collapse", f"{spec.name} rows={rows} npr={npr} T={T}",
                    collapse.collapse(c, t, spec), collapse.collapse_plain(c, t, spec))


def _prove_fixed(comm, enc, root, x=123456789):
    from lcpc_proof_of_storage_tpu_torch import Transcript, prove
    spec = enc.spec
    tr = Transcript(b"golden")
    tr.append_message(b"polycommit", root)
    xr = pow(x, comm.n_per_row, spec.modulus)
    outer = [pow(xr, i, spec.modulus) for i in range(comm.n_rows)]
    return prove(comm, outer, enc, tr), tr


def check_golden(dev) -> None:
    """The Ligero golden pins, reproduced with every tensor on CUDA."""
    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, commit, proof_to_json,
                                                 serialize_proof)
    from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT253_192, FT255

    golden = json.loads((ROOT / "tests" / "golden_vectors.json").read_text())
    got = {}
    coeffs = [(i * 2654435761 + 12345) % FT63.modulus for i in range(512)]
    enc = LigeroEncoding.new_from_dims(16, 64, FT63)
    comm = commit(coeffs, enc, device=dev)
    root = comm.get_root().root
    proof, tr = _prove_fixed(comm, enc, root)
    blob = serialize_proof(proof, FT63)
    got["ligero_ft63_root"] = root.hex()
    got["proof_sha"] = hashlib.sha256(blob).hexdigest()
    got["proof_len"] = len(blob)
    got["transcript_state_sha"] = hashlib.sha256(tr.state_bytes()).hexdigest()
    got["proof_json_sha"] = hashlib.sha256(json.dumps(
        proof_to_json(proof, FT63), sort_keys=True).encode()).hexdigest()
    for name, spec in (("ft255", FT255), ("ft253_192", FT253_192)):
        wcoeffs = [(i * 0x9E3779B97F4A7C15 + 7) % spec.modulus for i in range(512)]
        wenc = LigeroEncoding.new_from_dims(16, 64, spec)
        wcomm = commit(wcoeffs, wenc, device=dev)
        wroot = wcomm.get_root().root
        wblob = serialize_proof(_prove_fixed(wcomm, wenc, wroot)[0], spec)
        got[f"ligero_{name}_root"] = wroot.hex()
        got[f"ligero_{name}_proof_sha"] = hashlib.sha256(wblob).hexdigest()
        got[f"ligero_{name}_proof_len"] = len(wblob)
    bad = {k: (v, golden[k]) for k, v in got.items() if golden[k] != v}
    if bad:
        raise AssertionError(f"golden pins differ on CUDA: {bad}")
    say(f"golden: {len(got)} pins reproduced on CUDA ({', '.join(sorted(got))})")


def check_verify(dev) -> None:
    """verify runs where it is told: with no device after a CUDA commit on
    the same encoding it launches no kernel and returns the evaluation.  On
    the card, a proof whose first degree-test row carries one extra nonzero
    coefficient is rejected with ColumnDegree through K1 (the re-encode
    reads every coefficient of the widened row)."""
    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, Transcript, VerifierError,
                                                 commit, kernels, verify)
    from lcpc_proof_of_storage_tpu_torch.fields import FT63

    spec = FT63
    coeffs = [(i * 2654435761 + 12345) % spec.modulus for i in range(512)]
    enc = LigeroEncoding.new_from_dims(16, 64, spec)
    comm = commit(coeffs, enc, device=dev)
    root = comm.get_root().root
    x = 123456789
    xr = pow(x, comm.n_per_row, spec.modulus)
    outer = [pow(xr, i, spec.modulus) for i in range(comm.n_rows)]
    inner = [pow(x, j, spec.modulus) for j in range(comm.n_per_row)]

    def transcript():
        tr = Transcript(b"golden")
        tr.append_message(b"polycommit", root)
        return tr

    proof, _ = _prove_fixed(comm, enc, root)
    before = {name: k.launches for name, k in kernels.KERNELS.items()}
    value = verify(root, outer, inner, proof, enc, transcript())
    if value != horner(coeffs, x, spec.modulus):
        raise AssertionError("verify on the CPU returned a wrong evaluation")
    if {name: k.launches for name, k in kernels.KERNELS.items()} != before:
        raise AssertionError("verify with no device launched a kernel")
    say("verify: with no device, after a CUDA commit on the same encoding, it ran on "
        "the CPU (no kernel launched) and returned the evaluation")

    proof.p_random_vec[0].append(5)
    before = kernels.NTT_FORWARD.launches
    try:
        verify(root, outer, inner, proof, enc, transcript(), device=dev)
    except VerifierError as e:
        if e.kind != "ColumnDegree":
            raise AssertionError(f"over-long row rejected as {e.kind}, not ColumnDegree")
    else:
        raise AssertionError("over-long degree-test row was accepted")
    if kernels.NTT_FORWARD.launches != before + 1:
        raise AssertionError("verify's re-encode did not go through the NTT kernel")
    say("verify: a degree-test row with one extra coefficient is rejected "
        "(ColumnDegree) through the NTT kernel")


def plain_root(coeff_mat, enc) -> bytes:
    """The commitment root computed with the plain versions only."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.ops import blake3, ntt
    n_rows, npr, L = coeff_mat.shape
    padded = coeff_mat.new_zeros((n_rows, enc.n_cols, L))
    padded[:, :npr] = coeff_mat
    comm = ntt.ntt_plain(padded, enc.spec, npr, enc.tables(coeff_mat.device))
    leaves = blake3.hash_columns_plain(comm, enc.spec)   # n_cols is a power of two
    del comm, padded
    torch.cuda.empty_cache()
    return blake3.digest_to_bytes(merkle_array(leaves, blake3.merkle_parents_plain)[-1])


def horner(coeff_ints: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeff_ints):
        acc = (acc * x + c) % p
    return acc


def main_path(res: Results, dev) -> None:
    """Ligero rho=1/4 over ft255 at 2^20: commit once, prove and verify at
    N_POINTS points; launch counts of every kernel; timings."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, Transcript, commit, kernels,
                                                 prove, verify)
    from lcpc_proof_of_storage_tpu_torch.fields import FT255, limbs_to_ints
    from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse, ntt

    spec = FT255
    p = spec.modulus
    length = 1 << LOG2_MAIN
    enc = LigeroEncoding.new(length, spec, rho=(1, 4))
    n_rows, n_per_row, n_cols = enc.get_dims(length)
    rng = np.random.default_rng(SEED)
    coeffs_np = random_limbs(rng, (length,), spec)
    coeffs = torch.from_numpy(coeffs_np).to(dev)
    coeff_ints = limbs_to_ints(coeffs_np)
    points = [int(v) % p for v in rng.integers(1, 1 << 62, size=N_POINTS)]
    say(f"main: Ligero rho=1/4 {spec.name} 2^{LOG2_MAIN} coefficients, dims "
        f"(n_rows, n_per_row, n_cols) = ({n_rows}, {n_per_row}, {n_cols}), "
        f"{enc.get_n_degree_tests()} degree test(s), {enc.get_n_col_opens()} column openings")

    def proof_inputs(x):
        xr = pow(x, n_per_row, p)
        return ([pow(xr, i, p) for i in range(n_rows)],
                [pow(x, j, p) for j in range(n_per_row)])

    def transcript(root):
        tr = Transcript(b"chip_smoke")
        tr.append_message(b"polycommit", root)
        return tr

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    comm = commit(coeffs, enc, device=dev)
    root = comm.get_root().root
    for x in points:
        outer, inner = proof_inputs(x)
        proof = prove(comm, outer, enc, transcript(root))
        value = verify(root, outer, inner, proof, enc, transcript(root), device=dev)
        if value != horner(coeff_ints, x, p):
            raise AssertionError(f"verify returned a wrong evaluation at x={x}")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.KERNELS.items()}
    say(f"main: root {root.hex()}; {N_POINTS} proofs verified with the evaluations "
        f"computed on the host; launches {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    res.launches = launches

    want = plain_root(comm.coeffs, enc)
    if want != root:
        raise AssertionError(f"root {root.hex()} differs from the plain versions' {want.hex()}")
    say("main: root equals the root the plain versions compute on the card")

    # timings: median of N_TIMED runs after a warm-up, synchronised
    outer, inner = proof_inputs(points[0])
    proof = prove(comm, outer, enc, transcript(root))
    t_commit = cuda_ms(lambda: commit(coeffs, enc, device=dev))
    t_prove = cuda_ms(lambda: prove(comm, outer, enc, transcript(root)))
    t_verify = cuda_ms(lambda: verify(root, outer, inner, proof, enc, transcript(root),
                                      device=dev))
    card = card_line()
    say(f"time [{card}]: commit {t_commit:.3f} ms, prove {t_prove:.3f} ms, "
        f"verify {t_verify:.3f} ms at 2^{LOG2_MAIN} {spec.name} "
        f"({length / (t_commit / 1e3):.0f} coefficients/s committed)")

    padded = comm.coeffs.new_zeros((n_rows, n_cols, spec.num_limbs16))
    padded[:, :n_per_row] = comm.coeffs
    leaves = blake3.hash_columns(comm.comm, spec)
    tvec = torch.from_numpy(random_limbs(rng, (2, n_rows), spec)).to(dev)

    cases = {
        "ntt": (lambda: ntt.ntt(padded, spec, n_per_row, enc.tables(padded.device)),
                lambda: ntt.ntt_plain(padded, spec, n_per_row, enc.tables(padded.device)),
                f"({n_rows}, {n_cols}, 16) n_nonzero={n_per_row}"),
        "blake3_leaves": (lambda: blake3.hash_columns(comm.comm, spec),
                          lambda: blake3.hash_columns_plain(comm.comm, spec),
                          f"({n_rows}, {n_cols}, 16) -> ({n_cols}, 8)"),
        "blake3_parents": (lambda: merkle_array(leaves, blake3.merkle_parents),
                           lambda: merkle_array(leaves, blake3.merkle_parents_plain),
                           f"all {n_cols.bit_length() - 1} layers over {n_cols} leaves"),
        "collapse": (lambda: collapse.collapse(comm.coeffs, tvec, spec),
                     lambda: collapse.collapse_plain(comm.coeffs, tvec, spec),
                     f"({n_rows}, {n_per_row}, 16) T=2"),
    }
    for name, (kern, plain, shape) in cases.items():
        # plain, kernel, kernel, plain: both orders see the same card state
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        res.ms[name] = min(k1, k2)
        res.plain_ms[name] = min(p1, p2)
        say(f"time [{card}]: {name} {shape}: kernel {k1:.3f}/{k2:.3f} ms, "
            f"plain {p1:.3f}/{p2:.3f} ms")


KERNEL_INFO = {
    "ntt": ("lcpc_proof_of_storage_tpu_torch/csrc/ntt.cu",
            "lcpc_proof_of_storage_tpu/ops/ntt_pallas3.py:546"),
    "blake3_leaves": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                      "lcpc_proof_of_storage_tpu/ops/blake3_pallas.py:139"),
    "blake3_parents": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                       "lcpc_proof_of_storage_tpu/ops/blake3_jax.py:325"),
    "collapse": ("lcpc_proof_of_storage_tpu_torch/csrc/collapse.cu",
                 "lcpc_proof_of_storage_tpu/ops/collapse_pallas.py:279"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from lcpc_proof_of_storage_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    say(f"card: {card}")
    t0 = time.perf_counter()
    kernels.library()
    say(f"build: csrc/*.cu -> {kernels.build()} in {time.perf_counter() - t0:.1f} s")

    res = Results()
    check_kernels(res, dev)
    check_golden(dev)
    check_verify(dev)
    main_path(res, dev)

    say(card)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": res.launches[name], "max_abs_err": res.err[name],
         "ms": res.ms[name], "plain_ms": res.plain_ms[name]}
        for name, (src, rep) in KERNEL_INFO.items()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
