#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (lcpc_proof_of_storage_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one or more lines each: environment; kernel build from csrc/ (one
nvcc per source, in parallel); each hand-written kernel against its plain
PyTorch version on the card (bit-exact), K5 on every field, on a level of
3000 slots, on a ragged row count and on all 12 levels of a 2^21 encode;
the Ligero and Brakedown golden pins of tests/golden_vectors.json with every
tensor on CUDA; verify's placement; the Ligero path (rho=1/4, ft255, 2^20:
one commit, prove + verify at three points); the Brakedown path (SdigCode3,
ft255, seed 0, 2^21: one commit, prove + verify at two points, proof bytes,
root against the plain versions'); one Brakedown commit, prove and verify
at 2^25; timings.  Each path runs with every kernel's launch count set to 0
just before it and read just after.  The script prints a JSON line of
per-kernel results and, last, {"ok": true, "device": {...}}.  Any failure
exits non-zero without that line, as does a machine with no CUDA device or
a directory without the port.  It imports nothing of JAX.
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
N_EVENTS = 20
SEED = 20261016
BD_LOG2 = 21
BD_POINTS = 2
BD_DIMS = (18, 117587, 178850)
BD_PROOF_LEN = 16175624
BD_LOG2_BIG = 25
BD_DIMS_BIG = (143, 235172)
BD_PROOF_LEN_BIG = 50336784
# the least time the card could take: bytes over its memory rate, 32-bit
# integer operations over its peak integer rate.  NVIDIA H100 SXM data sheet
# (700 W): 3.35 TB/s, and 67 T float32 operations/s outside the tensor cores
# from 128 FP32 lanes an SM; the Hopper architecture whitepaper gives an SM
# 64 INT32 lanes, half as many, so 33.5 T 32-bit integer operations/s with a
# multiply-add counted as two.  Every kernel's operations are counted in
# 32-bit words: a product of two W-word field elements is W^2 multiply-adds
# (2 W^2 operations), whatever digit width the kernel itself multiplies in.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
BLAKE3_OPS = 800          # 32-bit adds, xors, rotates of one compression


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


def random_limbs_device(gen, shape, spec, dev):
    """random_limbs drawn on the card from a seeded torch generator."""
    import torch
    L = spec.num_limbs16
    x = torch.randint(0, 1 << 16, (*shape, L), generator=gen, device=dev, dtype=torch.int32)
    x[..., L - 1] = torch.randint(0, spec.modulus >> (16 * (L - 1)), shape, generator=gen,
                                  device=dev, dtype=torch.int32)
    return x


class Results:
    """Per kernel: max error over the comparisons, launches on each path,
    timings and bounds."""

    def __init__(self):
        self.err: dict[str, int] = {}
        self.launches: dict[str, dict[str, int]] = {}
        self.ms: dict[str, float] = {}
        self.plain_ms: dict[str, float] = {}
        self.bound: dict[str, tuple[float, str]] = {}

    def compare(self, name: str, what: str, got, want, quiet: bool = False) -> None:
        import torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        self.err[name] = max(self.err.get(name, 0), err)
        if err:
            raise AssertionError(f"{name} {what}: kernel differs from plain (max abs err {err})")
        if not quiet:
            say(f"kernel {name} {what}: bit-exact against plain")

    def add_launches(self, path: str, counts: dict[str, int]) -> None:
        for name, n in counts.items():
            self.launches.setdefault(name, {})[path] = n


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes / memory rate and
    operations / peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, runs: int = N_TIMED) -> float:
    """Median wall milliseconds of fn() over `runs` synchronised runs after
    one warm-up (for host-and-device steps)."""
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


def event_ms(fn, runs: int = N_EVENTS) -> float:
    """Mean device milliseconds of fn() over `runs` back-to-back runs between
    two CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def timed_pair(res: Results, name: str, kern, plain, shape: str, card: str,
               plain_runs: int = 2) -> None:
    """Kernel and plain version in turns (plain, kernel, kernel, plain), CUDA
    event times."""
    p1 = event_ms(plain, plain_runs)
    k1 = event_ms(kern)
    k2 = event_ms(kern)
    p2 = event_ms(plain, plain_runs)
    res.ms[name] = min(k1, k2)
    res.plain_ms[name] = min(p1, p2)
    b, by = res.bound[name]
    say(f"time [{card}]: {name} {shape}: kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.3f}/{p2:.3f} ms, bound {b:.4f} ms ({by})")


def merkle_array(leaves, parents):
    """Every layer above a power-of-two number of leaves, concatenated."""
    import torch
    layers = [leaves]
    while layers[-1].shape[0] > 1:
        layers.append(parents(layers[-1]))
    return torch.cat(layers)


def horner(coeff_ints: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeff_ints):
        acc = (acc * x + c) % p
    return acc


def launches_of(run) -> dict[str, int]:
    """Every kernel's launches in run(), counted from 0."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    return {name: k.launches for name, k in kernels.KERNELS.items()}


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def check_kernels(res: Results, dev) -> None:
    """K1, K2 and K3 against their plain versions on the card, bit-exact."""
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
                             (FT191, 70, 300), (FT255, 18, 4099), (FT255, 143, 300)):
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
                               (FT191, 2100, 256, 2), (FT255, 18, 4099, 2)):
        c = torch.from_numpy(random_limbs(rng, (rows, npr), spec)).to(dev)
        t = torch.from_numpy(random_limbs(rng, (T, rows), spec)).to(dev)
        res.compare("collapse", f"{spec.name} rows={rows} npr={npr} T={T}",
                    collapse.collapse(c, t, spec), collapse.collapse_plain(c, t, spec))


def check_expander(res: Results, dev) -> None:
    """K5 against gather_matvec_plain on the card, bit-exact: every field on
    the levels of an n = 3000 code at b in {1, 3, 18}; a synthetic ft255
    level of 3000 slots (beyond the TPU one-pass kernel's 2048); a level
    whose row count is not a multiple of the kernel's 128-row block; all 12
    levels of one 2^21 ft255 SdigCode3 encode."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
    from lcpc_proof_of_storage_tpu_torch.ops import expander as ex

    rng = np.random.default_rng(SEED + 5)
    for spec in (FT63, FT127, FT191, FT255, FT253_192):
        enc = ex.ExpanderEncoder.build(3000, 1, spec, ex.SDIG_CODE_3).on(dev)
        for b in (1, 3, 18):
            for name, tab in (("pre0", enc.pre[0]), ("post0", enc.post[0]),
                              ("post1", enc.post[1])):
                x = torch.from_numpy(random_limbs(rng, (b, tab.cols), spec)).to(dev)
                res.compare("expander", f"{spec.name} n=3000 {name} ({tab.rows} rows, "
                            f"{tab.slots} slots) b={b}", ex.gather_matvec(tab, x, spec),
                            ex.gather_matvec_plain(tab, x, spec), quiet=b != 18)

    spec = FT255
    for K, rows, cols in ((3000, 300, 5000), (7, 1000, 777)):
        idx = rng.integers(0, cols, size=(K, rows)).astype(np.int32)
        vals = random_limbs(rng, (K, rows), spec).view(np.uint32)
        vals[K - 1, : rows // 2] = 0        # short rows: counts below K
        tab = ex.GatherTables(ex.GatherMat(rows, cols, idx, vals)).to(dev)
        x = torch.from_numpy(random_limbs(rng, (3, cols), spec)).to(dev)
        res.compare("expander", f"{spec.name} synthetic level K={K} rows={rows} cols={cols}",
                    ex.gather_matvec(tab, x, spec), ex.gather_matvec_plain(tab, x, spec))

    enc = ex.ExpanderEncoder.build(BD_DIMS[1], 0, spec, ex.SDIG_CODE_3).on(dev)
    x = torch.from_numpy(random_limbs(rng, (BD_DIMS[0], BD_DIMS[1]), spec)).to(dev)
    seen = []

    def checking(tab, xin, field):
        y = ex.gather_matvec(tab, xin, field)
        res.compare("expander", "", y, ex.gather_matvec_plain(tab, xin, field), quiet=True)
        seen.append((tab.rows, tab.cols, tab.slots))
        return y

    enc.encode(x, matvec=checking)
    say(f"kernel expander: all {len(seen)} levels of a 2^{BD_LOG2} {spec.name} SdigCode3 "
        f"encode (b={BD_DIMS[0]}; (rows, cols, slots) {seen}) bit-exact against plain")


# --------------------------------------------------------------------------
# golden pins and verify placement
# --------------------------------------------------------------------------

def _prove_fixed(comm, enc, root, x=123456789):
    from lcpc_proof_of_storage_tpu_torch import Transcript, prove
    spec = enc.spec
    tr = Transcript(b"golden")
    tr.append_message(b"polycommit", root)
    xr = pow(x, comm.n_per_row, spec.modulus)
    outer = [pow(xr, i, spec.modulus) for i in range(comm.n_rows)]
    return prove(comm, outer, enc, tr), tr


def check_golden(dev) -> None:
    """The Ligero and Brakedown golden pins, reproduced with every tensor on
    CUDA."""
    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, LigeroEncoding, commit,
                                                 proof_to_json, serialize_proof)
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
    bde = BrakedownEncoding.new(512, seed=7, field=FT63)
    bd_coeffs = [(i * 97 + 5) % FT63.modulus for i in range(512)]
    bd_comm = commit(bd_coeffs, bde, device=dev)
    bd_root = bd_comm.get_root().root
    bd_blob = serialize_proof(_prove_fixed(bd_comm, bde, bd_root)[0], FT63)
    got["brakedown_ft63_root"] = bd_root.hex()
    got["brakedown_ft63_proof_sha"] = hashlib.sha256(bd_blob).hexdigest()
    got["brakedown_ft63_proof_len"] = len(bd_blob)
    bad = {k: (v, golden[k]) for k, v in got.items() if golden[k] != v}
    if bad:
        raise AssertionError(f"golden pins differ on CUDA: {bad}")
    say(f"golden: {len(got)} pins reproduced on CUDA ({', '.join(sorted(got))})")


def check_verify(dev) -> None:
    """commit and verify run on the card unless asked for the CPU: a commit
    of python ints with no device lands on the card; a verify with no device
    re-encodes there (K1 for Ligero, K5 for Brakedown); a verify given the
    CPU launches no kernel; each returns the evaluation.  On the card, a
    Ligero proof whose first degree-test row carries one extra nonzero
    coefficient is rejected with ColumnDegree through K1 (the re-encode reads
    every coefficient of the widened row)."""
    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, LigeroEncoding,
                                                 VerifierError, commit, kernels, verify)
    from lcpc_proof_of_storage_tpu_torch.fields import FT63

    spec = FT63
    x = 123456789

    def golden_tr(root):
        from lcpc_proof_of_storage_tpu_torch import Transcript
        tr = Transcript(b"golden")
        tr.append_message(b"polycommit", root)
        return tr

    def all_launches():
        return sum(k.launches for k in kernels.KERNELS.values())

    ligero = LigeroEncoding.new_from_dims(16, 64, spec)
    brakedown = BrakedownEncoding.new(512, seed=7, field=spec)
    for enc, kernel, per_encode in (
            (ligero, "ntt", 1),
            (brakedown, "expander", len(brakedown.encoder.pre) + len(brakedown.encoder.post))):
        coeffs = [(i * 2654435761 + 12345) % spec.modulus for i in range(512)]
        comm = commit(coeffs, enc)
        if comm.device.type != "cuda":
            raise AssertionError(f"a commit with no device ran on {comm.device}")
        root = comm.get_root().root
        outer, inner = point_tensors(x, comm.n_rows, comm.n_per_row, spec.modulus)
        proof, _ = _prove_fixed(comm, enc, root, x)
        want = horner(coeffs, x, spec.modulus)
        for device in (None, "cpu"):
            before, before_all = kernels.KERNELS[kernel].launches, all_launches()
            value = verify(root, outer, inner, proof, enc, golden_tr(root), device=device)
            n, n_all = kernels.KERNELS[kernel].launches - before, all_launches() - before_all
            if value != want:
                raise AssertionError(f"{enc!r} verify(device={device}) returned a wrong "
                                     f"evaluation")
            if n != per_encode if device is None else n_all != 0:
                raise AssertionError(f"{enc!r} verify(device={device}) launched {n} {kernel} "
                                     f"of {n_all} kernels")
        say(f"verify: {type(enc).__name__} committed with no device on the card; verify "
            f"with no device re-encoded there ({per_encode} {kernel} launches), with "
            f"device='cpu' launched no kernel; both returned the evaluation")

    comm = commit([(i * 2654435761 + 12345) % spec.modulus for i in range(512)], ligero, dev)
    root = comm.get_root().root
    outer, inner = point_tensors(x, comm.n_rows, comm.n_per_row, spec.modulus)
    proof, _ = _prove_fixed(comm, ligero, root, x)
    proof.p_random_vec[0].append(5)
    before = kernels.NTT_FORWARD.launches
    try:
        verify(root, outer, inner, proof, ligero, golden_tr(root), device=dev)
    except VerifierError as e:
        if e.kind != "ColumnDegree":
            raise AssertionError(f"over-long row rejected as {e.kind}, not ColumnDegree")
    else:
        raise AssertionError("over-long degree-test row was accepted")
    if kernels.NTT_FORWARD.launches != before + 1:
        raise AssertionError("verify's re-encode did not go through the NTT kernel")
    say("verify: a degree-test row with one extra coefficient is rejected "
        "(ColumnDegree) through the NTT kernel")


# --------------------------------------------------------------------------
# the paths
# --------------------------------------------------------------------------

def plain_root(comm_plain, n_cols: int, spec) -> bytes:
    """Merkle root of an encoded matrix, with the plain hash versions."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.core.encoding import next_power_of_two
    from lcpc_proof_of_storage_tpu_torch.ops import blake3
    leaves = blake3.hash_columns_plain(comm_plain, spec)
    padded = leaves.new_zeros((next_power_of_two(n_cols), 8))
    padded[:n_cols] = leaves
    del leaves
    torch.cuda.empty_cache()
    return blake3.digest_to_bytes(merkle_array(padded, blake3.merkle_parents_plain)[-1])


def transcript(root: bytes):
    from lcpc_proof_of_storage_tpu_torch import Transcript
    tr = Transcript(b"chip_smoke")
    tr.append_message(b"polycommit", root)
    return tr


def point_tensors(x: int, n_rows: int, n_per_row: int, p: int):
    xr = pow(x, n_per_row, p)
    return [pow(xr, i, p) for i in range(n_rows)], [pow(x, j, p) for j in range(n_per_row)]


def ligero_path(res: Results, dev, card: str) -> None:
    """Ligero rho=1/4 over ft255 at 2^20: commit once, prove and verify at
    N_POINTS points; launch counts; timings."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import LigeroEncoding, commit, prove, verify
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
    say(f"ligero: rho=1/4 {spec.name} 2^{LOG2_MAIN} coefficients, dims "
        f"(n_rows, n_per_row, n_cols) = ({n_rows}, {n_per_row}, {n_cols}), "
        f"{enc.get_n_degree_tests()} degree test(s), {enc.get_n_col_opens()} column openings")

    out = {}

    def run():
        comm = out["comm"] = commit(coeffs, enc, device=dev)
        root = out["root"] = comm.get_root().root
        for x in points:
            outer, inner = point_tensors(x, n_rows, n_per_row, p)
            proof = prove(comm, outer, enc, transcript(root))
            value = verify(root, outer, inner, proof, enc, transcript(root), device=dev)
            if value != horner(coeff_ints, x, p):
                raise AssertionError(f"verify returned a wrong evaluation at x={x}")

    launches = launches_of(run)
    comm, root = out["comm"], out["root"]
    say(f"ligero: root {root.hex()}; {N_POINTS} proofs verified with the evaluations "
        f"computed on the host; launches {launches}")
    missing = [k for k in ("ntt", "blake3_leaves", "blake3_parents", "collapse")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the Ligero path: {missing}")
    res.add_launches(f"ligero_2^{LOG2_MAIN}", launches)

    padded = comm.coeffs.new_zeros((n_rows, n_cols, spec.num_limbs16))
    padded[:, :n_per_row] = comm.coeffs
    want = plain_root(ntt.ntt_plain(padded, spec, n_per_row, enc.tables(dev)), n_cols, spec)
    if want != root:
        raise AssertionError(f"root {root.hex()} differs from the plain versions' {want.hex()}")
    say("ligero: root equals the root the plain versions compute on the card")

    outer, inner = point_tensors(points[0], n_rows, n_per_row, p)
    proof = prove(comm, outer, enc, transcript(root))
    t_commit = cuda_ms(lambda: commit(coeffs, enc, device=dev))
    t_prove = cuda_ms(lambda: prove(comm, outer, enc, transcript(root)))
    t_verify = cuda_ms(lambda: verify(root, outer, inner, proof, enc, transcript(root),
                                      device=dev))
    say(f"time [{card}]: ligero commit {t_commit:.3f} ms, prove {t_prove:.3f} ms, "
        f"verify {t_verify:.3f} ms at 2^{LOG2_MAIN} {spec.name} (medians of {N_TIMED}; "
        f"{length / (t_commit / 1e3):.0f} coefficients/s committed)")

    L = spec.num_limbs16
    leaves = blake3.hash_columns(comm.comm, spec)
    tvec = torch.from_numpy(random_limbs(rng, (2, n_rows), spec)).to(dev)
    W = L // 2
    skip = (n_cols // n_per_row).bit_length() - 1     # stages that only duplicate
    # a radix-2 butterfly: one Montgomery product of W-word values (2 W^2
    # multiply-adds) and a modular add and subtract, ~4 W^2 + 8 W operations
    res.bound["ntt"] = bound(2 * n_rows * n_cols * L * 4,
                             n_rows * (n_cols // 2) * (n_cols.bit_length() - 1 - skip)
                             * (4 * W * W + 8 * W))
    msg_blocks = -(-(32 + n_rows * spec.repr_bytes) // 64)
    chunks = -(-(32 + n_rows * spec.repr_bytes) // 1024)
    res.bound["blake3_leaves"] = bound(n_rows * n_cols * L * 4 + n_cols * 32,
                                       n_cols * (msg_blocks + chunks - 1) * BLAKE3_OPS)
    res.bound["blake3_parents"] = bound(3 * n_cols * 32, (n_cols - 1) * BLAKE3_OPS)
    res.bound["collapse"] = bound((n_rows * n_per_row + 2 * n_rows + 2 * n_per_row) * L * 4,
                                  2 * n_rows * n_per_row * W * W * 2)
    timed_pair(res, "ntt", lambda: ntt.ntt(padded, spec, n_per_row, enc.tables(dev)),
               lambda: ntt.ntt_plain(padded, spec, n_per_row, enc.tables(dev)),
               f"({n_rows}, {n_cols}, 16) n_nonzero={n_per_row}", card, plain_runs=1)
    timed_pair(res, "blake3_leaves", lambda: blake3.hash_columns(comm.comm, spec),
               lambda: blake3.hash_columns_plain(comm.comm, spec),
               f"({n_rows}, {n_cols}, 16) -> ({n_cols}, 8)", card, plain_runs=1)
    timed_pair(res, "blake3_parents", lambda: merkle_array(leaves, blake3.merkle_parents),
               lambda: merkle_array(leaves, blake3.merkle_parents_plain),
               f"all {n_cols.bit_length() - 1} layers over {n_cols} leaves", card, plain_runs=1)
    timed_pair(res, "collapse", lambda: collapse.collapse(comm.coeffs, tvec, spec),
               lambda: collapse.collapse_plain(comm.coeffs, tvec, spec),
               f"({n_rows}, {n_per_row}, 16) T=2", card)


def expander_bound(levels, spec) -> tuple[float, str]:
    """Bound of the K5 calls of one encode: each level's x, used table slots
    and counts read once, y written once; 2 W^2 operations a slot product of
    W-word elements (W = L/2), as for the other kernels."""
    L = spec.num_limbs16
    W = L // 2
    nbytes = ops = 0
    for tab, x in levels:
        b, used = x.shape[0], int(tab.counts.sum())
        nbytes += (b * tab.cols + b * tab.rows) * L * 4 + used * (4 + 4 * L) + tab.rows * 4
        ops += b * used * W * W * 2
    return bound(nbytes, ops)


def brakedown_path(res: Results, dev, card: str) -> None:
    """Brakedown SdigCode3 over ft255, seed 0, at 2^21: commit once, prove and
    verify at BD_POINTS points, proof bytes, root against the plain
    versions'; launch counts; timings."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, commit, prove,
                                                 serialize_proof, verify)
    from lcpc_proof_of_storage_tpu_torch.fields import FT255, limbs_to_ints
    from lcpc_proof_of_storage_tpu_torch.ops import expander as ex

    spec = FT255
    p = spec.modulus
    length = 1 << BD_LOG2
    t0 = time.perf_counter()
    enc = BrakedownEncoding.new(length, seed=0, field=spec)
    t_gen = time.perf_counter() - t0
    dims = enc.get_dims(length)
    if dims != BD_DIMS:
        raise AssertionError(f"Brakedown 2^{BD_LOG2} dims {dims}, not {BD_DIMS}")
    n_rows, n_per_row, n_cols = dims
    say(f"brakedown: SdigCode3 {spec.name} seed 0, 2^{BD_LOG2} coefficients, dims "
        f"{dims}, {enc.get_n_degree_tests()} degree test(s), {enc.get_n_col_opens()} column "
        f"openings, matgen + tables {t_gen:.2f} s on the host")
    rng = np.random.default_rng(SEED + 21)
    coeffs_np = random_limbs(rng, (length,), spec)
    coeffs = torch.from_numpy(coeffs_np).to(dev)
    coeff_ints = limbs_to_ints(coeffs_np)
    points = [int(v) % p for v in rng.integers(1, 1 << 62, size=BD_POINTS)]
    out = {}

    def run():
        comm = out["comm"] = commit(coeffs, enc, device=dev)
        root = out["root"] = comm.get_root().root
        for i, x in enumerate(points):
            outer, inner = point_tensors(x, n_rows, n_per_row, p)
            proof = prove(comm, outer, enc, transcript(root))
            if i == 0:
                out["len"] = len(serialize_proof(proof, spec))
            value = verify(root, outer, inner, proof, enc, transcript(root), device=dev)
            if value != horner(coeff_ints, x, p):
                raise AssertionError(f"verify returned a wrong evaluation at x={x}")

    launches = launches_of(run)
    comm, root = out["comm"], out["root"]
    say(f"brakedown: root {root.hex()}; {BD_POINTS} proofs verified with the evaluations "
        f"computed on the host; proof {out['len']} bytes; launches {launches}")
    if out["len"] != BD_PROOF_LEN:
        raise AssertionError(f"proof of {out['len']} bytes, the reference's is {BD_PROOF_LEN}")
    n_levels = len(enc.encoder.pre) + len(enc.encoder.post)
    # one encode in the commit and one in each verify
    if launches["expander"] != n_levels * (1 + BD_POINTS):
        raise AssertionError(f"{launches['expander']} expander launches, expected "
                             f"{n_levels} per encode")
    missing = [k for k in ("expander", "blake3_leaves", "blake3_parents", "collapse")
               if launches[k] == 0]
    if missing or launches["ntt"]:
        raise AssertionError(f"Brakedown path kernels: never launched {missing}, "
                             f"ntt {launches['ntt']}")
    res.add_launches(f"brakedown_2^{BD_LOG2}", launches)

    x_in = comm.coeffs.contiguous()
    want = plain_root(enc.encoder.encode(x_in, matvec=ex.gather_matvec_plain), n_cols, spec)
    if want != root:
        raise AssertionError(f"root {root.hex()} differs from the plain versions' {want.hex()}")
    say("brakedown: root equals the root the plain versions compute on the card")

    outer, inner = point_tensors(points[0], n_rows, n_per_row, p)
    proof = prove(comm, outer, enc, transcript(root))
    t_commit = cuda_ms(lambda: commit(coeffs, enc, device=dev))
    t_prove = cuda_ms(lambda: prove(comm, outer, enc, transcript(root)))
    t_verify = cuda_ms(lambda: verify(root, outer, inner, proof, enc, transcript(root),
                                      device=dev))
    t_encode = cuda_ms(lambda: enc.encoder.encode(x_in))
    say(f"time [{card}]: brakedown commit {t_commit:.3f} ms, prove {t_prove:.3f} ms, "
        f"verify {t_verify:.3f} ms, encode {t_encode:.3f} ms at 2^{BD_LOG2} {spec.name} "
        f"(medians of {N_TIMED})")

    levels = []

    def capture(tab, xin, field):
        levels.append((tab, xin))
        return ex.gather_matvec(tab, xin, field)

    enc.encoder.encode(x_in, matvec=capture)
    res.bound["expander"] = expander_bound(levels, spec)
    timed_pair(res, "expander",
               lambda: [ex.gather_matvec(t, x, spec) for t, x in levels],
               lambda: [ex.gather_matvec_plain(t, x, spec) for t, x in levels],
               f"the {len(levels)} levels of one 2^{BD_LOG2} encode (b={n_rows})", card,
               plain_runs=1)


def brakedown_big(res: Results, dev, card: str) -> None:
    """One Brakedown commit, prove and verify at 2^25 ft255 SdigCode3 seed 0,
    with the launch counts set to 0 just before and read just after; the
    evaluation is computed with plain limb arithmetic on the card."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, commit, prove,
                                                 serialize_proof, verify)
    from lcpc_proof_of_storage_tpu_torch.fields import FT255, limbs_to_ints
    from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field

    spec = FT255
    p = spec.modulus
    length = 1 << BD_LOG2_BIG
    t0 = time.perf_counter()
    enc = BrakedownEncoding.new(length, seed=0, field=spec)
    t_gen = time.perf_counter() - t0
    n_rows, n_per_row, n_cols = enc.get_dims(length)
    if (n_rows, n_per_row) != BD_DIMS_BIG:
        raise AssertionError(f"Brakedown 2^{BD_LOG2_BIG} dims {(n_rows, n_per_row)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 25)
    coeffs = random_limbs_device(gen, (length,), spec, dev)
    x = 0x1234567890ABCDEF
    outer, inner = point_tensors(x, n_rows, n_per_row, p)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    commit(coeffs, enc, device=dev)         # the first copies the tables to the card
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    out = {}

    def run():
        t0 = time.perf_counter()
        comm = out["comm"] = commit(coeffs, enc, device=dev)
        root = out["root"] = comm.get_root().root
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        proof = prove(comm, outer, enc, transcript(root))
        t2 = time.perf_counter()
        out["len"] = len(serialize_proof(proof, spec))
        t3 = time.perf_counter()
        out["value"] = verify(root, outer, inner, proof, enc, transcript(root), device=dev)
        torch.cuda.synchronize()
        out["t"] = (t0, t1, t2, t3, time.perf_counter())

    launches = launches_of(run)
    comm, root, blob_len, value = out["comm"], out["root"], out["len"], out["value"]
    t0, t1, t2, t3, t4 = out["t"]
    n_levels = len(enc.encoder.pre) + len(enc.encoder.post)
    missing = [k for k in ("blake3_leaves", "blake3_parents", "collapse") if launches[k] == 0]
    # one encode in the commit and one in the verify
    if launches["expander"] != n_levels * 2 or missing or launches["ntt"]:
        raise AssertionError(f"Brakedown 2^{BD_LOG2_BIG} launches {launches}: expected "
                             f"{n_levels * 2} expander, some of each of {missing}, no ntt")
    res.add_launches(f"brakedown_2^{BD_LOG2_BIG}", launches)

    lf = limb_field(spec)
    inner_t = lf.array(inner, dev)
    row_evals = torch.cat([lf.dot(comm.coeffs[i:i + 8], inner_t[None], axis=1)
                           for i in range(0, n_rows, 8)])
    want = sum(o * r for o, r in zip(outer, limbs_to_ints(row_evals.cpu().numpy()))) % p
    say(f"brakedown 2^{BD_LOG2_BIG}: dims ({n_rows}, {n_per_row}, {n_cols}), matgen + tables "
        f"{t_gen:.2f} s; root {root.hex()}; proof {blob_len} bytes; verify returned "
        f"{'the' if value == want else 'a WRONG'} evaluation; launches {launches}")
    if blob_len != BD_PROOF_LEN_BIG:
        raise AssertionError(f"proof of {blob_len} bytes, the reference's is {BD_PROOF_LEN_BIG}")
    if value != want:
        raise AssertionError("verify at 2^25 returned a wrong evaluation")
    say(f"time [{card}]: brakedown 2^{BD_LOG2_BIG} commit {(t1 - t0) * 1e3:.1f} ms (the "
        f"first, with the tables' copy to the card, {t_first * 1e3:.1f} ms), prove "
        f"{(t2 - t1) * 1e3:.1f} ms, serialize {(t3 - t2) * 1e3:.1f} ms, verify "
        f"{(t4 - t3) * 1e3:.1f} ms (one run each); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


KERNEL_INFO = {
    "ntt": ("lcpc_proof_of_storage_tpu_torch/csrc/ntt.cu",
            "lcpc_proof_of_storage_tpu/ops/ntt_pallas3.py:546"),
    "blake3_leaves": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                      "lcpc_proof_of_storage_tpu/ops/blake3_pallas.py:139"),
    "blake3_parents": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                       "lcpc_proof_of_storage_tpu/ops/blake3_jax.py:325"),
    "collapse": ("lcpc_proof_of_storage_tpu_torch/csrc/collapse.cu",
                 "lcpc_proof_of_storage_tpu/ops/collapse_pallas.py:279"),
    "expander": ("lcpc_proof_of_storage_tpu_torch/csrc/expander.cu",
                 "lcpc_proof_of_storage_tpu/ops/expander_pallas.py:388"),
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
        from lcpc_proof_of_storage_tpu_torch import kernels, native
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    say(f"card: {card}")
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    say(f"build: csrc/*.cu -> {so} in {time.perf_counter() - t0:.1f} s")
    for line in (so.parent / "nvcc.log").read_text().splitlines():
        if ("expander_matvec" in line or "Used" in line
                or ("spill" in line and "0 bytes spill stores" not in line)):
            say(f"build: {line.strip()}")
    t0 = time.perf_counter()
    say(f"host library: {'built' if native.native() is not None else 'NOT built: Python fallbacks'}"
        f" in {time.perf_counter() - t0:.1f} s")

    res = Results()
    check_kernels(res, dev)
    check_expander(res, dev)
    check_golden(dev)
    check_verify(dev)
    ligero_path(res, dev, card)
    brakedown_path(res, dev, card)
    brakedown_big(res, dev, card)
    say(f"total {time.perf_counter() - t_start:.1f} s")

    say(card)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(res.launches[name].values()),
         "launches_by_path": res.launches[name], "max_abs_err": res.err[name],
         "ms": res.ms[name], "plain_ms": res.plain_ms[name], "bound_ms": res.bound[name][0],
         "bound_by": res.bound[name][1], "library_ms": None}
        for name, (src, rep) in KERNEL_INFO.items()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
