#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (lcpc_proof_of_storage_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one or more lines each: environment; kernel build from csrc/ (one
nvcc per source, in parallel; ptxas's registers and spills of K1's pass
kernel, K5 and the collapse); each hand-written kernel against its plain
PyTorch version on the card (bit-exact), K2's leaves on eleven shapes (two
with more chunks a message than a leaves block has threads) and its Merkle
tree at 2^1, 2^11, 2^15 and 2^20 leaves, K1 and K4's inverse at the edges
of their pass plan (n = 2^10, 2^11, 2^20, 2^21; one, two, two and three
passes) on five fields, K5 on every field, on a level of
3000 slots, on a ragged row count and on all 12 levels of a 2^21 encode;
KT (ntt_tile) and KM (mul_mod) on five fields, the four_step and
fused_small NTT routes against K1 up to n = 2^20 and the fused_small
inverse against K4's; the Ligero and Brakedown golden pins of
tests/golden_vectors.json with every tensor on CUDA; verify's placement;
the Ligero path (rho=1/4, ft255, 2^20: one commit, prove + verify at three
points) on each NTT route, with equal roots and proof bytes, the
fused_small decode against K4's, every KT and KM launch the routes make on
the commit's (128, 32768, 16) input held against its plain version on the
same inputs, and KT, KM and the routes timed beside K1 there; the
Brakedown path (SdigCode3,
ft255, seed 0, 2^21: one commit, prove + verify at two points, proof bytes,
root against the plain versions', the streamed root); one Brakedown commit,
prove and verify at 2^25, and its streamed commit and proof; K5, K3 and
K3p at every shape their paths give them (the 2^21 encode at b = 18, the
2^25 encode at b = 143, 32 and 2, the collapses of the Ligero 2^20 and
Brakedown 2^21 and 2^25 proves, a 2^29 prove batch and a PoS left-multiply
batch) against their plain versions and timed, with K5's slot use; K2's
leaves at the Ligero 2^20, Brakedown 2^25 and 2^21 commits' and a verify's
shapes and the tree step over 2^15 and 2^20 leaves, timed, with the Ligero
2^20 and Brakedown 2^21 commits (a phase that times an older checkout's
package too, put first on sys.path); the streamed
kernels (K3p on five fields, chunk CVs and merge on three) against their
plain versions and the synthetic pin of tests/test_torch_streamed.py on
CUDA; the streamed Ligero ft255 path at 2^25 in all six keep_comm x
device_coeffs modes against the one-shot root and proof bytes, at 2^28
with 16-bit coefficients and encoded matrix on the card, and at 2^29 with
the coefficients in host memory and no encoded matrix kept (commit, prove,
serialize, verify, a tampered proof, the proof length, the synthetic
root, a second commit on the four_step route to the same root, every KT
and KM launch of the routes on one (32, 2^20, 16) commit batch held
against its plain version on two of its rows, KT and the routes timed
there); at each of those three sizes K1
against its plain version at that path's n (2^18, 2^19, 2^20); K4's
inverse entry against its plain version on five fields at n = 2^4 .. 2^20
and K1 at the PoS sizes; the
proof-of-storage lifecycle (an in-process server and client on the card)
on a 16 MiB file against the CPU writer's files, and on a 1 GiB file
(chunked upload, proof, evaluation, row, edit, append, a corrupted
.porenc) with a 256 MiB whole upload and download, and on the 16 MiB
file's copy the row and column API (a row replaced by its bytes, the
recalculated tree against a fresh writer's and the one-shot commit's, the
handler's digests and the retrieved columns against it); the generic host
digest (phase digest: commit, prove and verify with Blake2b at Ligero
2^20 and Brakedown 2^21, the root against hashlib.blake2b over the Blake3
commit's encoded matrix, the host legs timed); the multi-device paths
(phase mesh: legs a-g of __graft_entry__.dryrun_multichip at those two
full-width points on meshes of 3, 4 and 8 shards on one card, plus one
shard a card where there are several: roots and proof bytes against the
one-device path's, each kernel a shard launches held against its plain
version on that shard's inputs, launches per leg); timings, peak device
memory and host RSS; one more prove and verify of the Ligero 2^20,
Brakedown 2^25 and streamed Ligero 2^29 paths with LCPC_PROFILE_PROTO=1,
each leg's ms from the phase spans of utils/profiling.py (failing where the
legs cover less than 90% of a call).  Every bound and timer is
utils/profiling.py's (KernelCost.bound_ms, bench_kernel, wall_ms,
device_ms).  ``--phases digest,mesh`` runs only the phases named.
Each path runs with every kernel's launch count set to 0 just before it
and read just after, and fails if a Merkle array took more than two tree
launches.  ntt_tile_kernels, not a phase, times KT and KM at the routes'
shapes for whichever package is first on sys.path (a parent beside a
change).  The script prints a JSON line of per-kernel results
and, last, {"ok": true, "device": {...}}.  Any failure exits non-zero
without that line, as does a machine with no CUDA device or a directory
without the port.  It imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG2_MAIN = 20
N_POINTS = 3
N_TIMED = 3
SEED = 20261016
BD_LOG2 = 21
BD_POINTS = 2
BD_DIMS = (18, 117587, 178850)
BD_PROOF_LEN = 16175624
BD_LOG2_BIG = 25
BD_DIMS_BIG = (143, 235172)
BD_PROOF_LEN_BIG = 50336784
ST_LOG2 = 29              # the streamed tentpole: Ligero rho=1/4 ft255, host coefficients
ST_DIMS = (2048, 262144, 1048576)
ST_LOG2_DEVICE = 28       # 16-bit coefficients and encoded matrix on the card
ST_LOG2_MODES = 25        # every keep_comm x device_coeffs mode against the one-shot path
ST_MODES_BATCH = 100      # rows a batch: does not divide the 512 rows at 2^25


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


def plan_text(n: int) -> str:
    """K1's and K4's pass plan at n, as ops/ntt.py ntt_pass_plan gives it."""
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    plan = ntt.ntt_pass_plan(n)
    return (f"{len(plan)} pass{'es' if len(plan) > 1 else ''}, stages "
            + " ".join(f"{lo}..{hi - 1}" for lo, hi in plan))


def timed_pair(res: Results, name: str, kern, plain, shape: str, card: str,
               plain_runs: int = 2) -> None:
    """Kernel and plain version in turns (plain, kernel, kernel, plain), CUDA
    event times."""
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import bench_kernel
    p1 = bench_kernel(plain, plain_runs)
    k1 = bench_kernel(kern)
    k2 = bench_kernel(kern)
    p2 = bench_kernel(plain, plain_runs)
    res.ms[name] = min(k1, k2)
    res.plain_ms[name] = min(p1, p2)
    b, by = res.bound[name]
    say(f"time [{card}]: {name} {shape}: kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.3f}/{p2:.3f} ms, bound {b:.4f} ms ({by})")


def tree_of(leaves):
    """The Merkle array over power-of-two leaves, filled by the kernel."""
    from lcpc_proof_of_storage_tpu_torch.ops import blake3
    hashes = blake3.merkle_array(leaves.shape[0], leaves.device)
    hashes[:leaves.shape[0]] = leaves
    return blake3.merkle_tree(hashes)


def tree_plain_of(leaves):
    """The same Merkle array, layer by layer with the plain parents."""
    from lcpc_proof_of_storage_tpu_torch.ops import blake3
    hashes = blake3.merkle_array(leaves.shape[0], leaves.device)
    hashes[:leaves.shape[0]] = leaves
    return blake3.merkle_tree_plain(hashes)


def horner(coeff_ints: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeff_ints):
        acc = (acc * x + c) % p
    return acc


def launches_of(run) -> dict[str, int]:
    """Every kernel's launches in run(), counted from 0.  Fails if a Merkle
    array took more than two tree launches (none is wider than 2^20 leaves)."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in kernels.KERNELS.items()}
    if counts["blake3_tree"] > 2 * kernels.BLAKE3_TREE.arrays:
        raise AssertionError(f"{counts['blake3_tree']} tree launches for "
                             f"{kernels.BLAKE3_TREE.arrays} Merkle arrays")
    return counts


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def leg_report(card: str, what: str, spec, blob: bytes, prove_fn, verify_fn) -> int:
    """One more prove (prove_fn()) and verify (verify_fn(proof)) of a path
    with LCPC_PROFILE_PROTO=1, which ends each device leg with a sync: each
    leg's ms from the phase spans of utils/profiling.py, and the legs' sum
    against the call's synchronised wall time.  Fails where the proof's
    bytes differ from `blob` or the legs cover less than 90% of a call.
    Returns the evaluation verify gives."""
    import os
    import torch
    from lcpc_proof_of_storage_tpu_torch import serialize_proof
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import GLOBAL_PHASES

    out = {}
    before_env = os.environ.get("LCPC_PROFILE_PROTO")
    os.environ["LCPC_PROFILE_PROTO"] = "1"
    try:
        for actor, run in (("prove", lambda: out.__setitem__("proof", prove_fn())),
                           ("verify", lambda: out.__setitem__("value",
                                                              verify_fn(out["proof"])))):
            before = {k: v for k, v in GLOBAL_PHASES.totals.items() if k[0] == actor}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            legs = {b: (t - before.get((a, b), 0.0)) * 1e3
                    for (a, b), t in GLOBAL_PHASES.totals.items() if a == actor}
            legs = {b: ms for b, ms in legs.items() if ms > 0}
            share = sum(legs.values()) / wall
            say(f"legs [{card}]: {what} {actor} (LCPC_PROFILE_PROTO=1): "
                + ", ".join(f"{b} {ms:.3f}" for b, ms in legs.items())
                + f" ms; the legs {sum(legs.values()):.3f} of {wall:.3f} ms wall ({share:.1%})")
            if share < 0.9:
                raise AssertionError(f"{what} {actor}: the phase spans cover {share:.1%} of the "
                                     f"call")
    finally:
        if before_env is None:
            del os.environ["LCPC_PROFILE_PROTO"]
        else:
            os.environ["LCPC_PROFILE_PROTO"] = before_env
    if serialize_proof(out["proof"], spec) != blob:
        raise AssertionError(f"{what}: the proof under LCPC_PROFILE_PROTO=1 differs")
    return out["value"]


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

    # the last two: more chunks a message than a leaves block has threads
    # (258 in aligned pairs; 235 one a thread, one column a block)
    for spec, rows, cols in ((FT255, 128, 1024), (FT63, 1, 300), (FT255, 128, 189),
                             (FT253_192, 40, 100), (FT63, 300, 77), (FT127, 128, 189),
                             (FT191, 70, 300), (FT255, 18, 4099), (FT255, 143, 300),
                             (FT63, 33000, 67), (FT191, 10000, 5)):
        m = torch.from_numpy(random_limbs(rng, (rows, cols), spec)).to(dev)
        plan = blake3.leaf_plan(rows, spec.repr_bytes)
        res.compare("blake3_leaves", f"{spec.name} rows={rows} cols={cols} ({plan.nchunks} "
                    f"chunks a column, {plan.group} a thread, {plan.cols} columns a block)",
                    blake3.hash_columns(m, spec), blake3.hash_columns_plain(m, spec))
    for log2 in (1, 11, 15, 20):
        leaves = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(1 << log2, 8),
                                               dtype=np.int64).astype(np.int32)).to(dev)
        out = {}
        launches = launches_of(lambda: out.update(tree=tree_of(leaves)))
        res.compare("blake3_tree", f"Merkle tree over 2^{log2} leaves ({log2} layers, "
                    f"{launches['blake3_tree']} launches)", out["tree"], tree_plain_of(leaves))
        if launches["blake3_tree"] != len(blake3.tree_plan(1 << log2)):
            raise AssertionError(f"the tree over 2^{log2} leaves: launches {launches}")

    # the row warps of collapse_plan: 8 (Ligero 2^20, few columns, T past the
    # tensor tile), 4, 2 and 1 (many columns) on every field
    for spec, rows, npr, T in ((FT255, 128, 8192, 2), (FT63, 3000, 512, 2),
                               (FT255, 2500, 64, 1), (FT127, 128, 1024, 2),
                               (FT191, 2100, 256, 2), (FT255, 18, 4099, 2),
                               (FT255, 1000, 40, 5), (FT63, 37, 100, 9), (FT191, 20, 3000, 3),
                               (FT127, 9, 70, 1), (FT253_192, 70, 200, 2),
                               (FT63, 16, 140000, 1), (FT191, 12, 140001, 2),
                               (FT127, 40, 300000, 5)):
        c = torch.from_numpy(random_limbs(rng, (rows, npr), spec)).to(dev)
        t = torch.from_numpy(random_limbs(rng, (T, rows), spec)).to(dev)
        res.compare("collapse", f"{spec.name} rows={rows} npr={npr} T={T} (row warps "
                    f"{collapse.collapse_plan(rows, npr, T, spec.num_limbs16).row_warps})",
                    collapse.collapse(c, t, spec), collapse.collapse_plain(c, t, spec))
    check_ntt_passes(res, dev)


def check_ntt_passes(res: Results, dev) -> None:
    """K1 against ntt_plain and K4's inverse against intt_plain at the edges
    of their pass plan, bit-exact, on five fields (W = 2, 4, 6, 8): n = 2^10
    (one pass, several rows a block), 2^11 (two), 2^20 (two of ten stages)
    and 2^21 (three), with a ragged n_nonzero for K1; and K1's entry on rows
    as stored (ntt_rows), int32 and 16-bit rows of a ragged width between
    n_nonzero and n, with and without its 16-bit output, against the same
    plain transform (the values past n_nonzero are read as zero either way)."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
    from lcpc_proof_of_storage_tpu_torch.fields.limb import narrow_limbs
    from lcpc_proof_of_storage_tpu_torch.ops import ntt

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    for log_n in (ntt.K_MAX, ntt.K_MAX + 1, 20, 21):
        n = 1 << log_n
        batch = 3 if log_n < 20 else 1
        nnz = n * 3 // 8 + 5
        width = n * 5 // 8 + 3
        for spec in (FT63, FT127, FT191, FT255, FT253_192):
            tables = ntt.NttTables(spec, n).to(dev)
            x = random_limbs_device(gen, (batch, n), spec, dev)
            want = ntt.ntt_plain(x, spec, nnz, tables)
            res.compare("ntt", f"{spec.name} batch={batch} n=2^{log_n} n_nonzero={nnz}",
                        ntt.ntt(x, spec, nnz, tables), want, quiet=True)
            rows = x[:, :width].contiguous()
            for r in (rows, narrow_limbs(rows)):
                what = (f"{spec.name} {r.dtype} rows of {width}, batch={batch} n=2^{log_n} "
                        f"n_nonzero={nnz}")
                out16 = torch.empty(want.shape, dtype=torch.int16, device=dev)
                res.compare("ntt", what, ntt.ntt_rows(r, spec, n, nnz, tables, out16=out16),
                            want, quiet=True)
                res.compare("ntt", f"{what}: its 16-bit output", out16, narrow_limbs(want),
                            quiet=True)
                res.compare("ntt", f"{what}, no 16-bit output",
                            ntt.ntt_rows(r, spec, n, nnz, tables), want, quiet=True)
            res.compare("ntt_inverse", f"{spec.name} batch={batch} n=2^{log_n}",
                        ntt.intt(x, spec, tables), ntt.intt_plain(x, spec, tables), quiet=True)
            del x, tables, want, rows, out16
            free_device(dev)
        say(f"kernel ntt and ntt_inverse at n=2^{log_n} ({plan_text(n)}), batch {batch}, "
            f"n_nonzero {nnz} for the forward, five fields: bit-exact against plain; ntt_rows "
            f"on int32 and 16-bit rows of {width}, with and without the 16-bit output: "
            f"bit-exact against the same plain transform")


def check_expander(res: Results, dev) -> None:
    """K5 against gather_matvec_plain on the card, bit-exact: every field on
    the levels of an n = 3000 code at b in {1, 3, 9, 18, 33} (past the
    kernel's batch tile, ops/expander.py b_tile, and ragged: two batch rows a
    thread from 32 on at W >= 6); a synthetic ft255
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
        for b in (1, 3, 9, 18, 33):
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
# the NTT routes: KT (ntt_tile) and KM (mul_mod)
# --------------------------------------------------------------------------

def check_ntt_route_kernels(res: Results, dev) -> None:
    """KT against ntt_tile_stages_plain and KM against mul_mod_plain on five
    fields, bit-exact: KT on every sub-length 2 .. 1024 with and without the
    four-step's diagonal prologue, in all four pairings of limbs or words in
    and out, forward and inverse, from stage 0 and from a later stage; at
    the fused_small tile (2048) and the largest (4096), forward and inverse;
    and on counts whose last block holds only part of a block's runs
    (ops/ntt.py tile_plan); KM at a ragged N with b_rows = N, 7 and 1.  Then
    both routes against K1 at n = 2^11, 2^15 (n_nonzero 8192 and 100 <= n1),
    2^18 and 2^20 on ft63 and ft255, and the fused_small inverse against K4's
    inverse at n = 2^4 .. 2^20."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
    from lcpc_proof_of_storage_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    for spec in (FT63, FT127, FT191, FT255, FT253_192):
        L = spec.num_limbs16
        W = L // 2
        fs = ntt.NttTables(spec, 1 << 11, "four_step").to(dev)
        x = torch.from_numpy(random_limbs(rng, (2, 1 << 11), spec)).to(dev)
        words = ntt.pack_words(x)
        for s1 in range(1, 11):
            for diag in (False, True):
                for src, out_limbs in ((x, False), (words, True), (x, True), (words, False)):
                    io = (f"{'limbs' if src is x else 'words'} in "
                          f"{'limbs' if out_limbs else 'words'} out")
                    for inverse, s0 in ((False, 0), (True, s1 // 2)):
                        got = ntt.ntt_tile_stages(src, fs, s0, s1, diag=diag, inverse=inverse,
                                                  out_limbs=out_limbs)
                        want = ntt.ntt_tile_stages_plain(src, fs, s0, s1, diag, inverse,
                                                         out_limbs)
                        res.compare("ntt_tile", f"{spec.name} sub-length {1 << s1} of n=2^11, "
                                    f"{io}, stages {s0}.., inverse {inverse}, prologue {diag}",
                                    got, want, quiet=True)
        fu = ntt.NttTables(spec, 1 << 15, "fused_small").to(dev)
        x = random_limbs_device(gen, (3, 1 << 15), spec, dev)
        for log_t in (11, 12):
            for s0, inverse, out_limbs in ((0, False, False), (2, False, False),
                                           (0, True, True)):
                res.compare("ntt_tile", f"{spec.name} tile 2^{log_t} of n=2^15 from stage {s0}, "
                            f"inverse {inverse}",
                            ntt.ntt_tile_stages(x, fu, s0, log_t, inverse=inverse,
                                                out_limbs=out_limbs),
                            ntt.ntt_tile_stages_plain(x, fu, s0, log_t, False, inverse,
                                                      out_limbs), quiet=True)
        partial = []
        for s1 in (1, 7, 9):    # more blocks than the plan's minimum, and 3 runs over
            count = ntt.TILE_MIN_BLOCKS << (10 if W <= 4 else 11)
            count += 3 << s1
            span = 1 << ntt.tile_plan(count, s1, W)
            if count % span == 0:
                raise AssertionError(f"ntt_tile: count {count} fills its last block of {span}")
            xs = random_limbs_device(gen, (count,), spec, dev)
            res.compare("ntt_tile", f"{spec.name} {count} values in runs of 2^{s1}, the last "
                        f"block {count % span} of {span} values",
                        ntt.ntt_tile_stages(xs, fu, s1 // 2, s1, out_limbs=True),
                        ntt.ntt_tile_stages_plain(xs, fu, s1 // 2, s1, out_limbs=True),
                        quiet=True)
            partial.append(f"{count % span}/{span}")
            del xs
        say(f"kernel ntt_tile {spec.name}: sub-lengths 2 .. 1024 with and without the prologue, "
            f"limbs or words in and out, forward and inverse; tiles 2048 and 4096; last blocks "
            f"{', '.join(partial)} full: bit-exact against plain")
        for n, b_rows in ((100_003, 100_003), (100_003, 7), (4099, 1)):
            a = torch.from_numpy(random_limbs(rng, (n,), spec)).to(dev)
            b = torch.from_numpy(random_limbs(rng, (b_rows,), spec)).to(dev)
            res.compare("mul_mod", f"{spec.name} N={n} b_rows={b_rows}", ntt.mul_mod(a, b, spec),
                        ntt.mul_mod_plain(a, b, spec), quiet=True)
        say(f"kernel mul_mod {spec.name}: N = 100003 (b_rows N and 7) and 4099 (one broadcast "
            f"row): bit-exact against plain")
        if spec is FT255:
            time_mul_mod_rows(res, dev, card_line())
        free_device(dev)

    for spec in (FT63, FT255):
        name = spec.name
        for log_n, nnzs in ((11, (None, 700)), (15, (8192, 100)), (18, (None, 1 << 16)),
                            (20, (None, 1 << 18))):
            n = 1 << log_n
            batch = 2 if log_n >= 18 else 4
            fs = ntt.NttTables(spec, n, "four_step").to(dev)
            fu = ntt.NttTables(spec, n, "fused_small").to(dev)
            for nnz in nnzs:
                x = random_limbs_device(gen, (batch, n), spec, dev)
                if nnz is not None:
                    x[:, nnz:] = 0
                want = ntt.ntt(x, spec, nnz, fs)
                res.compare("ntt_tile", f"four_step route against K1, {name} batch={batch} "
                            f"n=2^{log_n} n_nonzero={nnz}", ntt.ntt_four_step(x, spec, nnz, fs),
                            want, quiet=True)
                res.compare("ntt_tile", f"fused_small route against K1, {name} batch={batch} "
                            f"n=2^{log_n} n_nonzero={nnz}", ntt.ntt_fused_small(x, spec, nnz, fu),
                            want, quiet=True)
                del x, want
            del fs, fu
            free_device(dev)
        say(f"ntt routes {name}: four_step and fused_small bit-exact against K1 at n = 2^11 "
            f"(n_nonzero n, 700), 2^15 (8192, 100), 2^18 (n, 2^16), 2^20 (n, 2^18)")
        for log_n in range(4, 21):
            n = 1 << log_n
            fu = ntt.NttTables(spec, n, "fused_small").to(dev)
            x = random_limbs_device(gen, (2, n), spec, dev)
            res.compare("ntt_tile", f"fused_small inverse against K4, {name} n=2^{log_n}",
                        ntt.ntt_fused_small(x, spec, None, fu, inverse=True),
                        ntt.intt(x, spec, fu), quiet=True)
            del x, fu
        free_device(dev)
        say(f"ntt routes {name}: the fused_small inverse bit-exact against K4's inverse at n = "
            f"2^4 .. 2^20")


def time_mul_mod_rows(res: Results, dev, card: str) -> None:
    """KM at mul_mod_pallas's own call, an (N, L) x (N, L) product (b_rows =
    N = 100003, ft255), against plain and timed (two CUDA-event means)."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import bench_kernel, modmul_cost

    spec, n = FT255, 100_003
    L = spec.num_limbs16
    rng = np.random.default_rng(SEED + 6)
    a, b = (torch.from_numpy(random_limbs(rng, (n,), spec)).to(dev) for _ in range(2))
    res.compare("mul_mod", f"{spec.name} N={n} b_rows={n}", ntt.mul_mod(a, b, spec),
                ntt.mul_mod_plain(a, b, spec), quiet=True)
    k = [bench_kernel(lambda: ntt.mul_mod(a, b, spec)) for _ in range(2)]
    p_ms = bench_kernel(lambda: ntt.mul_mod_plain(a, b, spec), 2)
    bd, by = modmul_cost(n, L, n).bound_ms()
    say(f"time [{card}]: mul_mod ({n}, {L}) x ({n}, {L}) {spec.name} (mul_mod_pallas): kernel "
        f"{k[0]:.4f}/{k[1]:.4f} ms, plain {p_ms:.3f} ms, bound {bd:.4f} ms ({by})")


def route_call_label(call, L: int) -> str:
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    if isinstance(call, ntt.MulModCall):
        return f"KM ({call.a.shape[0]}, {L}) x ({call.b.shape[0]}, {L})"
    io = "limbs" if call.x.shape[-1] == L else "words"
    return (f"KT stages {call.s0}..{call.s1 - 1}{' after the diagonal twiddle' if call.diag else ''}"
            f"{' with w^-j' if call.inverse else ''} over {tuple(call.x.shape)} {io}")


def time_k1_passes(card: str, spec, x, nnz: int, what: str, tables) -> None:
    """K1's passes apart, CUDA-event means on words of x: the last pass alone
    (lcpc_ntt_stages from its first stage), the rest of K1 by difference; and
    K1's stages from the fused_small tile on (the route's _stage_call), beside
    ntt_cost of those stages."""
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import bench_kernel, ntt_cost
    batch, n, L = x.shape
    plan = ntt.ntt_pass_plan(n)
    words = ntt.pack_words(x)
    whole = min(bench_kernel(lambda: ntt.ntt(x, spec, nnz, tables)) for _ in range(2))
    parts = [f"K1 {whole:.4f} ms"]
    if len(plan) > 1:
        s_last = plan[-1][0]
        last = min(bench_kernel(lambda: ntt.ntt_stages(words, tables, s_last)) for _ in range(2))
        b, by = ntt_cost(batch, n, L, n.bit_length() - 1 - s_last).bound_ms()
        parts.append(f"last pass (stages {s_last}..{n.bit_length() - 2}) alone {last:.4f} ms "
                     f"(bound {b:.4f}, {by}), the rest {whole - last:.4f} ms")
    log_t = min(ntt.FUSED_TILE, n).bit_length() - 1
    if log_t < n.bit_length() - 1:
        st = min(bench_kernel(lambda: ntt.ntt_stages(words, tables, log_t)) for _ in range(2))
        b, by = ntt_cost(batch, n, L, n.bit_length() - 1 - log_t).bound_ms()
        parts.append(f"stages {log_t}.. (fused_small's _stage_call) {st:.4f} ms, bound "
                     f"{b:.4f} ms ({by})")
    say(f"time [{card}]: K1 passes {what} ({batch}, {n}, {L}) {spec.name}: " + "; ".join(parts))


def time_ntt_routes(res: Results, card: str, spec, x, nnz: int, what: str,
                    record: bool = False, check_rows: int | None = None) -> None:
    """At one path's (batch, n, L) input x (zero past nnz): every KT and KM
    call that the four_step route, the fused_small route and the fused_small
    inverse (of K1's output) make, as the routes record them, held against
    its plain version on the same inputs (on the first `check_rows` rows of
    the batch; all by default) and timed (CUDA-event means) beside its
    bound; then K1, the two routes, K4's inverse and the fused_small inverse
    timed in turns.  With `record`, KT's four-step pass B and KM are the
    kernel line's times, each with its plain version's (in turns)."""
    import dataclasses
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import bench_kernel, ntt_cost
    batch, n, L = x.shape
    dev = x.device
    rows = batch if check_rows is None else check_rows
    fs = ntt.NttTables(spec, n, "four_step").to(dev)
    fu = ntt.NttTables(spec, n, "fused_small").to(dev)
    y = ntt.ntt(x, spec, nnz, fs)
    calls = {"four_step": [], "fused_small": [], "fused_small inverse": []}
    res.compare("ntt_tile", f"{what} four_step route against K1",
                ntt.ntt_four_step(x, spec, nnz, fs, calls=calls["four_step"]), y, quiet=True)
    res.compare("ntt_tile", f"{what} fused_small route against K1",
                ntt.ntt_fused_small(x, spec, nnz, fu, calls=calls["fused_small"]), y, quiet=True)
    res.compare("mul_mod", f"{what} fused_small inverse against K4's",
                ntt.ntt_fused_small(y, spec, None, fu, inverse=True,
                                    calls=calls["fused_small inverse"]),
                ntt.intt(y, spec, fu), quiet=True)
    for route, route_calls in calls.items():
        for call in route_calls:
            is_km = isinstance(call, ntt.MulModCall)
            name, label = ("mul_mod" if is_km else "ntt_tile"), route_call_label(call, L)
            part = (dataclasses.replace(call, a=call.a[:rows * n]) if is_km
                    else dataclasses.replace(call, x=call.x[:rows]))
            res.compare(name, f"{what} {route} {label}, rows 0..{rows - 1}",
                        call()[:rows * n if is_km else rows], part.plain())
            b, by = call.cost().bound_ms()
            k = [bench_kernel(call) for _ in range(2)]
            say(f"time [{card}]: {name} {what} {route} {label}: kernel {k[0]:.4f}/{k[1]:.4f} ms, "
                f"bound {b:.4f} ms ({by})")
    routes = {"K1 (stages)": lambda: ntt.ntt(x, spec, nnz, fs),
              "four_step": lambda: ntt.ntt_four_step(x, spec, nnz, fs),
              "fused_small": lambda: ntt.ntt_fused_small(x, spec, nnz, fu)}
    b, by = ntt_cost(batch, n, L, (nnz - 1).bit_length()).bound_ms()    # the stages not pruned
    times = {name: [bench_kernel(fn)] for name, fn in routes.items()}
    for name, fn in reversed(routes.items()):
        times[name].append(bench_kernel(fn))
    say(f"time [{card}]: NTT {what} ({batch}, {n}, {L}) {spec.name} n_nonzero={nnz}: "
        + ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items())
        + f" (in turns); bound {b:.4f} ms ({by}); K1 {plan_text(n)}")
    time_k1_passes(card, spec, x, nnz, what, fs)
    if record:
        pass_b = next(c for c in calls["four_step"] if c.diag)
        km = next(c for c in calls["fused_small inverse"] if isinstance(c, ntt.MulModCall))
        for name, call in (("ntt_tile", pass_b), ("mul_mod", km)):
            res.bound[name] = call.cost().bound_ms()
            timed_pair(res, name, call, call.plain,
                       f"{what} {route_call_label(call, L)}", card, plain_runs=1)
        count, s = km.a.shape[0], res.ms["mul_mod"] / 1e3
        say(f"memory probe [{card}]: KM's {count} values ({2 * count * L * 4 / 1e6:.1f} MB of "
            f"limbs in and out, one Montgomery product a value) in {res.ms['mul_mod']:.4f} ms: "
            f"{2 * count * L * 4 / s / 1e12:.3f} TB/s")
    inv = {"K4 inverse": lambda: ntt.intt(y, spec, fu),
           "fused_small inverse": lambda: ntt.ntt_fused_small(y, spec, None, fu, inverse=True)}
    t_inv = {name: [bench_kernel(fn, 5)] for name, fn in inv.items()}
    for name, fn in reversed(inv.items()):
        t_inv[name].append(bench_kernel(fn, 5))
    say(f"time [{card}]: inverse NTT {what} ({batch}, {n}, {L}) {spec.name}: "
        + ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms" for name, ts in t_inv.items())
        + " (in turns)")


def ntt_tile_kernels(res: Results, dev, card: str) -> None:
    """KT and KM at every shape the routes give them, as time_ntt_routes runs
    them (each call against its plain version, bit-exact, and timed beside
    its bound; K1, the routes and the inverses in turns): the Ligero 2^20
    commit's (128, 32768, 16) ft255 input, n_nonzero 8192, every row
    checked, and a (32, 2^20, 16) batch of the 2^29 commit, n_nonzero 2^18,
    two rows checked; KM at (100003, 16) x (100003, 16); then one seeded
    Ligero 2^20 commit on each route (medians of 10), to one root.  Not a
    phase of main(): the ligero and streamed_host phases time the same calls
    on their own data.  It uses only the package's public entries, so with
    an older checkout's package first on sys.path (put there after this
    script is imported, as chip_smoke imports the package only inside its
    functions) it times that one, e.g. a `git archive` of the parent commit
    unpacked into build/parent:

        python3 -c "import sys, torch, chip_smoke as c; sys.path.insert(0, 'build/parent');
                    c.ntt_tile_kernels(c.Results(), torch.device('cuda', 0), c.card_line())"
    """
    import torch
    from lcpc_proof_of_storage_tpu_torch import LigeroEncoding, commit
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import wall_ms

    say(f"ntt_tile_kernels: the package at {Path(ntt.__file__).parents[2]}")
    spec = FT255
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 28)
    for shape, nnz, what, rows in (
            ((128, 1 << 15), 1 << 13, f"the Ligero 2^{LOG2_MAIN} commit's input", None),
            ((32, 1 << 20), 1 << 18, f"a 2^{ST_LOG2} commit batch", 2)):
        x = random_limbs_device(gen, shape, spec, dev)
        x[:, nnz:] = 0
        time_ntt_routes(res, card, spec, x, nnz, what, check_rows=rows)
        del x
        free_device(dev)
    time_mul_mod_rows(res, dev, card)
    coeffs = random_limbs_device(gen, (1 << LOG2_MAIN,), spec, dev)
    roots = set()
    for route in ntt.ROUTES:
        enc = LigeroEncoding.new(1 << LOG2_MAIN, spec, rho=(1, 4), ntt=route)
        roots.add(commit(coeffs, enc, device=dev).get_root().root)
        t = [wall_ms(lambda: commit(coeffs, enc, device=dev), runs=10) for _ in range(2)]
        say(f"time [{card}]: ntt_tile_kernels Ligero 2^{LOG2_MAIN} commit on {route}: "
            f"{t[0]:.3f}/{t[1]:.3f} ms (medians of 10)")
        del enc
        free_device(dev)
    if len(roots) != 1:
        raise AssertionError(f"the routes' Ligero 2^{LOG2_MAIN} roots differ")
    say(f"ntt_tile_kernels: Ligero 2^{LOG2_MAIN} root {roots.pop().hex()} on every route")


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
    from lcpc_proof_of_storage_tpu_torch.ops import blake3
    hashes = blake3.merkle_array(n_cols, comm_plain.device)
    hashes[:n_cols] = blake3.hash_columns_plain(comm_plain, spec)
    torch.cuda.empty_cache()
    return blake3.digest_to_bytes(blake3.merkle_tree_plain(hashes)[-1])


def transcript(root: bytes):
    from lcpc_proof_of_storage_tpu_torch import Transcript
    tr = Transcript(b"chip_smoke")
    tr.append_message(b"polycommit", root)
    return tr


def point_tensors(x: int, n_rows: int, n_per_row: int, p: int):
    xr = pow(x, n_per_row, p)
    return [pow(xr, i, p) for i in range(n_rows)], [pow(x, j, p) for j in range(n_per_row)]


def ligero_path(res: Results, dev, card: str) -> None:
    """Ligero rho=1/4 over ft255 at 2^20 on each NTT route (stages, then
    four_step and fused_small): commit once, prove and verify at N_POINTS
    points, the fused_small route's decode of the committed rows against
    K4's; roots and proof bytes equal across the routes; launch counts and
    step times per route; the kernels and the routes timed at the commit's
    shapes."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, commit, prove,
                                                 serialize_proof, verify)
    from lcpc_proof_of_storage_tpu_torch.fields import FT255, limbs_to_ints
    from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse, ntt
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import (collapse_cost, hash_columns_cost,
                                                                 merkle_tree_cost, ntt_cost,
                                                                 wall_ms)

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

    def run_route(enc, out):
        comm = out["comm"] = commit(coeffs, enc, device=dev)
        root = out["root"] = comm.get_root().root
        out["blobs"] = []
        for x in points:
            outer, inner = point_tensors(x, n_rows, n_per_row, p)
            proof = prove(comm, outer, enc, transcript(root))
            value = verify(root, outer, inner, proof, enc, transcript(root), device=dev)
            if value != horner(coeff_ints, x, p):
                raise AssertionError(f"{enc.ntt}: verify returned a wrong evaluation at x={x}")
            out["blobs"].append(serialize_proof(proof, spec))
        if enc.ntt == "fused_small":
            out["decoded"] = enc.decode(comm.comm)

    out = {}
    launches = launches_of(lambda: run_route(enc, out))
    comm, root = out["comm"], out["root"]
    say(f"ligero: root {root.hex()}; {N_POINTS} proofs verified with the evaluations "
        f"computed on the host; launches {launches}")
    missing = [k for k in ("ntt", "blake3_leaves", "blake3_tree", "collapse")
               if launches[k] == 0]
    if missing or launches["ntt_tile"] or launches["mul_mod"]:
        raise AssertionError(f"the Ligero path's launches {launches}")
    res.add_launches(f"ligero_2^{LOG2_MAIN}", launches)

    padded = comm.coeffs.new_zeros((n_rows, n_cols, spec.num_limbs16))
    padded[:, :n_per_row] = comm.coeffs
    want = plain_root(ntt.ntt_plain(padded, spec, n_per_row, enc.tables(dev)), n_cols, spec)
    if want != root:
        raise AssertionError(f"root {root.hex()} differs from the plain versions' {want.hex()}")
    say("ligero: root equals the root the plain versions compute on the card")

    encs = {"stages": enc}
    for route, kernel_of_route in (("four_step", "ntt_tile"), ("fused_small", "mul_mod")):
        r_enc = encs[route] = LigeroEncoding.new(length, spec, rho=(1, 4), ntt=route)
        r_out = {}
        r_launches = launches_of(lambda: run_route(r_enc, r_out))
        res.add_launches(f"ligero_2^{LOG2_MAIN}_{route}", r_launches)
        if r_out["root"] != root or r_out["blobs"] != out["blobs"]:
            raise AssertionError(f"{route}: root or proof bytes differ from the stages route's")
        wrong_k1 = r_launches["ntt"] != 0 if route == "four_step" else r_launches["ntt"] == 0
        if wrong_k1 or not r_launches["ntt_tile"] or not r_launches[kernel_of_route]:
            raise AssertionError(f"{route}: launches {r_launches}")
        say(f"ligero {route}: root and the {N_POINTS} proofs' {len(out['blobs'][0])} bincode "
            f"bytes each identical to the stages route's; launches {r_launches}")
        if route == "fused_small":
            decoded = r_out["decoded"]
            res.compare("mul_mod", f"the fused_small decode of the committed ({n_rows}, "
                        f"{n_cols}, 16) rows against K4's inverse", decoded,
                        ntt.intt(comm.comm, spec, enc.tables(dev)))
            if not torch.equal(decoded[:, :n_per_row], comm.coeffs) \
                    or decoded[:, n_per_row:].any():
                raise AssertionError("the fused_small decode is not the committed coefficients")
        del r_out
        free_device(dev)

    outer, inner = point_tensors(points[0], n_rows, n_per_row, p)
    proof = prove(comm, outer, enc, transcript(root))
    for route, r_enc in encs.items():
        t_commit = wall_ms(lambda: commit(coeffs, r_enc, device=dev))
        t_prove = wall_ms(lambda: prove(comm, outer, r_enc, transcript(root)))
        t_verify = wall_ms(lambda: verify(root, outer, inner, proof, r_enc, transcript(root),
                                          device=dev))
        say(f"time [{card}]: ligero {route} commit {t_commit:.3f} ms, prove {t_prove:.3f} ms, "
            f"verify {t_verify:.3f} ms at 2^{LOG2_MAIN} {spec.name} (medians of {N_TIMED}; "
            f"{length / (t_commit / 1e3):.0f} coefficients/s committed)")
    value = leg_report(card, f"ligero 2^{LOG2_MAIN}", spec, serialize_proof(proof, spec),
                       lambda: prove(comm, outer, enc, transcript(root)),
                       lambda pr: verify(root, outer, inner, pr, enc, transcript(root),
                                         device=dev))
    if value != horner(coeff_ints, points[0], p):
        raise AssertionError(f"ligero 2^{LOG2_MAIN}: the profiled verify's evaluation is wrong")

    L = spec.num_limbs16
    hashes = comm.hashes.clone()
    tvec = torch.from_numpy(random_limbs(rng, (2, n_rows), spec)).to(dev)
    skip = (n_cols // n_per_row).bit_length() - 1     # stages that only duplicate
    res.bound["ntt"] = ntt_cost(n_rows, n_cols, L, n_cols.bit_length() - 1 - skip).bound_ms()
    res.bound["blake3_leaves"] = hash_columns_cost(n_rows, n_cols, spec.repr_bytes).bound_ms()
    res.bound["blake3_tree"] = merkle_tree_cost(n_cols).bound_ms()
    res.bound["collapse"] = collapse_cost(n_rows, n_per_row, L, 2).bound_ms()
    timed_pair(res, "ntt", lambda: ntt.ntt(padded, spec, n_per_row, enc.tables(dev)),
               lambda: ntt.ntt_plain(padded, spec, n_per_row, enc.tables(dev)),
               f"({n_rows}, {n_cols}, 16) n_nonzero={n_per_row}, {plan_text(n_cols)}", card,
               plain_runs=1)
    timed_pair(res, "blake3_leaves", lambda: blake3.hash_columns(comm.comm, spec),
               lambda: blake3.hash_columns_plain(comm.comm, spec),
               f"({n_rows}, {n_cols}, 16) -> ({n_cols}, 8)", card, plain_runs=1)
    timed_pair(res, "blake3_tree", lambda: blake3.merkle_tree(hashes),
               lambda: blake3.merkle_tree_plain(hashes),
               f"all {n_cols.bit_length() - 1} layers over {n_cols} leaves in "
               f"{len(blake3.tree_plan(n_cols))} launches", card, plain_runs=1)
    timed_pair(res, "collapse", lambda: collapse.collapse(comm.coeffs, tvec, spec),
               lambda: collapse.collapse_plain(comm.coeffs, tvec, spec),
               f"({n_rows}, {n_per_row}, 16) T=2", card)
    if not torch.equal(hashes, comm.hashes):
        raise AssertionError("the timed trees differ from the commit's Merkle array")
    del encs, hashes, tvec
    free_device(dev)
    time_ntt_routes(res, card, spec, padded, n_per_row, f"Ligero 2^{LOG2_MAIN} commit",
                    record=True)


def slot_use(counts) -> tuple[int, int]:
    """(nonzeros, slot iterations) of K5's warps on a level: a warp of 32
    neighbouring table rows (in the order the tables store them) runs as many
    slots as its longest row."""
    import torch
    c = counts.to(torch.int64).cpu()
    c = torch.nn.functional.pad(c, (0, -len(c) % 32)).view(-1, 32)
    return int(c.sum()), 32 * int(c.max(dim=1).values.sum())


def encode_levels(enc, x, spec):
    """The (table, input) of every K5 call of one encode of x."""
    from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
    levels = []

    def capture(tab, xin, field):
        levels.append((tab, xin))
        return ex.gather_matvec(tab, xin, field)

    enc.encode(x, matvec=capture)
    return levels


def level_shapes(levels) -> tuple[int, list[tuple[int, int, int]]]:
    """(batch, (rows, cols, used slots) of each level) of encode_levels'
    calls, as utils/profiling.py expander_cost takes them."""
    return (levels[0][1].shape[0],
            [(tab.rows, tab.cols, int(tab.counts.sum())) for tab, _ in levels])


def brakedown_path(res: Results, dev, card: str) -> None:
    """Brakedown SdigCode3 over ft255, seed 0, at 2^21: commit once, prove and
    verify at BD_POINTS points, proof bytes, root against the plain
    versions'; launch counts; timings."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, commit, commit_streamed,
                                                 prove, serialize_proof, verify)
    from lcpc_proof_of_storage_tpu_torch.fields import FT255, limbs_to_ints
    from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import expander_cost, wall_ms

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
    missing = [k for k in ("expander", "blake3_leaves", "blake3_tree", "collapse")
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
    st = {}
    st_launches = launches_of(lambda: st.update(root=commit_streamed(
        coeffs_np, enc, keep_comm=False, device_coeffs=False, device=dev).get_root().root))
    res.add_launches(f"brakedown_streamed_2^{BD_LOG2}", st_launches)
    if st["root"] != root:
        raise AssertionError(f"streamed root {st['root'].hex()} differs from {root.hex()}")
    # a single chunk a column: the one-shot branch, one encode and the leaves kernel
    if (st_launches["expander"] != n_levels or not st_launches["blake3_leaves"]
            or st_launches["blake3_chunk_cvs"] or st_launches["ntt"]):
        raise AssertionError(f"Brakedown 2^{BD_LOG2} streamed commit launches {st_launches}")
    say(f"brakedown: the streamed commit (host coefficients; {n_rows} rows, a single chunk a "
        f"column, so its one-shot branch) gives the same root; launches {st_launches}")

    outer, inner = point_tensors(points[0], n_rows, n_per_row, p)
    proof = prove(comm, outer, enc, transcript(root))
    t_commit = wall_ms(lambda: commit(coeffs, enc, device=dev))
    t_prove = wall_ms(lambda: prove(comm, outer, enc, transcript(root)))
    t_verify = wall_ms(lambda: verify(root, outer, inner, proof, enc, transcript(root),
                                      device=dev))
    t_encode = wall_ms(lambda: enc.encoder.encode(x_in))
    say(f"time [{card}]: brakedown commit {t_commit:.3f} ms, prove {t_prove:.3f} ms, "
        f"verify {t_verify:.3f} ms, encode {t_encode:.3f} ms at 2^{BD_LOG2} {spec.name} "
        f"(medians of {N_TIMED})")

    levels = encode_levels(enc.encoder, x_in, spec)
    res.bound["expander"] = expander_cost(*level_shapes(levels), spec.num_limbs16).bound_ms()
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
    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, commit, commit_streamed,
                                                 prove, serialize_proof, verify)
    from lcpc_proof_of_storage_tpu_torch.core.storage import even_row_batches
    from lcpc_proof_of_storage_tpu_torch.core.streamed import _row_batches
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
        out["blob"] = serialize_proof(proof, spec)
        t3 = time.perf_counter()
        out["value"] = verify(root, outer, inner, proof, enc, transcript(root), device=dev)
        torch.cuda.synchronize()
        out["t"] = (t0, t1, t2, t3, time.perf_counter())

    launches = launches_of(run)
    comm, root, blob_len, value = out["comm"], out["root"], len(out["blob"]), out["value"]
    t0, t1, t2, t3, t4 = out["t"]
    n_levels = len(enc.encoder.pre) + len(enc.encoder.post)
    missing = [k for k in ("blake3_leaves", "blake3_tree", "collapse") if launches[k] == 0]
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
    if leg_report(card, f"brakedown 2^{BD_LOG2_BIG}", spec, out["blob"],
                  lambda: prove(comm, outer, enc, transcript(root)),
                  lambda pr: verify(root, outer, inner, pr, enc, transcript(root),
                                    device=dev)) != want:
        raise AssertionError(f"brakedown 2^{BD_LOG2_BIG}: the profiled verify's evaluation is "
                             f"wrong")

    # the streamed commit of the same coefficients: 143 rows are five chunks
    # a column, hashed over the batches of 31, 32, 32, 32 and 16 rows; its
    # prove collapses the coefficients on the card (K3) and re-encodes the
    # rows for the opened columns
    so = {}

    def run_streamed():
        t0 = time.perf_counter()
        st = commit_streamed(coeffs, enc, target_batch_rows=32, keep_comm=False, device=dev)
        so["root"] = st.get_root().root
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        so["blob"] = serialize_proof(prove(st, outer, enc, transcript(root)), spec)
        so["t"] = (t1 - t0, time.perf_counter() - t1)

    st_launches = launches_of(run_streamed)
    res.add_launches(f"brakedown_streamed_2^{BD_LOG2_BIG}", st_launches)
    if so["root"] != root or so["blob"] != out["blob"]:
        raise AssertionError(f"Brakedown 2^{BD_LOG2_BIG} streamed: root {so['root'] == root}, "
                             f"proof bytes {so['blob'] == out['blob']}")
    encodes = (len(_row_batches(n_rows, spec.repr_bytes, 32))
               + len(even_row_batches(n_rows, n_cols * spec.num_limbs16 * 4, None)))
    missing = [k for k in ("blake3_chunk_cvs", "blake3_merge_cvs", "blake3_tree", "collapse")
               if st_launches[k] == 0]
    if (missing or st_launches["expander"] != n_levels * encodes or st_launches["ntt"]
            or st_launches["blake3_leaves"] or st_launches["collapse_acc"]):
        raise AssertionError(f"Brakedown 2^{BD_LOG2_BIG} streamed launches {st_launches}: "
                             f"expected {n_levels * encodes} expander ({encodes} batch encodes), "
                             f"some of each of {missing}, no ntt, leaves or K3p")
    say(f"brakedown 2^{BD_LOG2_BIG}: the streamed commit (batches of 32 rows, five chunks a "
        f"column, no encoded matrix kept) gives the same root in {so['t'][0] * 1e3:.1f} ms, and "
        f"its proof (columns re-encoded) the same {len(so['blob'])} bytes in "
        f"{so['t'][1] * 1e3:.1f} ms; launches {st_launches}")


def expander_collapse_kernels(res: Results, dev, card: str) -> None:
    """K5, K3 and K3p at every shape their paths give them, each against its
    plain version (bit-exact) and timed beside its bound: K5 over the 12
    levels of one encode at 2^21, b = 18 (the commit), and at 2^25, b = 143
    (the one-shot commit), 32 (a streamed commit batch) and 2 (verify); the
    collapse of the Ligero 2^20 prove (128, 8192, 16), of the Brakedown 2^21
    and 2^25 proves (18, 117587, 16) and (143, 235172, 16), all int32 and
    T = 2; K3p on one 2^29 prove batch (128, 262144, 16) 16-bit, T = 2, and
    on one 1 GiB PoS left-multiply batch (585, 16384, 4) 16-bit, T = 1, each
    with an accumulator.  Also the slot use of K5's warps at 2^21 and 2^25.
    It uses only the ops' public entries, so it times an older checkout of
    the port too."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import BrakedownEncoding
    from lcpc_proof_of_storage_tpu_torch.fields import FT255, WRITEABLE_FT63
    from lcpc_proof_of_storage_tpu_torch.fields.limb import narrow_limbs
    from lcpc_proof_of_storage_tpu_torch.ops import collapse
    from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import (bench_kernel, collapse_cost,
                                                                 expander_cost)

    spec = FT255
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 26)
    for log2, n_rows, bs in ((BD_LOG2, BD_DIMS[0], ((BD_DIMS[0], "the commit"),)),
                             (BD_LOG2_BIG, BD_DIMS_BIG[0],
                              ((BD_DIMS_BIG[0], "the one-shot commit"),
                               (32, "a streamed commit batch"), (2, "verify")))):
        enc = BrakedownEncoding.new(1 << log2, seed=0, field=spec).encoder
        use = [slot_use(t.counts) for t in (*enc.pre, *enc.post)]
        nnz, runs = sum(u[0] for u in use), sum(u[1] for u in use)
        say(f"expander slot use at 2^{log2}: {nnz} nonzeros a batch row in {runs} slot "
            f"iterations of K5's warps, {nnz / runs:.4f}; by level "
            f"{[round(u[0] / u[1], 4) for u in use]}")
        enc = enc.on(dev)
        for b, what in bs:
            x = random_limbs_device(gen, (b, enc.n_per_row), spec, dev)
            levels = encode_levels(enc, x, spec)
            t0 = time.perf_counter()
            for tab, xin in levels:
                res.compare("expander", "", ex.gather_matvec(tab, xin, spec),
                            ex.gather_matvec_plain(tab, xin, spec), quiet=True)
            torch.cuda.synchronize()
            t_plain = (time.perf_counter() - t0) * 1e3
            b_ms, b_by = expander_cost(*level_shapes(levels), spec.num_limbs16).bound_ms()
            k = [bench_kernel(lambda: [ex.gather_matvec(t, xi, spec) for t, xi in levels])
                 for _ in range(2)]
            say(f"time [{card}]: expander the {len(levels)} levels of one 2^{log2} encode "
                f"(b={b}, {what}), each bit-exact against plain: kernel {k[0]:.4f}/{k[1]:.4f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}); plain with the comparison {t_plain:.1f} ms")
            del x, levels
            free_device(dev)
        del enc

    for fspec, rows, npr, T, bits, what in (
            (FT255, 128, 8192, 2, 32, f"the Ligero 2^{LOG2_MAIN} prove"),
            (FT255, *BD_DIMS[:2], 2, 32, f"the Brakedown 2^{BD_LOG2} prove"),
            (FT255, *BD_DIMS_BIG[:2], 2, 32, f"the Brakedown 2^{BD_LOG2_BIG} prove"),
            (FT255, 128, ST_DIMS[1], 2, 16, f"one 2^{ST_LOG2} prove batch"),
            (WRITEABLE_FT63, 585, 16384, 1, 16, "one 1 GiB PoS left-multiply batch")):
        L = fspec.num_limbs16
        c = random_limbs_device(gen, (rows, npr), fspec, dev)
        if bits == 16:
            c = narrow_limbs(c)
        t = random_limbs_device(gen, (T, rows), fspec, dev)
        acc = random_limbs_device(gen, (T, npr), fspec, dev) if bits == 16 else None
        name = "collapse" if acc is None else "collapse_acc"
        shape = (f"({rows}, {npr}, {L}) {'int32' if bits == 32 else '16-bit'} T={T}"
                 f"{' + acc' if acc is not None else ''} ({what})")
        res.compare(name, shape, collapse.collapse(c, t, fspec, acc=acc),
                    collapse.collapse_plain(c, t, fspec, acc=acc))
        b_ms, b_by = collapse_cost(rows, npr, L, T, bits, acc is not None).bound_ms()
        k = [bench_kernel(lambda: collapse.collapse(c, t, fspec, acc=acc)) for _ in range(2)]
        p = bench_kernel(lambda: collapse.collapse_plain(c, t, fspec, acc=acc), 1)
        say(f"time [{card}]: {name} {shape}: kernel {k[0]:.4f}/{k[1]:.4f} ms, plain {p:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        del c, t, acc
        free_device(dev)


def blake3_kernels(res: Results, dev, card: str) -> None:
    """K2's leaves and Merkle tree at their paths' shapes, each against its
    plain version (bit-exact) and timed beside its bound: the leaves of the
    Ligero 2^20 commit (128, 32768, 16), of the Brakedown 2^25 and 2^21
    commits (143, 357697, 16) and (18, 178850, 16) and of a Ligero 2^20
    verify (128, 189, 16), all ft255; the tree step of a commit over 2^15
    and 2^20 leaves (core/commit.py merkle_tree_device, the leaves given)
    with its launches; then the Ligero 2^20 and Brakedown 2^21 commits and
    their roots.  It uses only the package's public entries, and the tree
    step through whichever merkle_tree_device the package has, so with an
    older checkout's package first on sys.path it times that one."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import (BrakedownEncoding, LigeroEncoding, commit,
                                                 kernels)
    from lcpc_proof_of_storage_tpu_torch.core import commit as core_commit
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    from lcpc_proof_of_storage_tpu_torch.ops import blake3
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import (bench_kernel, device_ms,
                                                                 hash_columns_cost,
                                                                 merkle_tree_cost, wall_ms)

    new = hasattr(blake3, "merkle_tree")      # an older package builds the tree layer by layer
    tree_kernel = "blake3_tree" if new else "blake3_parents"
    say(f"blake3_kernels: the package at {Path(blake3.__file__).parents[2]}")
    spec = FT255
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 27)
    for rows, cols, what in ((128, 32768, f"the Ligero 2^{LOG2_MAIN} commit"),
                             (BD_DIMS_BIG[0], 357697, f"the Brakedown 2^{BD_LOG2_BIG} commit"),
                             (BD_DIMS[0], BD_DIMS[2], f"the Brakedown 2^{BD_LOG2} commit"),
                             (128, 189, f"a Ligero 2^{LOG2_MAIN} verify")):
        m = random_limbs_device(gen, (rows, cols), spec, dev)
        shape = f"({rows}, {cols}, 16) ft255 ({what})"
        res.compare("blake3_leaves", shape, blake3.hash_columns(m, spec),
                    blake3.hash_columns_plain(m, spec))
        b_ms, b_by = hash_columns_cost(rows, cols, spec.repr_bytes).bound_ms()
        k = [bench_kernel(lambda: blake3.hash_columns(m, spec)) for _ in range(2)]
        say(f"time [{card}]: blake3_leaves {shape}: kernel {k[0]:.4f}/{k[1]:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        del m
        free_device(dev)

    for log2 in (15, 20):
        n = 1 << log2
        leaves = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, device=dev,
                               dtype=torch.int64).to(torch.int32)
        if new:
            def tree_step():
                return core_commit.merkle_tree_device(n, dev, lambda out: out.copy_(leaves))
        else:
            def tree_step():
                return core_commit.merkle_tree_device(leaves, n)
        layers = [leaves]
        while layers[-1].shape[0] > 1:
            layers.append(blake3.merkle_parents_plain(layers[-1]))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = tree_step()
        torch.cuda.synchronize()
        launches = kernels.KERNELS[tree_kernel].launches
        res.compare(tree_kernel, f"Merkle tree over 2^{log2} leaves", got, torch.cat(layers))
        b_ms, b_by = merkle_tree_cost(n).bound_ms()
        k = [bench_kernel(tree_step) for _ in range(2)]
        alone = ""
        if new:
            a = [bench_kernel(lambda: blake3.merkle_tree(got)) for _ in range(2)]
            alone = f"; merkle_tree alone {a[0]:.4f}/{a[1]:.4f} ms"
        d_ms, d_n = device_ms(tree_step)
        say(f"time [{card}]: {tree_kernel} the tree step over 2^{log2} leaves, {launches} "
            f"launches: {k[0]:.4f}/{k[1]:.4f} ms{alone}, bound {b_ms:.4f} ms ({b_by}); "
            f"device {d_ms:.4f} ms in {d_n:.0f} kernels a call (torch.profiler)")
        del leaves, layers, got
        free_device(dev)

    for name, log2 in (("ligero", LOG2_MAIN), ("brakedown", BD_LOG2)):
        enc = (LigeroEncoding.new(1 << log2, spec, rho=(1, 4)) if name == "ligero"
               else BrakedownEncoding.new(1 << log2, seed=0, field=spec))
        coeffs = random_limbs_device(gen, (1 << log2,), spec, dev)
        root = commit(coeffs, enc, device=dev).get_root().root
        t = [wall_ms(lambda: commit(coeffs, enc, device=dev), runs=10) for _ in range(2)]
        d_ms, d_n = device_ms(lambda: commit(coeffs, enc, device=dev), runs=10)
        say(f"time [{card}]: blake3_kernels {name} 2^{log2} commit {t[0]:.3f}/{t[1]:.3f} ms "
            f"(medians of 10), device {d_ms:.3f} ms in {d_n:.0f} kernels a commit "
            f"(torch.profiler), root {root.hex()}")
        del coeffs, enc
        free_device(dev)


# --------------------------------------------------------------------------
# the streamed (out-of-core) commit and prove
# --------------------------------------------------------------------------

def host_rss_gib() -> float:
    """Peak resident memory of this process, GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def device_memory_line(dev) -> str:
    import torch
    total = torch.cuda.get_device_properties(dev).total_memory
    peak = torch.cuda.max_memory_allocated(dev)
    if peak >= total:
        raise AssertionError(f"peak device memory {peak} bytes reaches the card's {total}")
    return (f"peak device memory {peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB, "
            f"peak host RSS {host_rss_gib():.2f} GiB")


def free_device(dev) -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def check_ntt_at(res: Results, enc, rows16, what: str) -> None:
    """K1, through the Ligero encode and through encode_stored as the streamed
    path calls it (the 16-bit rows read as stored, the 16-bit codewords
    written by the kernel), on (b, n_per_row, L) 16-bit coefficient rows of
    that path, against ntt_plain on the card at the path's n, bit-exact."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields.limb import narrow_limbs, widen_limbs
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    rows = widen_limbs(rows16)
    b, npr, L = rows.shape
    padded = rows.new_zeros((b, enc.n_cols, L))
    padded[:, :npr] = rows
    want = ntt.ntt_plain(padded, enc.spec, npr, enc.tables(rows.device))
    what = f"{what}: {b} rows, n={enc.n_cols} n_nonzero={npr}"
    res.compare("ntt", what, enc.encode(rows), want)
    out16 = torch.empty(want.shape, dtype=torch.int16, device=want.device)
    res.compare("ntt", f"{what}, encode_stored of the 16-bit rows",
                enc.encode_stored(rows16, out16), want)
    res.compare("ntt", f"{what}, encode_stored's 16-bit codewords", out16, narrow_limbs(want))


def time_ntt_rows(card: str, enc, rows16) -> None:
    """K1 on one row batch of the streamed commit as that commit runs it: the
    (b, n_per_row, L) 16-bit rows read at their width, the 16-bit codewords
    written by the last pass (ntt_rows with out16), against the sequence it
    replaced there (widen, zero pad to n_cols, K1, narrow into the kept
    rows), CUDA-event means in turns, beside ntt_cost's bound."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields.limb import narrow_limbs, widen_limbs
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import bench_kernel, ntt_cost
    b, npr, L = rows16.shape
    n, spec, tables = enc.n_cols, enc.spec, enc.tables(rows16.device)
    kept = torch.empty((b, n, L), dtype=torch.int16, device=rows16.device)

    def replaced():
        padded = torch.zeros((b, n, L), dtype=torch.int32, device=rows16.device)
        padded[:, :npr] = widen_limbs(rows16)
        kept.copy_(narrow_limbs(ntt.ntt(padded, spec, npr, tables)))

    def rows():
        ntt.ntt_rows(rows16, spec, n, npr, tables, out16=kept)

    r1, k1, k2, r2 = (bench_kernel(f, 5) for f in (replaced, rows, rows, replaced))
    skip = (n // (1 << (npr - 1).bit_length())).bit_length() - 1
    bound, by = ntt_cost(b, n, L, n.bit_length() - 1 - skip).bound_ms()
    say(f"time [{card}]: ntt_rows ({b}, {npr}, {L}) int16 rows -> ({b}, {n}, {L}) int32 and "
        f"int16 {spec.name}, {plan_text(n)}: kernel {k1:.4f}/{k2:.4f} ms, the widen / pad / K1 "
        f"/ narrow it replaced {r1:.4f}/{r2:.4f} ms, bound {bound:.4f} ms ({by})")


def synthetic_constants() -> dict:
    """SYNTHETIC_SEED, SYNTHETIC_LENGTH and SYNTHETIC_PIN of
    tests/test_torch_streamed.py, read without importing it (it imports JAX)."""
    import ast
    tree = ast.parse((ROOT / "tests" / "test_torch_streamed.py").read_text())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id.startswith("SYNTHETIC_")}


def check_streamed_kernels(res: Results, dev) -> None:
    """K3p (16-bit coefficients and an accumulator) on five fields at more
    than 2048 rows and ragged npr, K3 on 16-bit coefficients, and the chunk-CV
    and merge entries over every batch (first, interior, last) of ft63,
    ft255 and ft253_192 matrices, each against its plain version; the
    port's synthetic pin on CUDA."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import LigeroEncoding
    from lcpc_proof_of_storage_tpu_torch.core import streamed
    from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
    from lcpc_proof_of_storage_tpu_torch.fields.limb import narrow_limbs
    from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse

    rng = np.random.default_rng(SEED + 3)
    for spec, rows, npr in ((FT63, 3000, 77), (FT127, 2100, 300), (FT191, 2049, 129),
                            (FT255, 2500, 191), (FT253_192, 2200, 100), (FT63, 16, 140000),
                            (FT191, 12, 140001)):
        c16 = narrow_limbs(torch.from_numpy(random_limbs(rng, (rows, npr), spec)).to(dev))
        t = torch.from_numpy(random_limbs(rng, (2, rows), spec)).to(dev)
        acc = torch.from_numpy(random_limbs(rng, (2, npr), spec)).to(dev)
        res.compare("collapse_acc", f"{spec.name} 16-bit rows={rows} npr={npr} T=2 + acc "
                    f"(row warps {collapse.collapse_plan(rows, npr, 2, spec.num_limbs16).row_warps})",
                    collapse.collapse(c16, t, spec, acc=acc),
                    collapse.collapse_plain(c16, t, spec, acc=acc))
        if spec is FT255:
            res.compare("collapse", f"{spec.name} 16-bit rows={rows} npr={npr} T=2",
                        collapse.collapse(c16, t, spec), collapse.collapse_plain(c16, t, spec))

    for spec, rows, target in ((FT63, 700, 200), (FT255, 200, 70), (FT253_192, 150, 40)):
        n_cols = 1000
        m = torch.from_numpy(random_limbs(rng, (rows, n_cols), spec)).to(dev)
        total = -(-(32 + rows * spec.repr_bytes) // 1024)
        got = torch.full((n_cols, total, 8), -1, dtype=torch.int32, device=dev)
        want = got.clone()
        batches = streamed._row_batches(rows, spec.repr_bytes, target)
        chunk0 = 0
        for r0, r1 in batches:
            blake3.chunk_cvs(m[r0:r1].contiguous(), spec, got, chunk0, r0 == 0)
            blake3.chunk_cvs_plain(m[r0:r1].contiguous(), spec, want, chunk0, r0 == 0)
            chunk0 += blake3.batch_chunks(r1 - r0, spec, r0 == 0)[0]
        res.compare("blake3_chunk_cvs", f"{spec.name} {rows} rows in batches {batches} "
                    f"({total} chunks a column)", got, want)
        leaves = blake3.merge_cvs(got)
        res.compare("blake3_merge_cvs", f"{spec.name} {total} chunks of {n_cols} columns",
                    leaves, blake3.merge_cvs_plain(want))
        res.compare("blake3_merge_cvs", f"{spec.name} merged leaves against the one-shot leaves",
                    leaves, blake3.hash_columns_plain(m, spec))

    syn = synthetic_constants()
    enc = LigeroEncoding(FT63, 4, 16)
    comm = streamed.commit_streamed(
        streamed.SyntheticCoeffs(syn["SYNTHETIC_LENGTH"], seed=syn["SYNTHETIC_SEED"]), enc,
        target_batch_rows=100, keep_comm=False, device=dev)
    if comm.get_root().root.hex() != syn["SYNTHETIC_PIN"]:
        raise AssertionError(f"synthetic root {comm.get_root().root.hex()} on CUDA, pin "
                             f"{syn['SYNTHETIC_PIN']} on the CPU")
    say(f"streamed: the synthetic pin of tests/test_torch_streamed.py reproduced on CUDA "
        f"({syn['SYNTHETIC_PIN'][:16]}...)")


def streamed_modes(res: Results, dev, card: str) -> None:
    """Ligero rho=1/4 ft255 at 2^25: every keep_comm x device_coeffs mode of
    the streamed commit, in batches of ST_MODES_BATCH rows, gives the
    one-shot root, and its proof the one-shot proof's bytes; one verified."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, commit, prove, serialize_proof,
                                                 verify)
    from lcpc_proof_of_storage_tpu_torch.core import streamed
    from lcpc_proof_of_storage_tpu_torch.fields import FT255

    spec = FT255
    length = 1 << ST_LOG2_MODES
    enc = LigeroEncoding.new(length, spec, rho=(1, 4))
    n_rows, n_per_row, n_cols = enc.get_dims(length)
    coeffs = streamed.materialize(streamed.SyntheticCoeffs(length, seed=SEED + 2), spec, dev)
    outer, inner = point_tensors(0xC0FFEE, n_rows, n_per_row, spec.modulus)
    one = commit(coeffs, enc, device=dev)
    root = one.get_root().root
    want = serialize_proof(prove(one, outer, enc, transcript(root)), spec)
    del one
    free_device(dev)
    host = coeffs.cpu().numpy().view(np.uint16)
    out = {}

    def run():
        for device_coeffs in (True, False):
            for keep_comm in (True, False, "device"):
                t0 = time.perf_counter()
                comm = streamed.commit_streamed(coeffs if device_coeffs else host, enc,
                                                target_batch_rows=ST_MODES_BATCH,
                                                keep_comm=keep_comm,
                                                device_coeffs=device_coeffs, device=dev)
                got_root = comm.get_root().root
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                proof = prove(comm, outer, enc, transcript(root))
                t2 = time.perf_counter()
                blob = serialize_proof(proof, spec)
                if got_root != root or blob != want:
                    raise AssertionError(f"streamed 2^{ST_LOG2_MODES} keep_comm={keep_comm} "
                                         f"device_coeffs={device_coeffs}: root "
                                         f"{got_root == root}, proof bytes {blob == want}")
                out[(device_coeffs, keep_comm)] = (t1 - t0, t2 - t1)
                if (device_coeffs, keep_comm) == (False, False):
                    out["value"] = verify(root, outer, inner, proof, enc, transcript(root),
                                          device=dev)
                del comm, proof

    launches = launches_of(run)
    res.add_launches(f"streamed_modes_2^{ST_LOG2_MODES}", launches)
    for k in ("ntt", "blake3_chunk_cvs", "blake3_merge_cvs", "collapse", "collapse_acc"):
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched by the 2^{ST_LOG2_MODES} streamed modes")
    if out["value"] != row_evaluation(coeffs.reshape(n_rows, n_per_row, -1), outer, inner,
                                      spec, dev):
        raise AssertionError(f"streamed 2^{ST_LOG2_MODES}: verify returned a wrong evaluation")
    say(f"streamed 2^{ST_LOG2_MODES}: dims ({n_rows}, {n_per_row}, {n_cols}), batches "
        f"{streamed._row_batches(n_rows, spec.repr_bytes, ST_MODES_BATCH)}; all six "
        f"keep_comm x device_coeffs modes give the one-shot root {root.hex()[:16]}... and "
        f"the one-shot proof's {len(want)} bytes; the host-coefficient, no-matrix proof "
        f"verified with the evaluation of the plain row dots; launches {launches}")
    for (dc, kc), (tc, tp) in ((k, v) for k, v in out.items() if k != "value"):
        say(f"time [{card}]: streamed 2^{ST_LOG2_MODES} device_coeffs={dc} keep_comm={kc}: "
            f"commit {tc * 1e3:.1f} ms, prove {tp * 1e3:.1f} ms (one run each)")
    check_ntt_at(res, enc, coeffs.reshape(n_rows, n_per_row, -1)[:2],
                 f"the streamed 2^{ST_LOG2_MODES} rows")
    del coeffs, host
    free_device(dev)


def row_evaluation(coeffs16, outer, inner, spec, dev, rows_a_step: int = 16) -> int:
    """sum_i outer[i] * <row i, inner> mod p over (n_rows, n_per_row, L)
    16-bit coefficients on the card, with the plain limb dot."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import limbs_to_ints
    from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field, widen_limbs
    lf = limb_field(spec)
    inner_t = lf.array(inner, dev)
    evals = torch.cat([lf.dot(widen_limbs(coeffs16[i:i + rows_a_step]), inner_t[None], axis=1)
                       for i in range(0, coeffs16.shape[0], rows_a_step)])
    rows = limbs_to_ints(evals.cpu().numpy())
    return sum(o * r for o, r in zip(outer, rows)) % spec.modulus


def streamed_device(res: Results, dev, card: str) -> None:
    """Ligero rho=1/4 ft255 at 2^28 with 16-bit coefficients on the card and
    keep_comm="device" (the encoded matrix kept there as 16-bit limbs):
    commit, prove, verify, the evaluation against the plain row dots."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, prove, serialize_proof,
                                                 verify)
    from lcpc_proof_of_storage_tpu_torch.core import streamed
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    from lcpc_proof_of_storage_tpu_torch.utils.serde import serialized_proof_len

    spec = FT255
    length = 1 << ST_LOG2_DEVICE
    t0 = time.perf_counter()
    enc = LigeroEncoding.new(length, spec, rho=(1, 4))
    enc.tables(dev)
    t_tables = time.perf_counter() - t0
    n_rows, n_per_row, n_cols = enc.get_dims(length)
    coeffs = streamed.materialize(streamed.SyntheticCoeffs(length, seed=SEED + 28), spec, dev)
    outer, inner = point_tensors(0xBADC0DE, n_rows, n_per_row, spec.modulus)
    free_device(dev)
    out = {}

    def run():
        t0 = time.perf_counter()
        comm = out["comm"] = streamed.commit_streamed(coeffs, enc, keep_comm="device",
                                                      device=dev)
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
    comm = out["comm"]
    mem = device_memory_line(dev)
    res.add_launches(f"streamed_device_2^{ST_LOG2_DEVICE}", launches)
    missing = [k for k in ("ntt", "blake3_chunk_cvs", "blake3_merge_cvs", "blake3_tree",
                           "blake3_leaves", "collapse") if launches[k] == 0]
    if missing or launches["collapse_acc"]:
        raise AssertionError(f"streamed 2^{ST_LOG2_DEVICE} launches {launches}")
    if comm.comm.dtype != torch.int16 or comm.coeffs.dtype != torch.int16:
        raise AssertionError("the 2^28 commitment does not keep 16-bit limbs on the card")
    want_len = serialized_proof_len(n_rows, n_per_row, n_cols, enc.get_n_degree_tests(),
                                    enc.get_n_col_opens(), spec)
    want = row_evaluation(coeffs.reshape(n_rows, n_per_row, -1), outer, inner, spec, dev)
    t0, t1, t2, t3, t4 = out["t"]
    say(f"streamed 2^{ST_LOG2_DEVICE}: dims ({n_rows}, {n_per_row}, {n_cols}), 16-bit "
        f"coefficients and encoded matrix ({comm.comm.numel() * 2 / 1e9:.1f} GB) on the card; "
        f"root {out['root'].hex()[:16]}...; proof {out['len']} bytes (layout {want_len}); "
        f"verify returned {'the' if out['value'] == want else 'a WRONG'} evaluation; "
        f"launches {launches}")
    if out["len"] != want_len or out["value"] != want:
        raise AssertionError(f"streamed 2^{ST_LOG2_DEVICE}: proof length or evaluation wrong")
    say(f"time [{card}]: streamed 2^{ST_LOG2_DEVICE} keep_comm=device: commit "
        f"{(t1 - t0) * 1e3:.1f} ms, prove {(t2 - t1) * 1e3:.1f} ms, serialize "
        f"{(t3 - t2) * 1e3:.1f} ms, verify {(t4 - t3) * 1e3:.1f} ms (one run each); NTT "
        f"tables {t_tables:.2f} s on the host (set-up); {mem}")
    del comm, out
    free_device(dev)
    check_ntt_at(res, enc, coeffs.reshape(n_rows, n_per_row, -1)[:2],
                 f"the streamed 2^{ST_LOG2_DEVICE} rows")
    time_ntt_rows(card, enc, coeffs.reshape(n_rows, n_per_row, -1)[:32])
    del coeffs
    free_device(dev)


def streamed_host(res: Results, dev, card: str) -> None:
    """The Rust reference's largest point, Ligero rho=1/4 ft255 2^29: 16-bit
    coefficients in host memory (device_coeffs=False) and no encoded matrix
    kept (keep_comm=False); commit, prove (K3p over row batches, then the
    re-encode of the opened columns), serialize, verify; a proof with one
    limb changed is rejected; the proof length is the bincode layout's; a
    SyntheticCoeffs commit of the same seed gives the same root.  Then K3p,
    the chunk-CV and merge entries are timed at this path's shapes."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch import (LigeroEncoding, VerifierError, prove,
                                                 serialize_proof, verify)
    from lcpc_proof_of_storage_tpu_torch.core import streamed
    from lcpc_proof_of_storage_tpu_torch.core.storage import even_row_batches
    from lcpc_proof_of_storage_tpu_torch.fields import FT255
    from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field
    from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse
    from lcpc_proof_of_storage_tpu_torch.utils.serde import serialized_proof_len
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import (bench_kernel, chunk_cvs_cost,
                                                                 collapse_cost, merge_cvs_cost)

    spec = FT255
    L = spec.num_limbs16
    length = 1 << ST_LOG2
    t0 = time.perf_counter()
    enc = LigeroEncoding.new(length, spec, rho=(1, 4))
    enc.tables(dev)
    t_tables = time.perf_counter() - t0
    dims = enc.get_dims(length)
    if dims != ST_DIMS:
        raise AssertionError(f"Ligero 2^{ST_LOG2} dims {dims}, not {ST_DIMS}")
    n_rows, n_per_row, n_cols = dims
    src = streamed.SyntheticCoeffs(length, seed=SEED + 29)
    t0 = time.perf_counter()
    host = streamed.materialize(src, spec, dev).cpu().numpy().view(np.uint16)
    t_gen = time.perf_counter() - t0
    free_device(dev)
    outer, inner = point_tensors(0x5EED, n_rows, n_per_row, spec.modulus)
    say(f"streamed 2^{ST_LOG2}: dims {dims}, {enc.get_n_degree_tests()} degree test(s), "
        f"{enc.get_n_col_opens()} column openings; NTT tables {t_tables:.2f} s on the host; "
        f"{host.nbytes / 1e9:.1f} GB of 16-bit coefficients made on the card and copied to "
        f"host memory in {t_gen:.1f} s (set-up)")
    out = {}

    def run():
        t0 = time.perf_counter()
        comm = out["comm"] = streamed.commit_streamed(host, enc, keep_comm=False,
                                                      device_coeffs=False, device=dev)
        root = out["root"] = comm.get_root().root
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        proof = out["proof"] = prove(comm, outer, enc, transcript(root))
        t2 = time.perf_counter()
        out["len"] = len(serialize_proof(proof, spec))
        t3 = time.perf_counter()
        out["value"] = verify(root, outer, inner, proof, enc, transcript(root), device=dev)
        torch.cuda.synchronize()
        out["t"] = (t0, t1, t2, t3, time.perf_counter())

    launches = launches_of(run)
    mem = device_memory_line(dev)
    res.add_launches(f"streamed_host_2^{ST_LOG2}", launches)
    missing = [k for k in ("ntt", "blake3_chunk_cvs", "blake3_merge_cvs", "blake3_tree",
                           "blake3_leaves", "collapse_acc") if launches[k] == 0]
    if missing or launches["collapse"]:
        raise AssertionError(f"streamed 2^{ST_LOG2} launches {launches}")
    root, proof = out["root"], out["proof"]
    want_len = serialized_proof_len(n_rows, n_per_row, n_cols, enc.get_n_degree_tests(),
                                    enc.get_n_col_opens(), spec)
    if out["len"] != want_len:
        raise AssertionError(f"2^{ST_LOG2} proof of {out['len']} bytes, layout gives {want_len}")
    # the evaluation: <inner, p_eval> (verify returns it only after every check held)
    p_eval = sum(a * b for a, b in zip(inner, proof.p_eval)) % spec.modulus
    if out["value"] != p_eval:
        raise AssertionError(f"2^{ST_LOG2} verify returned a wrong evaluation")
    t0, t1, t2, t3, t4 = out["t"]
    t_commit = t1 - t0
    say(f"streamed 2^{ST_LOG2}: root {root.hex()}; proof {out['len']} bytes (bincode layout "
        f"{want_len}) verified; launches {launches}")
    say(f"time [{card}]: streamed 2^{ST_LOG2} host coefficients, keep_comm=False: commit "
        f"{t1 - t0:.3f} s, prove {t2 - t1:.3f} s, serialize {t3 - t2:.3f} s, verify "
        f"{t4 - t3:.3f} s (one run each); {mem}")
    if leg_report(card, f"streamed 2^{ST_LOG2} host coefficients", spec,
                  serialize_proof(proof, spec),
                  lambda: prove(out["comm"], outer, enc, transcript(root)),
                  lambda pr: verify(root, outer, inner, pr, enc, transcript(root),
                                    device=dev)) != p_eval:
        raise AssertionError(f"streamed 2^{ST_LOG2}: the profiled verify's evaluation is wrong")

    # prove's two passes over the host coefficients, timed alone: the
    # commitment's store already holds its pinned staging pair (allocated
    # by the commit, grown by the prove's first collapse batch)
    comm = out["comm"]
    rows = comm.coeff_rows
    t_vec = torch.stack([limb_field(spec).array(outer)] * 2).to(dev)
    n_batches = len(even_row_batches(n_rows, n_per_row * L * 2, None))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows.collapse(t_vec, spec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows.open_columns(enc, n_cols, list(range(0, n_cols, n_cols // 189))[:189])
    t2 = time.perf_counter()
    say(f"time [{card}]: streamed 2^{ST_LOG2} prove's passes alone: collapse (K3p over "
        f"{n_batches} uploaded batches) {t1 - t0:.3f} s ({host.nbytes / (t1 - t0) / 1e9:.2f} "
        f"GB/s of coefficients, the staging already allocated), opened columns (2048 rows "
        f"uploaded and re-encoded) {t2 - t1:.3f} s; staging held by the commitment "
        f"{rows.staging_bytes() / 2**30:.2f} GiB pinned")
    del comm, rows, t_vec

    # the upload's legs on one collapse batch (1 GiB of 16-bit rows): a
    # fresh pinned allocation, the host copy into it, the copy to the card
    batch16 = torch.from_numpy(host.reshape(n_rows, n_per_row, L)[:128].view(np.int16))
    t0 = time.perf_counter()
    pinned = torch.empty(batch16.shape, dtype=torch.int16, pin_memory=True)
    t1 = time.perf_counter()
    memcpy = []
    for _ in range(2):
        t2 = time.perf_counter()
        pinned.copy_(batch16)
        memcpy.append(time.perf_counter() - t2)
    h2d = []
    for _ in range(2):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        on_card = pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t2)
    gb = batch16.numel() * 2 / 1e9
    say(f"time [{card}]: streamed 2^{ST_LOG2} upload legs for {gb:.2f} GB: pinned "
        f"allocation {(t1 - t0) * 1e3:.1f} ms, host copy into it "
        f"{'/'.join(f'{t * 1e3:.1f}' for t in memcpy)} ms "
        f"({gb / min(memcpy):.2f} GB/s), pinned to card "
        f"{'/'.join(f'{t * 1e3:.1f}' for t in h2d)} ms ({gb / min(h2d):.2f} GB/s)")
    del batch16, pinned, on_card
    check_ntt_at(res, enc, torch.from_numpy(host.reshape(n_rows, n_per_row, L)[:2]
                                            .view(np.int16)).to(dev),
                 f"the streamed 2^{ST_LOG2} rows")
    free_device(dev)

    col = proof.columns[0]
    col._limbs = col._limbs.copy()
    col._limbs[0, 0] ^= 1
    try:
        verify(root, outer, inner, proof, enc, transcript(root), device=dev)
    except VerifierError as e:
        say(f"streamed 2^{ST_LOG2}: a proof with one column limb changed is rejected ({e.kind})")
    else:
        raise AssertionError(f"2^{ST_LOG2} proof with a changed limb was accepted")
    del proof, out
    free_device(dev)

    t0 = time.perf_counter()
    syn = streamed.commit_streamed(src, enc, keep_comm=False, device=dev)
    syn_root = syn.get_root().root
    t_syn = time.perf_counter() - t0
    if syn_root != root:
        raise AssertionError(f"SyntheticCoeffs root {syn_root.hex()} differs from the "
                             f"host-mode root {root.hex()}")
    say(f"time [{card}]: streamed 2^{ST_LOG2} SyntheticCoeffs commit (rows made on the "
        f"card) {t_syn:.3f} s, root equal to the host-mode root; {device_memory_line(dev)}")
    del syn
    free_device(dev)

    # the same host coefficients committed again on the four_step route
    t0 = time.perf_counter()
    fs_enc = LigeroEncoding.new(length, spec, rho=(1, 4), ntt="four_step")
    fs_enc.tables(dev)
    t_tables = time.perf_counter() - t0
    fs_out = {}

    def run_four_step():
        t0 = time.perf_counter()
        fs = streamed.commit_streamed(host, fs_enc, keep_comm=False, device_coeffs=False,
                                      device=dev)
        fs_out["root"] = fs.get_root().root
        torch.cuda.synchronize()
        fs_out["t"] = time.perf_counter() - t0

    fs_launches = launches_of(run_four_step)
    res.add_launches(f"streamed_host_2^{ST_LOG2}_four_step", fs_launches)
    if fs_out["root"] != root:
        raise AssertionError(f"four_step root {fs_out['root'].hex()} differs from the stages "
                             f"route's {root.hex()}")
    if fs_launches["ntt"] or not fs_launches["ntt_tile"]:
        raise AssertionError(f"four_step 2^{ST_LOG2} launches {fs_launches}")
    say(f"time [{card}]: streamed 2^{ST_LOG2} host coefficients, keep_comm=False, commit on "
        f"the four_step route {fs_out['t']:.3f} s beside the stages route's (K1) "
        f"{t_commit:.3f} s, root equal (its tables {t_tables:.2f} s on the host, set-up); "
        f"launches {fs_launches}; {device_memory_line(dev)}")
    del fs_enc
    free_device(dev)

    # the kernels at this path's shapes: one 128-row collapse batch of the
    # prove (16-bit, T=2, accumulator), one interior 32-row commit batch's
    # chunk CVs, the merge of all 65 chunks of the 2^20 columns
    host3 = host.reshape(n_rows, n_per_row, L)
    rows_c = min(128, n_rows)
    c16 = torch.from_numpy(host3[:rows_c].view(np.int16)).to(dev)
    lf_t = torch.from_numpy(random_limbs(np.random.default_rng(SEED), (2, rows_c), spec)).to(dev)
    acc = torch.from_numpy(random_limbs(np.random.default_rng(SEED + 1), (2, n_per_row),
                                        spec)).to(dev)
    res.bound["collapse_acc"] = collapse_cost(rows_c, n_per_row, L, 2, 16, True).bound_ms()
    res.compare("collapse_acc", f"one 2^{ST_LOG2} prove batch ({rows_c}, {n_per_row}, 16) "
                f"16-bit, T=2, + acc", collapse.collapse(c16, lf_t, spec, acc=acc),
                collapse.collapse_plain(c16, lf_t, spec, acc=acc))
    timed_pair(res, "collapse_acc", lambda: collapse.collapse(c16, lf_t, spec, acc=acc),
               lambda: collapse.collapse_plain(c16, lf_t, spec, acc=acc),
               f"({rows_c}, {n_per_row}, 16) 16-bit T=2 + acc", card, plain_runs=1)
    del c16, lf_t, acc
    free_device(dev)

    rows_b = 32
    rows32 = torch.from_numpy(host3[31:31 + rows_b].astype(np.int32)).to(dev)
    batch = enc.encode(rows32)
    t_k1 = bench_kernel(lambda: enc.encode(rows32), 5)
    say(f"time [{card}]: K1 through the Ligero encode of one interior 2^{ST_LOG2} commit batch "
        f"({rows_b}, {n_cols}, 16), n_nonzero {n_per_row}: {t_k1:.3f} ms "
        f"({len(streamed._row_batches(n_rows, spec.repr_bytes, rows_b))} batches a commit)")
    padded = rows32.new_zeros((rows_b, n_cols, L))
    padded[:, :n_per_row] = rows32
    del rows32
    time_ntt_routes(res, card, spec, padded, n_per_row, f"one 2^{ST_LOG2} commit batch",
                    check_rows=2)
    del padded
    free_device(dev)
    total = -(-(32 + n_rows * spec.repr_bytes) // 1024)
    cvs = torch.zeros((n_cols, total, 8), dtype=torch.int32, device=dev)
    cvs_plain = cvs.clone()
    blake3.chunk_cvs(batch, spec, cvs, 1, False)
    blake3.chunk_cvs_plain(batch, spec, cvs_plain, 1, False)
    res.compare("blake3_chunk_cvs", f"an interior 2^{ST_LOG2} batch ({rows_b}, {n_cols}, 16)",
                cvs, cvs_plain)
    del cvs_plain
    res.bound["blake3_chunk_cvs"] = chunk_cvs_cost(rows_b, n_cols, spec.repr_bytes).bound_ms()
    timed_pair(res, "blake3_chunk_cvs", lambda: blake3.chunk_cvs(batch, spec, cvs, 1, False),
               lambda: blake3.chunk_cvs_plain(batch, spec, cvs, 1, False),
               f"({rows_b}, {n_cols}, 16) -> ({n_cols}, 1, 8)", card, plain_runs=1)
    del batch
    free_device(dev)
    cvs = torch.randint(-(1 << 31), (1 << 31) - 1, cvs.shape, dtype=torch.int32, device=dev)
    res.compare("blake3_merge_cvs", f"({n_cols}, {total}, 8)", blake3.merge_cvs(cvs),
                blake3.merge_cvs_plain(cvs))
    res.bound["blake3_merge_cvs"] = merge_cvs_cost(n_cols, total).bound_ms()
    timed_pair(res, "blake3_merge_cvs", lambda: blake3.merge_cvs(cvs),
               lambda: blake3.merge_cvs_plain(cvs), f"({n_cols}, {total}, 8) -> ({n_cols}, 8)",
               card, plain_runs=1)
    del cvs, host, host3
    free_device(dev)


# --------------------------------------------------------------------------
# the proof-of-storage layer
# --------------------------------------------------------------------------

POS_SIZE = 1 << 30            # the pos phase's file: 1 GiB of writeable_ft63 data, square dims
POS_DOWNLOAD_SIZE = 1 << 28   # the unchunked upload and download (a whole file travels as hex)
POS_SMALL_SIZE = 1 << 24      # the pos_small lifecycle: dims (1171, 2048, 4096)
POS_DISK_PER_BYTE = 13        # the quadruple (5.6x the file), an edit's and an append's clone,
POS_DISK_EXTRA = 2 << 30      # the client's copy; plus the 256 MiB file's round trip


def check_pos_kernels(res: Results, dev, card: str) -> None:
    """K4's inverse entry against intt_plain on the card, bit-exact, on five
    fields at n = 2^4, 2^8, 2^14, 2^15 (batch 1 and 128) and 2^20 (batch 1,
    and 128 for the 4-limb fields: the plain version's int64 intermediates
    of 128 rows of 8 or 16 limbs pass the card's memory); intt(ntt(x)) == x;
    K1 against ntt_plain at the PoS sizes with n_nonzero = n/2; K4 inverse
    timed at (128, 32768, 16) ft255 beside K1 and at the client's
    (1, 32768, 4) writeable_ft63 decode."""
    import numpy as np
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import (FT63, FT127, FT253_192, FT255,
                                                        WRITEABLE_FT63)
    from lcpc_proof_of_storage_tpu_torch.ops import ntt
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import bench_kernel, ntt_cost

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    for spec in (FT63, WRITEABLE_FT63, FT127, FT255, FT253_192):
        for log_n in (4, 8, 14, 15, 20):
            n = 1 << log_n
            tables = ntt.NttTables(spec, n).to(dev)
            batches = (1, 128) if log_n < 20 or spec.num_limbs16 == 4 else (1,)
            for batch in batches:
                x = random_limbs_device(gen, (batch, n), spec, dev)
                res.compare("ntt_inverse", f"{spec.name} batch={batch} n=2^{log_n}",
                            ntt.intt(x, spec, tables), ntt.intt_plain(x, spec, tables),
                            quiet=log_n < 14)
                del x
            x = random_limbs_device(gen, (4, n), spec, dev)
            res.compare("ntt_inverse", f"{spec.name} intt(ntt(x)) == x at n=2^{log_n}",
                        ntt.intt(ntt.ntt(x, spec, tables=tables), spec, tables), x, quiet=True)
            del x, tables
            free_device(dev)
    say("kernel ntt_inverse: intt(ntt(x)) == x on the card for every field and size above")
    for spec in (WRITEABLE_FT63, FT253_192, FT255):
        for log_n in (8, 10, 14, 15):
            n = 1 << log_n
            tables = ntt.NttTables(spec, n).to(dev)
            x = random_limbs_device(gen, (128, n), spec, dev)
            x[:, n // 2:] = 0
            res.compare("ntt", f"{spec.name} batch=128 n=2^{log_n} n_nonzero={n // 2} (PoS)",
                        ntt.ntt(x, spec, n // 2, tables), ntt.ntt_plain(x, spec, n // 2, tables))
    free_device(dev)

    for spec, batch, n, what in ((FT255, 128, 1 << 15, "beside K1's Ligero 2^20 row"),
                                 (WRITEABLE_FT63, 1, 1 << 15, "the client's PoS decode")):
        L = spec.num_limbs16
        tables = ntt.NttTables(spec, n).to(dev)
        x = random_limbs_device(gen, (batch, n), spec, dev)
        b = ntt_cost(batch, n, L, n.bit_length() - 1, scale=True).bound_ms()
        k = min(bench_kernel(lambda: ntt.intt(x, spec, tables)) for _ in range(2))
        p = bench_kernel(lambda: ntt.intt_plain(x, spec, tables), 2)
        say(f"time [{card}]: ntt_inverse ({batch}, {n}, {L}) {spec.name} ({what}): kernel "
            f"{k:.4f} ms, plain {p:.3f} ms, bound {b[0]:.4f} ms ({b[1]}); {plan_text(n)}")
        if batch == 1:   # the PoS path's shape is the kernel line's
            res.ms["ntt_inverse"], res.plain_ms["ntt_inverse"] = k, p
            res.bound["ntt_inverse"] = b
        else:
            kf = bench_kernel(lambda: ntt.ntt(x, spec, tables=tables))
            bf = ntt_cost(batch, n, L, n.bit_length() - 1).bound_ms()
            say(f"time [{card}]: ntt ({batch}, {n}, {L}) {spec.name}, n_nonzero={n}, the same "
                f"inputs: kernel {kf:.4f} ms, bound {bf[0]:.4f} ms ({bf[1]})")
        del x, tables
    # K4's forward half is K1 at the PoS writer's shape: one interior batch
    # of the 1 GiB file (512 rows of n_enc = 2^15, n_nonzero = n_pre = 2^14)
    spec, batch, n = WRITEABLE_FT63, 512, 1 << 15
    tables = ntt.NttTables(spec, n).to(dev)
    x = random_limbs_device(gen, (batch, n), spec, dev)
    x[:, n // 2:] = 0
    res.compare("ntt", f"{spec.name} batch={batch} n=2^15 n_nonzero={n // 2} (one PoS writer "
                f"batch)", ntt.ntt(x, spec, n // 2, tables), ntt.ntt_plain(x, spec, n // 2, tables))
    b = ntt_cost(batch, n, spec.num_limbs16, n.bit_length() - 2).bound_ms()
    k = min(bench_kernel(lambda: ntt.ntt(x, spec, n // 2, tables)) for _ in range(2))
    p = bench_kernel(lambda: ntt.ntt_plain(x, spec, n // 2, tables), 2)
    say(f"time [{card}]: ntt ({batch}, {n}, 4) {spec.name} n_nonzero={n // 2} (K4's forward "
        f"half, one PoS writer batch): kernel {k:.4f} ms, plain {p:.3f} ms, bound {b[0]:.4f} ms "
        f"({b[1]}); {plan_text(n)}")
    del x, tables
    free_device(dev)
    check_pos_path_kernels(res, dev, card, gen)


def check_pos_path_kernels(res: Results, dev, card: str, gen) -> None:
    """K3p, chunk CVs and merge at the shapes the 1 GiB file's path gives
    them, against their plain versions: one left-multiply batch of the
    evaluation (raw data bytes as 16-bit limbs, T = 1, an accumulator), and
    the writer's whole batch sequence of chunk CVs (508 rows to the first
    chunk boundary within 512, then 512-row batches, then the tail: all 74
    chunks of a column) and their merge."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import WRITEABLE_FT63
    from lcpc_proof_of_storage_tpu_torch.fields.limb import narrow_limbs
    from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse
    from lcpc_proof_of_storage_tpu_torch.pos import online
    from lcpc_proof_of_storage_tpu_torch.pos.file_handler import LEFT_MULTIPLY_BYTES
    from lcpc_proof_of_storage_tpu_torch.pos.storage import (aligned_batches, ceildiv,
                                                             data_bytes_to_limbs, target_rows)
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import bench_kernel, collapse_cost

    spec = WRITEABLE_FT63
    L, W, cap = spec.num_limbs16, spec.repr_bytes, spec.data_byte_capacity
    n_pre, n_enc, n_rows = online.get_aspect_ratio_default_from_file_len(POS_SIZE, spec)
    rows_b = LEFT_MULTIPLY_BYTES // (n_pre * cap)
    data = torch.randint(0, 256, (rows_b * n_pre * cap,), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    mat = narrow_limbs(data_bytes_to_limbs(data, spec)).view(rows_b, n_pre, L)
    t = random_limbs_device(gen, (1, rows_b), spec, dev)
    acc = random_limbs_device(gen, (1, n_pre), spec, dev)
    res.compare("collapse_acc", f"one 1 GiB PoS left-multiply batch ({rows_b}, {n_pre}, {L}) "
                f"16-bit, T=1, + acc", collapse.collapse(mat, t, spec, acc=acc),
                collapse.collapse_plain(mat, t, spec, acc=acc))
    k = min(bench_kernel(lambda: collapse.collapse(mat, t, spec, acc=acc)) for _ in range(2))
    p = bench_kernel(lambda: collapse.collapse_plain(mat, t, spec, acc=acc), 2)
    b = collapse_cost(rows_b, n_pre, L, 1, 16, True).bound_ms()
    say(f"time [{card}]: collapse_acc ({rows_b}, {n_pre}, {L}) 16-bit T=1 + acc (one PoS "
        f"left-multiply batch): kernel {k:.4f} ms, plain {p:.3f} ms, bound {b[0]:.4f} ms "
        f"({b[1]})")
    del data, mat, t, acc
    free_device(dev)

    batches = aligned_batches(0, n_rows, W, target_rows(n_enc, spec))
    total = ceildiv(32 + n_rows * W, 1024)
    cvs = torch.zeros((n_enc, total, 8), dtype=torch.int32, device=dev)
    cvs_plain = cvs.clone()
    for s, e in batches:
        rows = random_limbs_device(gen, (e - s, n_enc), spec, dev)
        chunk0 = 0 if s == 0 else (32 + s * W) // 1024
        blake3.chunk_cvs(rows, spec, cvs, chunk0, s == 0)
        blake3.chunk_cvs_plain(rows, spec, cvs_plain, chunk0, s == 0)
    sizes = sorted({e - s for s, e in batches})
    res.compare("blake3_chunk_cvs", f"the 1 GiB PoS writer's {len(batches)} batches of "
                f"{n_rows} rows (sizes {sizes}), {n_enc} columns, {total} chunks a column",
                cvs, cvs_plain)
    res.compare("blake3_merge_cvs", f"the 1 GiB PoS writer's ({n_enc}, {total}, 8)",
                blake3.merge_cvs(cvs), blake3.merge_cvs_plain(cvs))
    del cvs, cvs_plain, rows
    free_device(dev)


class PosRun:
    """An in-process port server on a random localhost port and the port's
    client, both on `dev`, run in one event loop; times every step."""

    def __init__(self, base, dev):
        self.base = base
        self.dev = dev
        self.times: dict[str, float] = {}

    async def start(self):
        from lcpc_proof_of_storage_tpu_torch.pos.database import MetadataStore
        from lcpc_proof_of_storage_tpu_torch.pos.networking.client import ClientSession
        from lcpc_proof_of_storage_tpu_torch.pos.networking.server import serve
        self.server = await serve(0, base=self.base / "srv", db_path=str(self.base / "srv_db"),
                                  device=self.dev)
        port = self.server.sockets[0].getsockname()[1]
        self.session = await ClientSession.connect(f"127.0.0.1:{port}",
                                                   MetadataStore(self.base / "client_db"),
                                                   device=self.dev)

    async def stop(self):
        await self.session.close()
        self.server.close()
        await self.server.wait_closed()

    async def step(self, name: str, coro):
        import torch
        t0 = time.perf_counter()
        out = await coro
        torch.cuda.synchronize()
        self.times[name] = time.perf_counter() - t0
        return out

    def paths(self, meta):
        from lcpc_proof_of_storage_tpu_torch.pos.storage import file_paths
        return file_paths(meta.id_ulid, self.base / "srv")

    async def corrupt_and_fail(self, meta, name: str):
        """Flip one bit of a challenged column in the stored .porenc: the
        next proof must fail."""
        from lcpc_proof_of_storage_tpu_torch.pos import online
        col = online.get_column_indices_from_random_seed(
            online.FIXED_RANDOM_SEED_CHANGE_LATER,
            online.get_pos_soundness_n_cols(meta.num_columns, meta.num_encoded_columns),
            meta.num_encoded_columns)[0]
        enc = self.paths(meta)["enc"]
        row_capacity = enc.stat().st_size // (meta.num_encoded_columns * 8)
        off = col * row_capacity * 8 + 5
        with open(enc, "r+b") as f:
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ 0x10]))
        try:
            await self.step(name, self.session.request_and_verify_proof(meta))
        except online.VerificationError:
            return
        raise AssertionError(f"a proof over a corrupted .porenc (column {col}) verified")


def pos_file(path, size: int, seed: int) -> bytes:
    data = __import__("numpy").random.default_rng(seed).bytes(size)
    path.write_bytes(data)
    return data


def pos_small(res: Results, dev, card: str) -> None:
    """A 16 MiB writeable_ft63 file, dims (1171, 2048, 4096), through the
    whole lifecycle on the card: chunked upload with the client's leaves
    precompute, proof, polynomial evaluation, a row request, edit, append,
    reshape, unchunked upload and download, a corrupted .porenc, delete.
    The root and the .portree equal those the writer gives on the CPU (the
    plain versions) for the same bytes, which launches no kernel; the
    evaluation vector of the uploaded file equals the one a CPU handler
    computes; the row generator's root on the card (its Merkle layers by
    K2's parents) equals its root on the CPU."""
    import asyncio
    import shutil
    import tempfile
    from lcpc_proof_of_storage_tpu_torch.fields import WRITEABLE_FT63
    from lcpc_proof_of_storage_tpu_torch.pos import online
    from lcpc_proof_of_storage_tpu_torch.pos.file_handler import FileHandler
    from lcpc_proof_of_storage_tpu_torch.pos.networking import shared
    from lcpc_proof_of_storage_tpu_torch.pos.row_generator import RowGenerator
    from lcpc_proof_of_storage_tpu_torch.pos.storage import EncodedFileWriter, file_paths

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_pos_small_"))
    try:
        src = base / "small.bin"
        data = pos_file(src, POS_SMALL_SIZE, SEED + 16)
        run = PosRun(base, dev)
        out = {}
        edit_at = POS_SMALL_SIZE // 3 + 1

        async def scenario():
            await run.start()
            s = run.session
            try:
                meta = out["meta"] = await run.step("upload (chunked)",
                                                    s.upload_file(src, use_chunks=True))
                out["tree"] = run.paths(meta)["tree"].read_bytes()
                out["enc"] = run.paths(meta)["enc"].read_bytes()
                for key, path in file_paths(meta.id_ulid, base / "copy").items():
                    shutil.copyfile(run.paths(meta)[key], path)
                await run.step("proof", s.request_and_verify_proof(meta))
                await run.step("evaluation", s.request_and_verify_polynomial(meta))
                row = await run.step("row", s.rpc(shared.request_file_row(meta, 7)))
                row_bytes = meta.num_columns * WRITEABLE_FT63.data_byte_capacity
                if bytes.fromhex(row["row"]) != data[7 * row_bytes: 8 * row_bytes]:
                    raise AssertionError("RequestFileRow returned other bytes")
                meta = await run.step("edit", s.edit_file(meta, edit_at, b"edited on the card"))
                meta = await run.step("append", s.append_to_file(meta, b"appended" * 1000))
                meta = await run.step("reshape", s.reshape_file(meta, 1024, 2048))
                want = bytearray(data)
                want[edit_at:edit_at + 18] = b"edited on the card"
                want += b"appended" * 1000
                got = await run.step("download", s.download_file(meta))
                if got != bytes(want):
                    raise AssertionError("the downloaded file differs from the edited bytes")
                whole = await run.step("upload (whole)", s.upload_file(src))
                if whole.root != out["meta"].root:
                    raise AssertionError("whole and chunked uploads gave different roots")
                await run.corrupt_and_fail(meta, "corrupted proof")
                await run.step("delete", s.delete_file(meta))
                await run.step("delete (whole)", s.delete_file(whole))
            finally:
                await run.stop()

        launches = launches_of(lambda: asyncio.run(scenario()))
        res.add_launches("pos_small_16MiB", launches)
        meta = out["meta"]
        missing = [k for k in ("ntt", "ntt_inverse", "collapse_acc", "blake3_chunk_cvs",
                               "blake3_merge_cvs", "blake3_tree") if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the 16 MiB lifecycle: {missing}")
        cpu = {}

        def cpu_write():
            cpu["meta"], cpu["tree"] = EncodedFileWriter.convert_unencoded_file(
                src, base / "cpu.porenc", base / "cpu.portree", None, meta.num_columns,
                meta.num_encoded_columns, WRITEABLE_FT63, device="cpu")

        cpu_launches = launches_of(cpu_write)
        if any(cpu_launches.values()):
            raise AssertionError(f"the CPU writer launched kernels: {cpu_launches}")
        if ((base / "cpu.portree").read_bytes() != out["tree"] or cpu["tree"].root() != meta.root
                or (base / "cpu.porenc").read_bytes() != out["enc"]):
            raise AssertionError("the card's .porenc, .portree or root differs from the CPU "
                                 "writer's")
        # the evaluation vector the card's server computes for the uploaded
        # file (K3p, then K1), against a CPU handler on the same quadruple
        left, _ = online.form_side_vectors(123456789, meta.num_rows, meta.num_encoded_columns)
        evals = {d: FileHandler.attach(meta.id_ulid, WRITEABLE_FT63, base=base / "copy",
                                       device=d).verifiable_polynomial_evaluation(left)
                 for d in (dev, "cpu")}
        if evals[dev] != evals["cpu"]:
            raise AssertionError("the card's evaluation vector differs from the CPU handler's")
        api_launches = launches_of(lambda: pos_row_column_api(base, meta, data, dev))
        res.add_launches("pos_small_16MiB_row_column_api", api_launches)
        missing = [k for k in ("ntt", "blake3_chunk_cvs", "blake3_merge_cvs", "blake3_tree")
                   if api_launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched by the row and column API: {missing}")
        vals = [int(v) for v in __import__("numpy").random.default_rng(SEED + 17).integers(
            0, WRITEABLE_FT63.modulus, 200 * 2048, dtype="uint64")]
        roots = {}
        gen_launches = launches_of(lambda: roots.__setitem__(dev, RowGenerator(
            vals, 2048, 4096, WRITEABLE_FT63, device=dev).convert_to_commit_root()))
        roots["cpu"] = RowGenerator(vals, 2048, 4096, WRITEABLE_FT63,
                                    device="cpu").convert_to_commit_root()
        if roots[dev] != roots["cpu"] or gen_launches["blake3_tree"] == 0:
            raise AssertionError(f"the row generator's root on the card differs from the CPU's, "
                                 f"or its tree was not built by K2's tree: {gen_launches}")
        say(f"pos_small: the evaluation vector ({len(evals[dev])} values) equals the CPU "
            f"handler's; the row generator's root (200 rows) equals the CPU's, launches "
            f"{ {k: v for k, v in gen_launches.items() if v} }")
        say(f"pos_small: 16 MiB, dims ({meta.num_rows}, {meta.num_columns}, "
            f"{meta.num_encoded_columns}); upload, proof, evaluation, row, edit, append, "
            f"reshape, download, whole upload verified, the corrupted .porenc failed its proof; "
            f"root {meta.root.hex()[:16]}..., .porenc and .portree equal the CPU writer's (no kernel "
            f"launched on the CPU); launches {launches}")
        say(f"time [{card}]: pos_small " + ", ".join(f"{k} {v:.3f} s"
                                                      for k, v in run.times.items()))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    free_device(dev)


def pos_row_column_api(base, meta, data: bytes, dev) -> None:
    """The row and column API on the card, on the copy of the uploaded
    quadruple under base/copy: a row replaced by its own bytes (K1) leaves
    the recalculated root (K2's chunk CVs, merge and tree); by new bytes,
    the recalculated tree equals a fresh writer's over the edited raw bytes
    and the one-shot commit's; the handler's digests and the server's
    retrieved columns agree with that tree (paths checked with and without
    the full columns)."""
    import numpy as np
    from lcpc_proof_of_storage_tpu_torch.fields import WRITEABLE_FT63
    from lcpc_proof_of_storage_tpu_torch.pos import online
    from lcpc_proof_of_storage_tpu_torch.pos.file_handler import FileHandler
    from lcpc_proof_of_storage_tpu_torch.pos.storage import EncodedFileWriter

    spec = WRITEABLE_FT63
    fh = FileHandler.attach(meta.id_ulid, spec, base=base / "copy", device=dev)
    n_pre, n_enc = fh.pre_encoded_size, fh.encoded_size
    row_b, r = fh.row_data_bytes, 5
    fh.reader.replace_row_with_decoded_bytes(r, data[r * row_b:(r + 1) * row_b])
    fh.reader.flush()
    if fh.recalculate_merkle_tree().root() != meta.root:
        raise AssertionError("a row replaced by its own bytes changed the recalculated root")
    new = np.random.default_rng(SEED + 18).integers(0, 256, row_b, dtype=np.uint8).tobytes()
    fh.reader.replace_row_with_decoded_bytes(r, new)
    fh.reader.flush()
    tree = fh.recalculate_merkle_tree()
    edited = data[:r * row_b] + new + data[(r + 1) * row_b:]
    (base / "edited.bin").write_bytes(edited)
    _, fresh = EncodedFileWriter.convert_unencoded_file(
        base / "edited.bin", base / "edited.porenc", None, None, n_pre, n_enc, spec, device=dev)
    comm = online.commit_file_data(edited, n_pre, n_enc, spec, dev)
    if not (tree.digests == fresh.digests
            and comm.get_root().root == tree.root() == fh.get_commit_root()):
        raise AssertionError("the recalculated tree differs from a fresh writer's or the "
                             "one-shot commit's over the edited bytes")
    need = online.get_pos_soundness_n_cols(n_pre, n_enc)
    cols = online.get_column_indices_from_random_seed(SEED, need, n_enc)
    digests = fh.read_only_digests(cols)
    columns = online.server_retrieve_columns(comm, cols)
    if ([online.hash_column_to_digest(c, spec) for c in columns] != digests
            or digests != [tree[c] for c in cols]):
        raise AssertionError("the handler's digests, the retrieved columns and the tree differ")
    online.verify_column_paths(tree.root(), cols, columns, spec)
    online.client_verify_commitment_without_full_columns(
        tree.root(), digests, cols, digests, [c.path for c in columns], need)
    if fh.get_encoded_row(r).shape != (n_enc, spec.num_limbs16):
        raise AssertionError("get_encoded_row's shape")
    say(f"pos_small: row and column API on the card: row {r} replaced by its own bytes keeps "
        f"the root, by new bytes gives the root {tree.root().hex()[:16]}... of a fresh writer "
        f"and of the one-shot commit; {need} columns' digests and paths agree with the tree")


def pos_path(res: Results, dev, card: str) -> None:
    """The PoS layer at its real size: a 1 GiB seeded writeable_ft63 file,
    square dims (9363, 16384, 32768), 309 challenged columns.  Chunked
    upload (64 KiB chunks; the client's leaves precompute and its 309-column
    check), proof, polynomial evaluation (K3p and K1 on the server, K4's
    inverse on the client), a row request, one edit and one append (each
    verified and accepted), a flipped byte in the stored .porenc that the
    next proof rejects, delete; then a 256 MiB file uploaded whole and
    downloaded, byte for byte.  Reshape is left out at this size: the
    server evaluates the whole file as Python ints there (server.py
    h_request_reshape_eval)."""
    import asyncio
    import shutil
    import tempfile
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import WRITEABLE_FT63
    from lcpc_proof_of_storage_tpu_torch.pos.networking import shared
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import GLOBAL_PHASES

    def spans():
        """The phase spans since the last call, then cleared."""
        out = {f"{a}/{b}": (t, GLOBAL_PHASES.counts[(a, b)])
               for (a, b), t in sorted(GLOBAL_PHASES.totals.items())}
        GLOBAL_PHASES.totals.clear()
        GLOBAL_PHASES.counts.clear()
        return out

    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    size = POS_SIZE
    while size > POS_SMALL_SIZE and POS_DISK_PER_BYTE * size + POS_DISK_EXTRA > free:
        size //= 2
    say(f"pos: {free / 1e9:.1f} GB free in {tmp}; file size {size} bytes"
        + ("" if size == POS_SIZE else f" (cut from {POS_SIZE}: the disk)"))
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_pos_"))
    try:
        t0 = time.perf_counter()
        src = base / "big.bin"
        pos_file(src, size, SEED)
        src2 = base / "download.bin"
        data2 = pos_file(src2, POS_DOWNLOAD_SIZE, SEED + 1)
        say(f"pos: seeded files written in {time.perf_counter() - t0:.1f} s (set-up)")
        free_device(dev)
        run = PosRun(base, dev)
        out = {}

        async def scenario():
            await run.start()
            s = run.session
            try:
                meta = out["meta"] = await run.step("upload (chunked)",
                                                    s.upload_file(src, use_chunks=True))
                await run.step("proof", s.request_and_verify_proof(meta))
                await run.step("evaluation", s.request_and_verify_polynomial(meta))
                row_i = meta.num_rows // 2
                row = await run.step("row", s.rpc(shared.request_file_row(meta, row_i)))
                row_bytes = meta.num_columns * WRITEABLE_FT63.data_byte_capacity
                with open(src, "rb") as f:
                    f.seek(row_i * row_bytes)
                    if bytes.fromhex(row["row"]) != f.read(row_bytes):
                        raise AssertionError("RequestFileRow returned other bytes")
                spans()
                meta = await run.step("edit", s.edit_file(meta, size // 3, b"edited at 1 GiB"))
                out["edit spans"] = spans()
                meta = out["final"] = await run.step("append",
                                                     s.append_to_file(meta, b"appended" * 4096))
                out["append spans"] = spans()
                await run.corrupt_and_fail(meta, "corrupted proof")
                await run.step("delete", s.delete_file(meta))
                m2 = out["m2"] = await run.step("upload (whole, 256 MiB)", s.upload_file(src2))
                got = await run.step("download (256 MiB)", s.download_file(m2))
                if got != data2:
                    raise AssertionError("the downloaded 256 MiB file differs")
                await run.step("delete (256 MiB)", s.delete_file(m2))
            finally:
                await run.stop()

        launches = launches_of(lambda: asyncio.run(scenario()))
        res.add_launches(f"pos_{size >> 20}MiB", launches)
        missing = [k for k in ("ntt", "ntt_inverse", "collapse_acc", "blake3_chunk_cvs",
                               "blake3_merge_cvs", "blake3_tree") if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the pos path: {missing}")
        meta, m2 = out["meta"], out["m2"]
        say(f"pos: {size} bytes, dims ({meta.num_rows}, {meta.num_columns}, "
            f"{meta.num_encoded_columns}), root {meta.root.hex()[:16]}...; upload, proof, "
            f"evaluation, row, edit and append verified, the corrupted .porenc failed its "
            f"proof; 256 MiB dims ({m2.num_rows}, {m2.num_columns}, {m2.num_encoded_columns}) "
            f"uploaded whole and downloaded equal; launches {launches}")
        say(f"time [{card}]: pos " + ", ".join(f"{k} {v:.3f} s" for k, v in run.times.items())
            + f"; chunked upload {size / run.times['upload (chunked)'] / 1e6:.1f} MB/s; "
            f"{device_memory_line(dev)}")
        for op in ("edit", "append"):
            say(f"time [{card}]: pos {op} split (phase spans, wall s, count): " + "; ".join(
                f"{k} {t} ({n})" for k, (t, n) in out[f"{op} spans"].items()))
        pos_upload_legs(src, meta, base / "legs.porenc", dev, card,
                        run.times["upload (chunked)"])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    free_device(dev)


def pos_upload_legs(src, meta, enc_path, dev, card: str, upload_s: float) -> None:
    """The chunked upload's two device legs, run alone on the same file
    after the lifecycle: the client's leaves precompute of the challenged
    columns, and the writer (encode, column digests, and the transpose to
    column-major bytes with its copy into the mapped .porenc, timed apart).
    The rest of the upload is the wire: 64 KiB chunks as hex JSON, the raw
    file's appends and the proof check."""
    import torch
    from lcpc_proof_of_storage_tpu_torch.fields import WRITEABLE_FT63
    from lcpc_proof_of_storage_tpu_torch.pos import online
    from lcpc_proof_of_storage_tpu_torch.pos.storage import EncodedFileWriter

    n_pre, n_enc = meta.num_columns, meta.num_encoded_columns
    cols = online.get_column_indices_from_random_seed(
        online.FIXED_RANDOM_SEED_CHANGE_LATER, online.get_pos_soundness_n_cols(n_pre, n_enc),
        n_enc)
    t0 = time.perf_counter()
    leaves = online.streaming_leaves_for_file(src, n_pre, n_enc, cols, WRITEABLE_FT63, dev)
    t_leaves = time.perf_counter() - t0

    class TimedWriter(EncodedFileWriter):
        write_s = 0.0

        def _write_rows(self, encoded):
            torch.cuda.synchronize()
            t = time.perf_counter()
            super()._write_rows(encoded)
            TimedWriter.write_s += time.perf_counter() - t

    t0 = time.perf_counter()
    _, tree = TimedWriter.convert_unencoded_file(src, enc_path, None, None, n_pre, n_enc,
                                                 WRITEABLE_FT63, device=dev)
    t_writer = time.perf_counter() - t0
    enc_path.unlink()
    if tree.root() != meta.root or [tree[c] for c in cols] != leaves:
        raise AssertionError("the writer's root or the client's leaves differ from the upload's")
    say(f"time [{card}]: pos upload legs alone: client leaves precompute {t_leaves:.3f} s, "
        f"writer {t_writer:.3f} s (of which transpose to column-major bytes, copy to the "
        f"host and strided write {TimedWriter.write_s:.3f} s); the wire and the proof check "
        f"take the rest of the chunked upload's {upload_s:.3f} s")


# --------------------------------------------------------------------------
# generic host digests and the multi-device paths
# --------------------------------------------------------------------------

MESH_SIZES = (3, 4, 8)    # shards on one card; leg (a) at all, the wide legs at powers of two


_POINTS = {}


def full_width_point(name: str, dev):
    """(encoding, coefficients on the card, their ints) of a full-width
    point: "ligero" (rho=1/4 ft255 2^20, dims (128, 8192, 32768)) or
    "brakedown" (SdigCode3 ft255 seed 0 2^21, dims BD_DIMS); built once for
    the digest and mesh phases."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import BrakedownEncoding, LigeroEncoding
    from lcpc_proof_of_storage_tpu_torch.fields import FT255, limbs_to_ints
    if name not in _POINTS:
        import numpy as np
        if name == "ligero":
            length = 1 << LOG2_MAIN
            enc = LigeroEncoding.new(length, FT255, rho=(1, 4))
            if enc.get_dims(length) != (128, 8192, 32768):
                raise AssertionError(f"Ligero 2^{LOG2_MAIN} dims {enc.get_dims(length)}")
        else:
            length = 1 << BD_LOG2
            enc = BrakedownEncoding.new(length, seed=0, field=FT255)
            if enc.get_dims(length) != BD_DIMS:
                raise AssertionError(f"Brakedown 2^{BD_LOG2} dims {enc.get_dims(length)}")
        coeffs_np = random_limbs(np.random.default_rng(SEED + 50 + len(name)), (length,), FT255)
        _POINTS[name] = (enc, torch.from_numpy(coeffs_np).to(dev), limbs_to_ints(coeffs_np))
    return _POINTS[name]


def blake2b_root_plain(comm, spec) -> bytes:
    """Merkle root of an encoded matrix with hashlib.blake2b leaves
    H(0^32 || column reprs) and layers, zero digests past n_cols, one hash a
    call (little-endian fields: a value's repr is its limb buffer)."""
    import numpy as np
    if spec.endianness != "little":
        raise ValueError("blake2b_root_plain reads little-endian reprs")
    cols = np.ascontiguousarray(comm.cpu().numpy().astype("<u2").transpose(1, 0, 2))
    layer = [hashlib.blake2b(bytes(32) + c.tobytes(), digest_size=32).digest() for c in cols]
    layer += [bytes(32)] * ((1 << (len(layer) - 1).bit_length()) - len(layer))
    while len(layer) > 1:
        layer = [hashlib.blake2b(layer[i] + layer[i + 1], digest_size=32).digest()
                 for i in range(0, len(layer), 2)]
    return layer[0]


def digest_path(res: Results, dev, card: str) -> None:
    """Commit, prove and verify with the Blake2b host digest at the two
    full-width points: the encode on the card (K1 / K5, and K3 in prove),
    no K2; the Blake2b and Blake3 commits share one encoded matrix; the root
    equals the one built from that matrix with hashlib.blake2b; verify
    returns the Horner evaluation; the host legs timed."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import commit, prove, serialize_proof, verify
    from lcpc_proof_of_storage_tpu_torch.crypto.digest import (BLAKE2B, column_messages,
                                                               merkle_tree_host)
    from lcpc_proof_of_storage_tpu_torch.core.storage import limb_matrix
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import wall_ms

    for name, kernel in (("ligero", "ntt"), ("brakedown", "expander")):
        enc, coeffs, coeff_ints = full_width_point(name, dev)
        spec, p = enc.spec, enc.spec.modulus
        n_rows, n_per_row, n_cols = enc.get_dims(len(coeff_ints))
        x = (SEED * 7919 + len(name)) % p
        outer, inner = point_tensors(x, n_rows, n_per_row, p)
        out = {}

        def run():
            comm = out["comm"] = commit(coeffs, enc, device=dev, digest="blake2b")
            root = out["root"] = comm.get_root().root
            proof = out["proof"] = prove(comm, outer, enc, transcript(root))
            out["len"] = len(serialize_proof(proof, spec))
            out["value"] = verify(root, outer, inner, proof, enc, transcript(root), device=dev,
                                  digest="blake2b")

        launches = launches_of(run)
        res.add_launches(f"digest_{name}", launches)
        if (not launches[kernel] or not launches["collapse"] or launches["blake3_leaves"]
                or launches["blake3_tree"]):
            raise AssertionError(f"digest {name}: launches {launches}")
        if out["value"] != horner(coeff_ints, x, p):
            raise AssertionError(f"digest {name}: verify returned a wrong evaluation")
        comm, root = out["comm"], out["root"]
        b3 = commit(coeffs, enc, device=dev)
        if not torch.equal(b3.comm, comm.comm):
            raise AssertionError(f"digest {name}: the Blake2b and Blake3 commits' encoded "
                                 f"matrices differ")
        if b3.get_root().root == root:
            raise AssertionError(f"digest {name}: the Blake2b root equals the Blake3 root")
        want = blake2b_root_plain(b3.comm, spec)
        if want != root:
            raise AssertionError(f"digest {name}: root {root.hex()}, hashlib's {want.hex()}")
        say(f"digest {name}: Blake2b root {root.hex()} equals hashlib.blake2b's over the "
            f"Blake3 commit's encoded matrix (the two commits share it); proof {out['len']} "
            f"bytes verified with the Horner evaluation; launches {launches}")

        coeff_mat = limb_matrix(coeffs, enc, dev)[0]
        msgs, leaves = {}, {}
        t_read = wall_ms(lambda: msgs.update(m=column_messages(enc.encode(coeff_mat), spec)),
                         runs=1, warmup=0)
        t_leaves = wall_ms(lambda: leaves.update(v=BLAKE2B.hash_many(msgs["m"])), runs=1,
                           warmup=0)
        t_layers = wall_ms(lambda: merkle_tree_host(leaves["v"], n_cols, BLAKE2B, dev),
                           runs=1, warmup=0)
        b3_root = b3.get_root().root
        runs = {"blake2b": (root, out["proof"]),
                "blake3": (b3_root, prove(b3, outer, enc, transcript(b3_root)))}
        t = {d: (wall_ms(lambda: commit(coeffs, enc, device=dev, digest=d)),
                 wall_ms(lambda: verify(r, outer, inner, pr, enc, transcript(r), device=dev,
                                        digest=d)))
             for d, (r, pr) in runs.items()}
        say(f"time [{card}]: digest {name} {spec.name} ({n_rows}, {n_per_row}, {n_cols}): "
            f"commit Blake2b {t['blake2b'][0]:.3f} ms / Blake3 {t['blake3'][0]:.3f} ms; host "
            f"legs of the Blake2b commit: encode + leaf messages on the card + read back "
            f"{t_read:.3f} ms ({msgs['m'].nbytes} bytes), {n_cols} leaves {t_leaves:.3f} ms, "
            f"Merkle layers {t_layers:.3f} ms; verify Blake2b "
            f"{t['blake2b'][1]:.3f} ms / Blake3 {t['blake3'][1]:.3f} ms (medians of {N_TIMED})")
        del out, b3, msgs, leaves, coeff_mat, runs
        free_device(dev)


class Spy:
    """Records the first call of each kernel wrapper that the multi-device
    modules make, with its arguments, so that the kernel and its plain
    version can run again on that shard's very inputs (:meth:`check`).
    Installed only around the legs; the checks' launches are not counted."""

    def __init__(self):
        from lcpc_proof_of_storage_tpu_torch.codes import ligero
        from lcpc_proof_of_storage_tpu_torch.core import commit, storage
        from lcpc_proof_of_storage_tpu_torch.ops import blake3, collapse, expander, ntt
        from lcpc_proof_of_storage_tpu_torch.parallel import cross_chip_ntt, sharded
        self.calls = {}
        self.sites = [
            (cross_chip_ntt, "ntt", ntt.ntt_plain), (ligero, "ntt", ntt.ntt_plain),
            (cross_chip_ntt, "intt", ntt.intt_plain), (cross_chip_ntt, "mul_mod",
                                                        ntt.mul_mod_plain),
            (commit, "hash_columns", blake3.hash_columns_plain),
            (sharded, "hash_columns", blake3.hash_columns_plain),
            (sharded, "collapse", collapse.collapse_plain),
            (storage, "collapse", collapse.collapse_plain),
            (expander, "gather_matvec", expander.gather_matvec_plain)]
        self.kernel_of = {"ntt": "ntt", "intt": "ntt_inverse", "mul_mod": "mul_mod",
                          "hash_columns": "blake3_leaves", "collapse": "collapse",
                          "gather_matvec": "expander"}
        self._saved = []

    def __enter__(self):
        for module, attr, plain in self.sites:
            kernel = getattr(module, attr)
            self._saved.append((module, attr, kernel))
            setattr(module, attr, self._wrap(kernel, plain, self.kernel_of[attr]))
        return self

    def __exit__(self, *exc):
        for module, attr, kernel in self._saved:
            setattr(module, attr, kernel)
        self._saved = []

    def _wrap(self, kernel, plain, name):
        def spy(*args, **kw):
            key = "collapse_acc" if kw.get("acc") is not None else name
            self.calls.setdefault(key, (kernel, plain, args, kw))
            return kernel(*args, **kw)
        return spy

    def check(self, res: Results, leg: str) -> list[str]:
        """Each recorded kernel call again, against its plain version; the
        record is emptied.  Returns the kernels checked."""
        done = []
        for key, (kernel, plain, args, kw) in sorted(self.calls.items()):
            shape = "x".join(str(s) for s in args[0].shape) if key != "expander" else \
                "x".join(str(s) for s in args[1].shape) + f" rows {args[0].rows}"
            got = kernel(*args, **kw)
            want = plain(*args, **{k: v for k, v in kw.items() if k != "out"})
            res.compare(key, f"{leg}, one shard's call ({shape})", got, want, quiet=True)
            done.append(f"{key} {shape}")
        self.calls = {}
        return done


def mesh_leg(res: Results, spy: Spy, path: str, run, expect: dict) -> dict[str, int]:
    """One leg with the launch counts set to 0 just before and read just
    after (path ``path`` of launches_by_path), the launches at least
    `expect`, then every kernel call recorded on a shard held against its
    plain version."""
    with spy:
        launches = launches_of(run)
    res.add_launches(path, launches)
    short = {k: (launches[k], n) for k, n in expect.items() if launches[k] < n}
    if short:
        raise AssertionError(f"{path}: launches (got, at least) {short}; all {launches}")
    checked = spy.check(res, path)
    say(f"mesh {path}: launches {launches}; bit-exact against plain on one shard: "
        f"{'; '.join(checked)}")
    return launches


def mesh_meshes(dev) -> list:
    import torch
    from lcpc_proof_of_storage_tpu_torch import make_mesh
    meshes = [make_mesh(D, device=dev) for D in MESH_SIZES]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    return meshes


def mesh_tag(mesh) -> str:
    return f"D{mesh.size}" + ("" if len(set(mesh.devices)) == 1 else "_cards")


def mesh_path(res: Results, dev, card: str) -> None:
    """Legs a-g of __graft_entry__.dryrun_multichip at the two full-width
    points, on meshes of 3, 4 and 8 shards on one card (and one shard a card
    where there are several): (a) the row-sharded commit, also at D = 3;
    at power-of-two D (b) the wide commit through the cross-device NTT, (c)
    training_step against the one-device K3 collapse, (d) the wide prove and
    verify, the wide decode through the cross-device inverse, (f) the
    Brakedown row-sharded commit, prove and verify, (g) the Brakedown wide
    commit ((e), the streamed commit, is the streamed_* phases').  Roots and
    proof bytes equal the one-device path's; every kernel call made on a
    shard is held against its plain version on one shard (Spy); launches
    per leg.  The shards share one card: the times are no multi-card
    speed-up."""
    import torch
    from lcpc_proof_of_storage_tpu_torch import (commit, prove, serialize_proof, sharded_commit,
                                                 verify, wide_commit)
    from lcpc_proof_of_storage_tpu_torch.core.storage import limb_matrix
    from lcpc_proof_of_storage_tpu_torch.ops import collapse
    from lcpc_proof_of_storage_tpu_torch.parallel import mesh as pm
    from lcpc_proof_of_storage_tpu_torch.parallel.cross_chip_ntt import split_lengths
    from lcpc_proof_of_storage_tpu_torch.parallel.sharded import training_step
    from lcpc_proof_of_storage_tpu_torch.utils.profiling import wall_ms

    spy = Spy()
    meshes = mesh_meshes(dev)
    say(f"mesh: meshes {[str(m) for m in meshes]}; the shards of a mesh on one card share "
        f"it, so the times below are no multi-card speed-up")
    for name in ("ligero", "brakedown"):
        enc, coeffs, coeff_ints = full_width_point(name, dev)
        spec, p = enc.spec, enc.spec.modulus
        n_rows, n_per_row, n_cols = enc.get_dims(len(coeff_ints))
        x = (SEED * 104729 + len(name)) % p
        outer, inner = point_tensors(x, n_rows, n_per_row, p)
        value = horner(coeff_ints, x, p)
        single = commit(coeffs, enc, device=dev)
        root = single.get_root().root
        blob = serialize_proof(prove(single, outer, enc, transcript(root)), spec)
        t_single = wall_ms(lambda: commit(coeffs, enc, device=dev))
        n_levels = len(enc.encoder.pre) + len(enc.encoder.post) if name == "brakedown" else 0
        times = [f"one device {t_single:.3f} ms"]
        for mesh in meshes:
            D, tag = mesh.size, mesh_tag(mesh)
            out = {}
            encode_kernel = {"ntt": D} if name == "ligero" else {"expander": n_levels}

            def leg_a():
                out["a"] = sharded_commit(coeffs, enc, mesh)
            mesh_leg(res, spy, f"mesh_a_{name}_{tag}", leg_a,
                     {**encode_kernel, "blake3_leaves": D, "blake3_tree": 1})
            if not torch.equal(out["a"].hashes, single.hashes):
                raise AssertionError(f"mesh (a) {name} {tag}: Merkle array differs")
            times.append(f"(a) {tag} {wall_ms(leg_a):.3f} ms")
            if name == "brakedown":
                def leg_f():
                    pr = prove(out["a"], outer, enc, transcript(root))
                    out["f"] = (serialize_proof(pr, spec),
                                verify(root, outer, inner, pr, enc, transcript(root),
                                       device=dev))
                mesh_leg(res, spy, f"mesh_f_{name}_{tag}", leg_f,
                         {"collapse": 1, "expander": n_levels})
                if out["f"] != (blob, value):
                    raise AssertionError(f"mesh (f) {tag}: proof bytes or evaluation differ")
            if D & (D - 1):
                continue
            enc_w = enc.with_mesh(mesh)
            if name == "ligero":
                n1, n2 = split_lengths(n_cols, D)
                if n1 % D or n2 % D:
                    raise AssertionError(f"cross-device split ({n1}, {n2}) at D = {D}")
                say(f"mesh {tag}: n = {n_cols} splits as n1 = {n1}, n2 = {n2}")

            def leg_b():
                out["b"] = commit(coeffs, enc_w)
            wide_kernels = ({"ntt": 2 * D, "mul_mod": D} if name == "ligero"
                            else {"expander": n_levels})
            mesh_leg(res, spy, f"mesh_{'b' if name == 'ligero' else 'g'}_{name}_{tag}", leg_b,
                     {**wide_kernels, "blake3_leaves": D, "blake3_tree": 1})
            if not torch.equal(out["b"].hashes, single.hashes):
                raise AssertionError(f"mesh wide {name} {tag}: Merkle array differs")
            times.append(f"wide {tag} {wall_ms(leg_b):.3f} ms")

            def leg_d():
                pr = prove(out["b"], outer, enc_w, transcript(root))
                out["d"] = (serialize_proof(pr, spec),
                            verify(root, outer, inner, pr, enc_w, transcript(root)))
            mesh_leg(res, spy, f"mesh_d_{name}_{tag}", leg_d,
                     {"collapse": D if n_per_row % D == 0 else 1, **wide_kernels})
            if out["d"] != (blob, value):
                raise AssertionError(f"mesh (d) {name} {tag}: proof bytes or evaluation differ")
            if name == "brakedown":
                continue

            def leg_decode():
                out["dec"] = enc_w.decode(single.comm)
            mesh_leg(res, spy, f"mesh_decode_{name}_{tag}", leg_decode,
                     {"ntt_inverse": 2 * D, "mul_mod": D})
            if (not torch.equal(out["dec"][:, :n_per_row], single.coeffs)
                    or out["dec"][:, n_per_row:].any()):
                raise AssertionError(f"mesh decode {tag}: not the committed coefficients")

            coeff_mat = limb_matrix(coeffs, enc, dev)[0]
            g = torch.Generator(device=dev).manual_seed(SEED + D)
            t = random_limbs_device(g, (2, n_rows), spec, dev)

            def leg_c():
                out["c"] = training_step(enc, mesh)(coeff_mat, t[0], t[1])
            mesh_leg(res, spy, f"mesh_c_{name}_{tag}", leg_c,
                     {"ntt": D, "blake3_leaves": D, "collapse": 1, "collapse_acc": D - 1})
            comm_c, leaves, p_random, p_eval = out["c"]
            want = collapse.collapse(coeff_mat, t, spec)
            if (not torch.equal(pm.gather(comm_c, dev, 1), single.comm)
                    or not torch.equal(leaves, single.hashes[:n_cols])
                    or not torch.equal(p_random, want[0]) or not torch.equal(p_eval, want[1])):
                raise AssertionError(f"mesh (c) {tag}: training_step differs from one device")
            del out, coeff_mat
            free_device(dev)
        say(f"mesh {name}: roots, Merkle arrays, proof bytes ({len(blob)}) and evaluations "
            f"equal the one-device path's on every mesh")
        say(f"time [{card}]: mesh {name} commits (medians of {N_TIMED}), the shards of each "
            f"mesh sharing one card: " + ", ".join(times))
        del single
        free_device(dev)


KERNEL_INFO = {
    "ntt": ("lcpc_proof_of_storage_tpu_torch/csrc/ntt.cu",
            "lcpc_proof_of_storage_tpu/ops/ntt_pallas3.py:546"),
    "ntt_inverse": ("lcpc_proof_of_storage_tpu_torch/csrc/ntt.cu",
                    "lcpc_proof_of_storage_tpu/ops/ntt_pallas2.py:323,348 (inverse)"),
    "blake3_leaves": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                      "lcpc_proof_of_storage_tpu/ops/blake3_pallas.py:139"),
    "blake3_tree": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                    "lcpc_proof_of_storage_tpu/ops/blake3_jax.py:325"),
    "collapse": ("lcpc_proof_of_storage_tpu_torch/csrc/collapse.cu",
                 "lcpc_proof_of_storage_tpu/ops/collapse_pallas.py:279"),
    "collapse_acc": ("lcpc_proof_of_storage_tpu_torch/csrc/collapse.cu",
                     "lcpc_proof_of_storage_tpu/ops/collapse_pallas.py:143"),
    "blake3_chunk_cvs": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                         "lcpc_proof_of_storage_tpu/ops/blake3_jax.py:233"),
    "blake3_merge_cvs": ("lcpc_proof_of_storage_tpu_torch/csrc/blake3.cu",
                         "lcpc_proof_of_storage_tpu/ops/blake3_jax.py:183"),
    "expander": ("lcpc_proof_of_storage_tpu_torch/csrc/expander.cu",
                 "lcpc_proof_of_storage_tpu/ops/expander_pallas.py:388"),
    "ntt_tile": ("lcpc_proof_of_storage_tpu_torch/csrc/ntt_tile.cu",
                 "lcpc_proof_of_storage_tpu/ops/ntt_pallas2.py:435 (K4f); "
                 "lcpc_proof_of_storage_tpu/ops/ntt_pallas2.py:323 (the four-step's first "
                 "pass); lcpc_proof_of_storage_tpu/ops/ntt_pallas.py:308 (K6 fused small)"),
    "mul_mod": ("lcpc_proof_of_storage_tpu_torch/csrc/ntt_tile.cu",
                "lcpc_proof_of_storage_tpu/ops/ntt_pallas.py:367 (K6 scale); "
                "lcpc_proof_of_storage_tpu/ops/ntt_pallas.py:476 (mul_mod_pallas)"),
}


def compare_steps(res: Results, dev, card: str) -> None:
    """Not a phase of main(): ntt_tile_kernels, then the ligero, brakedown,
    brakedown_big and streamed_host phases, the steps to time against an
    older checkout's package in alternating processes (as ntt_tile_kernels
    says), e.g. parent, change, change, parent, change, parent, parent,
    change in one chip call; their host-bound steps spread up to 2x between
    processes."""
    for step in (ntt_tile_kernels, ligero_path, brakedown_path, brakedown_big, streamed_host):
        t0 = time.perf_counter()
        step(res, dev, card)
        say(f"compare_steps {step.__name__}: {time.perf_counter() - t0:.1f} s")


PHASES = (
    ("kernels", lambda res, dev, card: check_kernels(res, dev)),
    ("ntt_routes_kernels", lambda res, dev, card: check_ntt_route_kernels(res, dev)),
    ("expander", lambda res, dev, card: check_expander(res, dev)),
    ("golden", lambda res, dev, card: check_golden(dev)),
    ("verify", lambda res, dev, card: check_verify(dev)),
    ("ligero", ligero_path),
    ("brakedown", brakedown_path),
    ("brakedown_big", brakedown_big),
    ("expander_collapse_kernels", expander_collapse_kernels),
    ("blake3_kernels", blake3_kernels),
    ("digest", digest_path),
    ("mesh", mesh_path),
    ("streamed_kernels", lambda res, dev, card: check_streamed_kernels(res, dev)),
    ("streamed_modes", streamed_modes),
    ("streamed_device", streamed_device),
    ("streamed_host", streamed_host),
    ("pos_kernels", check_pos_kernels),
    ("pos_small", pos_small),
    ("pos", pos_path),
)


def main(argv: list[str] | None = None) -> int:
    import argparse
    names = [name for name, _ in PHASES]
    parser = argparse.ArgumentParser(description="On-card smoke run of the PyTorch / CUDA port.")
    parser.add_argument("--phases", help="comma-separated phases to run, of: "
                        f"{', '.join(names)} (default: all)")
    args = parser.parse_args(argv)
    chosen = names if args.phases is None else args.phases.split(",")
    if set(chosen) - set(names):
        print(f"chip_smoke: unknown phases {sorted(set(chosen) - set(names))}", file=sys.stderr)
        return 2
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
        if ("expander_matvec" in line or "collapse" in line or "ntt_pass" in line
                or "ntt_tile" in line or "mul_mod" in line or "Used" in line
                or ("spill" in line and ", 0 bytes spill stores" not in line)):
            say(f"build: {line.strip()}")
    t0 = time.perf_counter()
    say(f"host library: {'built' if native.native() is not None else 'NOT built: Python fallbacks'}"
        f" in {time.perf_counter() - t0:.1f} s")

    res = Results()
    for name, phase in PHASES:
        if name not in chosen:
            continue
        t0 = time.perf_counter()
        phase(res, dev, card)
        say(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    say(f"total {time.perf_counter() - t_start:.1f} s")

    say(card)
    # every phase fills every key; a run of some phases (--phases) may leave some None
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(res.launches.get(name, {}).values()),
         "launches_by_path": res.launches.get(name, {}), "max_abs_err": res.err.get(name),
         "ms": res.ms.get(name), "plain_ms": res.plain_ms.get(name),
         "bound_ms": res.bound.get(name, (None, None))[0],
         "bound_by": res.bound.get(name, (None, None))[1], "library_ms": None}
        for name, (src, rep) in KERNEL_INFO.items()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
