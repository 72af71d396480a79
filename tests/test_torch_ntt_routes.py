"""The port's four_step and fused_small NTT routes, their tile kernel KT and
modular product KM (plain versions on the CPU), against the JAX package.

- ``ntt_four_step`` against the JAX ``ops/ntt_pallas2.py ntt_four_step``
  (its Pallas kernels in interpret mode), unpruned and pruned, and on ft255
  against the JAX ``ops.ntt.ntt``;
- ``ntt_fused_small`` against the JAX ``ops/ntt_pallas.py ntt_pallas``
  (interpret mode), forward pruned and unpruned and inverse, with a tile
  small enough that the route runs K1's stage launches too;
- ``mul_mod`` against ``mul_mod_pallas`` (interpret mode) and against the
  JAX ``LimbField.mul`` at a ragged N;
- both routes against the port's K1 / K4 plain versions on every field;
- a Ligero commit -> prove -> verify on each route: roots and proof bytes
  equal to the stages route's and to the JAX package's, an over-long proof
  row still rejected with ColumnDegree, a carried commitment verifying under
  every route; the four_step route below its window reaching K1.

All comparisons are exact: integer field arithmetic, no tolerance.  Inputs
are drawn with numpy from fixed seeds.

The JAX package's outputs (its Pallas kernels in interpret mode, its XLA
ops, its Ligero commit and proof) are computed by the ``jax_refs`` fixture
in three worker processes while the port's side of the tests runs: JAX's
tracing holds the GIL, so threads would not overlap it, and one process
takes about twice as long.  Each JAX case sees the same inputs as the port
side; the tests that need a JAX output come last in the file.  The workers
compile with XLA's ``--xla_backend_optimization_level=0``, which only
shortens compiles: every output compared is exact integer arithmetic or
hashing, and does not depend on how XLA optimised the program that
produced it.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import lcpc_proof_of_storage_tpu.ops.ntt_pallas as jax_v1
import lcpc_proof_of_storage_tpu.ops.ntt_pallas2 as jax_v2
from lcpc_proof_of_storage_tpu.codes.ligero import LigeroEncoding as JaxLigero
from lcpc_proof_of_storage_tpu.core import commit as jax_core
from lcpc_proof_of_storage_tpu.crypto.transcript import Transcript as JaxTranscript
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.fields.limb import limb_field as jax_limb_field
from lcpc_proof_of_storage_tpu.ops import ntt as jax_ntt
from lcpc_proof_of_storage_tpu.utils import serde as jax_serde
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.core import commit as port
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT127, FT191, FT253_192, FT255
from lcpc_proof_of_storage_tpu_torch.ops import ntt
from lcpc_proof_of_storage_tpu_torch.utils import serde
from lcpc_proof_of_storage_tpu_torch.utils.carry import commit_from_reference

torch.set_num_threads(1)

JAX_SPECS = {"ft63": jax_field.FT63, "ft255": jax_field.FT255}
FIELDS = [FT63, FT127, FT191, FT255, FT253_192]


def _limbs(spec, shape, seed, n_nonzero=None):
    """Canonical random limbs (the top limb below p's), zero at and past
    n_nonzero along axis 1."""
    rng = np.random.default_rng(seed)
    L = spec.num_limbs16
    x = rng.integers(0, 1 << 16, size=(*shape, L), dtype=np.int64)
    x[..., L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=shape)
    if n_nonzero is not None:
        x[:, n_nonzero:] = 0
    return x.astype(np.int32)


def _jax(x):
    import jax.numpy as jnp
    return jnp.asarray(x.astype(np.uint32))


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


# -- the JAX package's outputs, from worker processes ------------------------------

X = 987654321
FOUR_STEP_CASES = {2048: (None,), 8192: (2048, 50)}


def _four_step_input(n, n_nonzero):
    return _limbs(FT63, (2, n), seed=n + (n_nonzero or 0), n_nonzero=n_nonzero)


def _ligero_coeffs(spec):
    rng = np.random.default_rng(20261017)
    return [int(v) % spec.modulus for v in rng.integers(0, 1 << 63, size=3000)]


def _tr(root, cls=Transcript):
    tr = cls(b"ntt-routes")
    tr.append_message(b"polycommit", root)
    return tr


def _ligero_points(n_rows, n_per_row, p):
    xr = pow(X, n_per_row, p)
    return [pow(xr, i, p) for i in range(n_rows)], [pow(X, j, p) for j in range(n_per_row)]


def _mul_mod_inputs(spec):
    return _limbs(spec, (1001,), seed=11), _limbs(spec, (1001,), seed=12)


# each job: the JAX function and its inputs, longest first (the pool takes them in order)
REF_JOBS = {
    "ligero": ("ligero",),
    "four_step 2048": ("four_step", [_four_step_input(2048, z) for z in FOUR_STEP_CASES[2048]],
                       FOUR_STEP_CASES[2048]),
    "four_step 8192": ("four_step", [_four_step_input(8192, z) for z in FOUR_STEP_CASES[8192]],
                       FOUR_STEP_CASES[8192]),
    "ntt_pallas inverse": ("ntt_pallas", _limbs(FT63, (2, 256), seed=8), None),
    "ntt_pallas pruned": ("ntt_pallas", _limbs(FT63, (2, 256), seed=7, n_nonzero=100), 100),
    "ntt ft255": ("ntt", _limbs(FT255, (2, 2048), seed=5, n_nonzero=600)),
    "limb mul ft63": ("limb_mul", "ft63", *_mul_mod_inputs(FT63)),
    "limb mul ft255": ("limb_mul", "ft255", *_mul_mod_inputs(FT255)),
    "mul_mod_pallas": ("mul_mod_pallas", _limbs(FT63, (1024,), seed=9),
                       _limbs(FT63, (1024,), seed=10)),
}
JAX_CONFIG = ("jax_platforms", "jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_enable_xla_caches")


def _init_worker(config):
    """A worker's JAX as the parent's (CPU, the same compile cache), XLA's
    backend optimisation off (it halves the Ligero commit's compile; integer
    results do not depend on it), and every pl.pallas_call in interpret
    mode."""
    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0").strip()
    import jax
    from jax.experimental import pallas as pl
    for name, value in config.items():
        jax.config.update(name, value)
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = interp


def _jax_reference(job, *args):
    """One REF_JOBS entry's JAX output, as numpy (or, for the Ligero case,
    the commitment, its root and the proof's bytes)."""
    if job == "four_step":
        xs, n_nonzeros = args
        return [np.asarray(jax_v2.ntt_four_step(_jax(x), jax_field.FT63, n_nonzero=z))
                for x, z in zip(xs, n_nonzeros)]
    if job == "ntt_pallas":
        x, n_nonzero = args
        if n_nonzero is None:
            return np.asarray(jax_v1.ntt_pallas(_jax(x), jax_field.FT63, inverse=True))
        return np.asarray(jax_v1.ntt_pallas(_jax(x), jax_field.FT63, n_nonzero=n_nonzero))
    if job == "ntt":
        return np.asarray(jax_ntt.ntt(_jax(args[0]), jax_field.FT255))
    if job == "limb_mul":
        name, a, b = args
        idx = np.concatenate([np.arange(1001) % r for r in (1001, 7, 1)])
        return np.asarray(jax_limb_field(JAX_SPECS[name]).mul(_jax(np.tile(a, (3, 1))),
                                                               _jax(b[idx])))
    if job == "mul_mod_pallas":
        a, b = args
        return np.asarray(jax_v1.mul_mod_pallas(_jax(a), _jax(b), jax_field.FT63))
    assert job == "ligero"
    jspec = jax_field.FT63
    jenc = JaxLigero.new_from_dims(1024, 4096, jspec)
    jcomm = jax_core.commit(_ligero_coeffs(jspec), jenc)
    root = jcomm.get_root().root
    outer, _ = _ligero_points(jcomm.n_rows, jcomm.n_per_row, jspec.modulus)
    jblob = jax_serde.serialize_proof(
        jax_core.prove(jcomm, outer, jenc, _tr(root, JaxTranscript)), jspec)
    return jcomm, root, jblob


@pytest.fixture(scope="module", autouse=True)
def jax_refs():
    """REF_JOBS' outputs as futures, computed in three spawned worker
    processes from the start of the module."""
    import jax
    config = {name: getattr(jax.config, name) for name in JAX_CONFIG}
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init_worker, initargs=(config,)) as pool:
        yield {key: pool.submit(_jax_reference, *job) for key, job in REF_JOBS.items()}


# -- the routes against the port's own plain K1 and K4 --------------------------

@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
@pytest.mark.parametrize("n,n_nonzero", [(256, None), (2048, 700), (4096, 30)])
def test_routes_match_k1_plain(spec, n, n_nonzero):
    """n = 256 is below the four-step's window (the route is K1's); tiles 128
    and 2 leave stages to K1's stage launches."""
    x = _port(_limbs(spec, (2, n), seed=n + (n_nonzero or 1), n_nonzero=n_nonzero))
    want = ntt.ntt_plain(x, spec, n_nonzero)
    fs = ntt.NttTables(spec, n, "four_step")
    fu = ntt.NttTables(spec, n, "fused_small")
    assert torch.equal(ntt.ntt_four_step(x, spec, n_nonzero, fs), want)
    for tile in (ntt.FUSED_TILE, 128, 2):
        assert torch.equal(ntt.ntt_fused_small(x, spec, n_nonzero, fu, tile=tile), want)


@pytest.mark.parametrize("spec", [FT63, FT255], ids=lambda s: s.name)
@pytest.mark.parametrize("route,n_nonzero,want", [
    ("four_step", 700, [(1, 6, False), (0, 5, True)]),
    ("four_step", 30, [(0, 5, True)]),
    ("fused_small", 700, [(1, 11, False)]),
    ("fused_small_tile_128", 700, [(1, 7, False)]),
    ("inverse", None, [(0, 7, False), "mul_mod"]),
])
def test_routes_record_their_kernel_calls(spec, route, n_nonzero, want):
    """Each KT and KM call a route makes is recorded with the very inputs
    the route gave it: running the records again gives what the route's
    launches gave, and each record's plain version the same."""
    n = 2048
    x = _port(_limbs(spec, (2, n), seed=21, n_nonzero=n_nonzero))
    tables = ntt.NttTables(spec, n, "four_step" if route == "four_step" else "fused_small")
    calls = []
    if route == "four_step":
        out = ntt.ntt_four_step(x, spec, n_nonzero, tables, calls=calls)
    elif route == "inverse":
        out = ntt.ntt_fused_small(x, spec, None, tables, inverse=True, tile=128, calls=calls)
    else:
        tile = 128 if route.endswith("128") else ntt.FUSED_TILE
        out = ntt.ntt_fused_small(x, spec, n_nonzero, tables, tile=tile, calls=calls)
    got = ["mul_mod" if isinstance(c, ntt.MulModCall) else (c.s0, c.s1, c.diag) for c in calls]
    assert got == want
    for c in calls:
        assert torch.equal(c(), c.plain())
    last = calls[-1]()
    if route == "four_step":
        assert torch.equal(last.transpose(1, 2).reshape(out.shape), out)
    elif route == "inverse":
        assert torch.equal(last.reshape(out.shape), out)


@pytest.mark.parametrize("spec", FIELDS, ids=lambda s: s.name)
@pytest.mark.parametrize("log_n", [1, 4, 11])
def test_fused_small_inverse_matches_k4_plain(spec, log_n):
    x = _port(_limbs(spec, (3, 1 << log_n), seed=log_n))
    fu = ntt.NttTables(spec, 1 << log_n, "fused_small")
    want = ntt.intt_plain(x, spec)
    for tile in (ntt.FUSED_TILE, 4):
        assert torch.equal(ntt.ntt_fused_small(x, spec, None, fu, inverse=True, tile=tile), want)


def test_tile_stages_take_limbs_or_words():
    spec = FT255
    fs = ntt.NttTables(spec, 2048, "four_step")
    x = _port(_limbs(spec, (2, 2048), seed=13))
    words = ntt.pack_words(x)
    assert torch.equal(ntt.unpack_words(words), x)
    for s0, s1 in ((0, 5), (3, 11)):
        from_limbs = ntt.ntt_tile_stages(x, fs, s0, s1, diag=True)
        assert torch.equal(from_limbs, ntt.ntt_tile_stages(words, fs, s0, s1, diag=True))
        assert torch.equal(ntt.unpack_words(from_limbs),
                           ntt.ntt_tile_stages(x, fs, s0, s1, diag=True, out_limbs=True))


def test_bad_route_arguments_raise():
    x = torch.zeros((2, 2048, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        ntt.NttTables(FT63, 2048, "radix4")
    with pytest.raises(ValueError, match="route"):
        ntt.ntt_four_step(x, FT63, tables=ntt.NttTables(FT63, 2048))
    with pytest.raises(ValueError, match="tile"):
        ntt.ntt_fused_small(x, FT63, tile=8192)
    with pytest.raises(ValueError, match="tile"):
        ntt.ntt_tile_stages(x, ntt.NttTables(FT63, 2048), 0, 12)
    with pytest.raises(ValueError, match="prologue"):
        ntt.ntt_tile_stages(x, ntt.NttTables(FT63, 2048), 0, 3, diag=True)
    with pytest.raises(ValueError, match="mul_mod"):
        ntt.mul_mod(x[0], x[0, :0], FT63)
    with pytest.raises(ValueError, match="ntt must be one of"):
        LigeroEncoding(FT63, 16, 64, ntt="radix4")


def test_four_step_below_its_window_is_k1(monkeypatch):
    """n_cols <= 1024 is outside the reference's four-step window: the route
    is ntt (K1's plain version on the CPU), and KT never runs."""
    calls = []
    plain = ntt.ntt_plain

    def spy(*args, **kw):
        calls.append("ntt_plain")
        return plain(*args, **kw)

    def no_tile(*args, **kw):
        raise AssertionError("KT ran outside the four-step window")

    monkeypatch.setattr(ntt, "ntt_plain", spy)
    monkeypatch.setattr(ntt, "ntt_tile_stages_plain", no_tile)
    enc = LigeroEncoding.new_from_dims(256, 1024, FT63, ntt="four_step")
    assert "ntt=four_step" in repr(enc)
    rows = _port(_limbs(FT63, (3, 256), seed=14))
    assert torch.equal(enc.encode(rows), plain(torch.nn.functional.pad(rows, (0, 0, 0, 768)),
                                                FT63, 256))
    assert calls == ["ntt_plain"]


# -- the routes against the JAX package's kernels -------------------------------

@pytest.mark.parametrize("n,n_nonzeros", [(2048, (None,)), (8192, (2048, 50))],
                         ids=["2048", "8192-pruned"])
def test_four_step_matches_jax_four_step(jax_refs, n, n_nonzeros):
    """At n = 8192, n_nonzero = 2048 prunes two of pass A's stages and
    n_nonzero = 50 <= n1 = 64 leaves pass A with none."""
    assert n_nonzeros == FOUR_STEP_CASES[n]
    _, xs, _ = REF_JOBS[f"four_step {n}"]
    for n_nonzero, x, want in zip(n_nonzeros, xs, jax_refs[f"four_step {n}"].result()):
        assert _same(ntt.ntt_four_step(_port(x), FT63, n_nonzero), want)


def test_four_step_ft255_matches_jax_ntt(jax_refs):
    x = REF_JOBS["ntt ft255"][1]
    assert _same(ntt.ntt_four_step(_port(x), FT255, 600), jax_refs["ntt ft255"].result())


@pytest.mark.parametrize("n_nonzero", [100], ids=["pruned"])
def test_fused_small_matches_jax_ntt_pallas(jax_refs, n_nonzero):
    """A tile of 32 leaves the stages with half 32 .. 128 to K1's launches.
    The unpruned forward route is held to K1's plain version (itself held to
    the JAX package's) in test_routes_match_k1_plain."""
    _, x, ref_n_nonzero = REF_JOBS["ntt_pallas pruned"]
    assert ref_n_nonzero == n_nonzero
    want = jax_refs["ntt_pallas pruned"].result()
    assert _same(ntt.ntt_fused_small(_port(x), FT63, n_nonzero, tile=32), want)


def test_fused_small_inverse_matches_jax_ntt_pallas(jax_refs):
    x = REF_JOBS["ntt_pallas inverse"][1]
    want = jax_refs["ntt_pallas inverse"].result()
    assert _same(ntt.ntt_fused_small(_port(x), FT63, inverse=True, tile=64), want)
    assert _same(ntt.ntt_fused_small(_port(x), FT63, inverse=True), want)


def test_mul_mod_matches_mul_mod_pallas(jax_refs):
    _, a, b = REF_JOBS["mul_mod_pallas"]
    assert _same(ntt.mul_mod(_port(a), _port(b), FT63), jax_refs["mul_mod_pallas"].result())


@pytest.mark.parametrize("name", ["ft63", "ft255"])
def test_mul_mod_ragged_matches_jax_limb_mul(jax_refs, name):
    spec = FT63 if name == "ft63" else FT255
    _, _, a, b = REF_JOBS[f"limb mul {name}"]
    want = jax_refs[f"limb mul {name}"].result()
    for i, r in enumerate((1001, 7, 1)):
        assert _same(ntt.mul_mod(_port(a), _port(b[:r]), spec), want[1001 * i:1001 * (i + 1)])


# -- Ligero commit -> prove -> verify on each route ----------------------------

@pytest.fixture(scope="module")
def ligero_case(jax_refs):
    """One seeded ft63 input at n_cols = 4096 (rho = 1/4), committed and
    proved by the JAX package."""
    spec = FT63
    coeffs = _ligero_coeffs(spec)
    jcomm, root, jblob = jax_refs["ligero"].result()
    p = spec.modulus
    outer, inner = _ligero_points(jcomm.n_rows, jcomm.n_per_row, p)
    value = sum(c * pow(X, i, p) for i, c in enumerate(coeffs)) % p
    return dict(spec=spec, coeffs=coeffs, jcomm=jcomm, root=root, outer=outer, inner=inner,
                jblob=jblob, value=value)


@pytest.mark.parametrize("route", ["stages", "four_step", "fused_small"])
def test_ligero_roots_and_proofs_equal_across_routes(ligero_case, route):
    case = ligero_case
    enc = LigeroEncoding.new_from_dims(1024, 4096, FT63, ntt=route)
    comm = port.commit(case["coeffs"], enc, device="cpu")
    assert comm.get_root().root == case["root"]
    proof = port.prove(comm, case["outer"], enc, _tr(case["root"]))
    assert serde.serialize_proof(proof, FT63) == case["jblob"]
    assert port.verify(case["root"], case["outer"], case["inner"], proof, enc,
                       _tr(case["root"]), device="cpu") == case["value"]
    decoded = enc.decode(comm.comm)
    assert torch.equal(decoded[:, :1024], comm.coeffs) and not decoded[:, 1024:].any()

    # an over-long degree-test row: the re-encode reads every coefficient
    bad = serde.deserialize_proof(case["jblob"], FT63)
    bad.p_random_vec[0].append(5)
    with pytest.raises(port.VerifierError) as err:
        port.verify(case["root"], case["outer"], case["inner"], bad, enc, _tr(case["root"]),
                    device="cpu")
    assert err.value.kind == "ColumnDegree"


@pytest.mark.parametrize("route", ["four_step", "fused_small"])
def test_carried_commitment_verifies_under_each_route(ligero_case, route):
    case = ligero_case
    enc = LigeroEncoding.new_from_dims(1024, 4096, FT63, ntt=route)
    comm = commit_from_reference(case["jcomm"], device="cpu")
    proof = port.prove(comm, case["outer"], enc, _tr(case["root"]))
    assert serde.serialize_proof(proof, FT63) == case["jblob"]
    assert port.verify(case["root"], case["outer"], case["inner"], proof, enc,
                       _tr(case["root"]), device="cpu") == case["value"]
