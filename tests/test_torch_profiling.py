"""The port's utils/profiling.py and the prove / verify phase spans.

- prove and verify of a small Ligero (ft255, 2^10) and a small Brakedown
  (ft63, 2000 coefficients) record the JAX package's span names and counts,
  each package's GLOBAL_PHASES reset first; the proof bytes equal the
  reference's, with and without LCPC_PROFILE_PROTO=1, and the evaluations
  agree;
- the profiling sync waits on CUDA devices only with LCPC_PROFILE_PROTO=1;
- every bound of the kernel table in PERF.md (section 6) from the cost
  functions at its shape, to the digits printed there, with its label;
- the counterpart of the reference's test_profiling_helpers: the report's
  keys and bound words are the reference's;
- trace() is a no-op without LCPC_TRACE_DIR and writes a Chrome trace with
  it.
"""

import functools
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.codes import brakedown as jax_bd
from lcpc_proof_of_storage_tpu.codes.ligero import LigeroEncoding as JaxLigero
from lcpc_proof_of_storage_tpu.core import commit as jax_core
from lcpc_proof_of_storage_tpu.crypto.transcript import Transcript as JaxTranscript
from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.utils import profiling as jax_prof
from lcpc_proof_of_storage_tpu.utils import serde as jax_serde
from lcpc_proof_of_storage_tpu_torch.codes.brakedown import BrakedownEncoding
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.core import commit as port
from lcpc_proof_of_storage_tpu_torch.core.streamed import commit_streamed
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import FT63, FT255, WRITEABLE_FT63
from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
from lcpc_proof_of_storage_tpu_torch.ops import ntt
from lcpc_proof_of_storage_tpu_torch.utils import profiling as prof
from lcpc_proof_of_storage_tpu_torch.utils import serde

torch.set_num_threads(1)
X = 123456789
JAX_CONFIG = ("jax_platforms", "jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_enable_xla_caches")


def _tr(root: bytes, cls=Transcript):
    tr = cls(b"spans")
    tr.append_message(b"polycommit", root)
    return tr


def _spans(recorder, actor: str) -> dict[str, int]:
    return {name: count for (a, name), count in recorder.counts.items() if a == actor}


# -- the cost model -----------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


@functools.lru_cache(maxsize=None)
def _tables(n: int, route: str):
    return ntt.NttTables(FT255, n, route)


@functools.lru_cache(maxsize=None)
def _expander_levels(n_per_row: int):
    enc = ex.ExpanderEncoder.build(n_per_row, 0, FT255, ex.SDIG_CODE_3)
    return [(t.rows, t.cols, int(t.counts.sum())) for t in (*enc.pre, *enc.post)]


# (kernel row of PERF.md's table, shape there) -> cost, bound as printed, label
BOUNDS = {
    "K1 128x32768x16 n_nonzero 8192": (lambda: prof.ntt_cost(128, 32768, 16, 13),
                                       "0.252", "operations"),
    "K1 the 2^29 batch": (lambda: prof.ntt_cost(32, 1 << 20, 16, 18), "2.821", "operations"),
    "K1 rows as stored, the 2^28 batch": (lambda: prof.ntt_cost(32, 1 << 19, 16, 17), "1.330",
                                          "operations"),
    "KT pass A 128x128x256": (lambda: ntt.TileCall(_meta(128, 128, 256, 16),
                                                   _tables(1 << 15, "four_step"), 2, 8).cost(),
                              "0.120", "bytes"),
    "K4 inverse 128x32768x16": (lambda: prof.ntt_cost(128, 32768, 16, 15, scale=True),
                                "0.300", "operations"),
    "K1 PoS writer batch 512x32768x4": (lambda: prof.ntt_cost(512, 32768, 4, 14),
                                        "0.160", "bytes"),
    "KT pass B 128x256x128": (lambda: ntt.TileCall(_meta(128, 256, 128, 8),
                                                   _tables(1 << 15, "four_step"), 0, 7,
                                                   diag=True, out_limbs=True).cost(),
                              "0.140", "operations"),
    # the 2^20 four-step diagonal's twiddles equal to 1: row 0 and column 0
    "KT pass B the 2^29 batch": (lambda: prof.tile_cost(32 << 20, 16, 0, 10, False, True,
                                                        1 << 20, 1024 + 1024 - 1),
                                 "1.602", "operations"),
    "KT fused tile 2048, stages 2..10": (lambda: ntt.TileCall(
        _meta(128, 32768, 16), _tables(1 << 15, "fused_small"), 2, 11).cost(),
        "0.172", "operations"),
    "KT fused tile, the 2^29 batch": (lambda: prof.tile_cost(32 << 20, 16, 2, 11, True, False),
                                      "1.378", "operations"),
    "K1 stages 11..14": (lambda: prof.ntt_cost(128, 32768, 16, 4), "0.160", "bytes"),
    "K1 stages 11..19, the 2^29 batch": (lambda: prof.ntt_cost(32, 1 << 20, 16, 9),
                                         "1.442", "operations"),
    "KM 4194304x16 by 1x16": (lambda: ntt.MulModCall(_meta(4194304, 16), _meta(1, 16),
                                                     FT255).cost(), "0.160", "bytes"),
    "KM the 2^29 batch by 1x16": (lambda: prof.modmul_cost(32 << 20, 16, 1), "1.282", "bytes"),
    "KM 100003x16 by 100003x16": (lambda: prof.modmul_cost(100003, 16, 100003), "0.006", "bytes"),
    "K2 leaves 128x32768x16": (lambda: prof.hash_columns_cost(128, 32768, 32), "0.080", "bytes"),
    "K2 leaves 143x357697x16": (lambda: prof.hash_columns_cost(143, 357697, 32),
                                "0.981", "bytes"),
    "K2 leaves 18x178850x16": (lambda: prof.hash_columns_cost(18, 178850, 32), "0.063", "bytes"),
    "K2 leaves 128x189x16": (lambda: prof.hash_columns_cost(128, 189, 32), "0.0005", "bytes"),
    "K2 tree over 2^15 leaves": (lambda: prof.merkle_tree_cost(1 << 15), "0.0008",
                                 "operations"),
    "K2 tree over 2^20 leaves": (lambda: prof.merkle_tree_cost(1 << 20), "0.025", "operations"),
    "chunk CVs 32x2^20x16": (lambda: prof.chunk_cvs_cost(32, 1 << 20, 32), "0.651", "bytes"),
    "merge 2^20 columns x 65 chunks": (lambda: prof.merge_cvs_cost(1 << 20, 65), "1.603",
                                       "operations"),
    "K3 128x8192x16 T=2": (lambda: prof.collapse_cost(128, 8192, 16, 2), "0.020", "bytes"),
    "K3 18x117587x16": (lambda: prof.collapse_cost(18, 117587, 16, 2), "0.045", "bytes"),
    "K3 143x235172x16": (lambda: prof.collapse_cost(143, 235172, 16, 2), "0.651", "bytes"),
    "K3p 128x262144x16 16-bit + acc": (lambda: prof.collapse_cost(128, 262144, 16, 2, 16, True),
                                       "0.341", "bytes"),
    "K3p PoS batch 585x16384x4": (lambda: prof.collapse_cost(585, 16384, 4, 1, 16, True),
                                  "0.023", "bytes"),
    "K5 2^21 b=18": (lambda: prof.expander_cost(18, _expander_levels(117587), 16), "0.140",
                     "operations"),
    "K5 2^25 b=143": (lambda: prof.expander_cost(143, _expander_levels(235172), 16), "2.228",
                      "operations"),
    "K5 2^25 b=32": (lambda: prof.expander_cost(32, _expander_levels(235172), 16), "0.499",
                     "operations"),
    "K5 2^25 b=2": (lambda: prof.expander_cost(2, _expander_levels(235172), 16), "0.063",
                    "bytes"),
}


@pytest.mark.parametrize("case", list(BOUNDS))
def test_bounds_of_the_kernel_table(case):
    make, printed, label = BOUNDS[case]
    ms, by = make().bound_ms()
    decimals = len(printed.split(".")[1])
    assert (f"{ms:.{decimals}f}", by) == (printed, label)


def test_h100_model_and_the_reference_report():
    """The H100's data-sheet rates; KernelCost.report has the reference's
    keys and bound words (the counterpart of tests/test_crypto.py's
    test_profiling_helpers)."""
    assert (prof.H100.hbm_gbps * 1e9, prof.H100.int32_iops) == (3.35e12, 33.5e12)
    assert "H100" in prof.H100.name and "data sheet" in prof.H100.name
    rec = prof.PhaseRecorder()
    with rec.phase("cpu", actor="client"):
        pass
    with rec.phase("disk"):
        pass
    assert rec.report()["client/cpu"]["count"] == 1
    want_keys = set(jax_prof.ntt_cost(128, 32768, 16).report(0.3))
    k1 = prof.ntt_cost(128, 32768, 16, 15).report(0.3e-3)
    leaves = prof.hash_columns_cost(128, 32768, 32).report(0.115e-3)
    assert set(k1) == set(leaves) == want_keys
    assert (k1["bound"], leaves["bound"]) == ("compute", "memory")
    assert k1["speed_of_light_ms"] == round(prof.ntt_cost(128, 32768, 16, 15).bound_ms()[0], 3)
    assert 0 < leaves["fraction_of_sol"] < 1
    assert prof.modmul_cost(1 << 20, 16, 1 << 20).report(0.0)["fraction_of_sol"] is None
    cost = prof.collapse_cost(585, 16384, WRITEABLE_FT63.num_limbs16, 1, 16, True)
    assert cost.speed_of_light_s() == pytest.approx(cost.bound_ms()[0] / 1e3, rel=1e-12)
    assert prof.dit_ops(8, 0, 1, 2) == 4 * 8 * 2      # stage 0: every twiddle is 1


def test_trace_writes_only_with_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("LCPC_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with prof.trace("off"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("LCPC_TRACE_DIR", str(tmp_path / "traces"))
    with prof.trace("step"):
        (torch.arange(64) * 3).sum()
    files = list((tmp_path / "traces" / "step").glob("*.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]


# -- the prove and verify spans ----------------------------------------------

# name -> (port encoding, reference encoding, port field, reference field, length)
CASES = {
    "ligero_ft255_2^10": (lambda: LigeroEncoding.new(1 << 10, FT255, rho=(1, 4)),
                          lambda: JaxLigero.new(1 << 10, jax_field.FT255, rho=(1, 4)),
                          FT255, jax_field.FT255, 1 << 10),
    "brakedown_ft63_2000": (lambda: BrakedownEncoding.new(2000, seed=0, field=FT63),
                            lambda: jax_bd.BrakedownEncoding.new(2000, seed=0,
                                                                 field=jax_field.FT63),
                            FT63, jax_field.FT63, 2000),
}


def _init_worker(config):
    """A worker's JAX as the parent's (CPU, the same compile cache), XLA's
    backend optimisation off: it only shortens compiles, and every output
    compared is exact integer arithmetic or hashing."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0").strip()
    import jax
    for name, value in config.items():
        jax.config.update(name, value)


def _reference(name: str):
    """The JAX package's commit, prove and verify of the case: root, outer
    and inner tensors, proof bytes, evaluation, and the prove and verify
    spans it records."""
    _, make_jenc, spec, jspec, length = CASES[name]
    jenc = make_jenc()
    rng = np.random.default_rng(20261018)
    coeffs = [int(v) % spec.modulus for v in rng.integers(0, 1 << 62, size=length)]
    jcomm = jax_core.commit(coeffs, jenc)
    root = jcomm.get_root().root
    p = spec.modulus
    xr = pow(X, jcomm.n_per_row, p)
    outer = [pow(xr, i, p) for i in range(jcomm.n_rows)]
    inner = [pow(X, j, p) for j in range(jcomm.n_per_row)]
    jax_prof.GLOBAL_PHASES.__init__()
    jproof = jax_core.prove(jcomm, outer, jenc, _tr(root, JaxTranscript))
    value = jax_core.verify(root, outer, inner, jproof, jenc, _tr(root, JaxTranscript))
    return dict(coeffs=coeffs, root=root, outer=outer, inner=inner, value=value,
                blob=jax_serde.serialize_proof(jproof, jspec),
                prove=_spans(jax_prof.GLOBAL_PHASES, "prove"),
                verify=_spans(jax_prof.GLOBAL_PHASES, "verify"))


@pytest.fixture(scope="module", autouse=True)
def jax_refs():
    """Each case's reference, computed in a spawned worker process from the
    start of the module, while the cost-model tests run (JAX's tracing holds
    the GIL, so a thread would not overlap it)."""
    import jax
    config = {name: getattr(jax.config, name) for name in JAX_CONFIG}
    with ProcessPoolExecutor(len(CASES), mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init_worker, initargs=(config,)) as pool:
        yield {name: pool.submit(_reference, name) for name in CASES}


@pytest.mark.parametrize("deep", [False, True], ids=["plain", "LCPC_PROFILE_PROTO=1"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_prove_verify_spans_match_reference(jax_refs, name, deep, monkeypatch):
    ref = jax_refs[name].result()
    if deep:
        monkeypatch.setenv("LCPC_PROFILE_PROTO", "1")
    else:
        monkeypatch.delenv("LCPC_PROFILE_PROTO", raising=False)
    make_enc, _, spec, _, _ = CASES[name]
    enc = make_enc()
    comm = port.commit(ref["coeffs"], enc, device="cpu")
    assert comm.get_root().root == ref["root"]
    prof.GLOBAL_PHASES.__init__()
    proof = port.prove(comm, ref["outer"], enc, _tr(ref["root"]))
    value = port.verify(ref["root"], ref["outer"], ref["inner"], proof, enc, _tr(ref["root"]),
                        device="cpu")
    assert serde.serialize_proof(proof, spec) == ref["blob"]
    assert value == ref["value"]
    got = _spans(prof.GLOBAL_PHASES, "prove")
    assert set(got) == set(ref["prove"]) and got["paths"] == 1
    # the reference's device-gather branch (here: Brakedown's) enters
    # "paths" a second time, for byte lists it then leaves unused
    assert {k: v for k, v in got.items() if k != "paths"} == {
        k: v for k, v in ref["prove"].items() if k != "paths"}
    assert _spans(prof.GLOBAL_PHASES, "verify") == ref["verify"]
    assert set(ref["prove"]) == {"challenge", "collapse", "transcript", "sample", "open_device",
                                 "open_readback", "paths", "build"}
    assert set(ref["verify"]) == {"limbs", "transcript", "sample", "stage", "upload", "device",
                                  "readback", "fold", "eval"}


@pytest.mark.parametrize("keep_comm", [False, True, "device"])
def test_streamed_prove_opens_under_the_reference_names(keep_comm):
    """A commitment without its encoded matrix, or with it in host memory,
    opens its columns in one ``open`` span (the reference's name for those
    branches); one with it on the device in ``open_device`` and
    ``open_readback``.  The proof is the one-shot commitment's."""
    enc = LigeroEncoding.new_from_dims(16, 64, FT63)
    rng = np.random.default_rng(3)
    coeffs = [int(v) for v in rng.integers(0, FT63.modulus, size=16 * 8)]
    one = port.commit(coeffs, enc, device="cpu")
    comm = commit_streamed(coeffs, enc, target_batch_rows=3, keep_comm=keep_comm, device="cpu")
    root = one.get_root().root
    assert comm.get_root().root == root
    outer = [1] * one.n_rows
    prof.GLOBAL_PHASES.__init__()
    blob = serde.serialize_proof(port.prove(comm, outer, enc, _tr(root)), FT63)
    assert blob == serde.serialize_proof(port.prove(one, outer, enc, _tr(root)), FT63)
    spans = _spans(prof.GLOBAL_PHASES, "prove")
    if keep_comm == "device":
        assert spans["open_device"] == spans["open_readback"] == 2 and "open" not in spans
    else:
        assert spans["open"] == 1 and spans["open_device"] == spans["open_readback"] == 1


def test_profile_sync_only_with_the_variable(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    devs = (torch.device("cuda", 0), "cpu", torch.device("cuda", 0), torch.device("cuda", 1))
    monkeypatch.delenv("LCPC_PROFILE_PROTO", raising=False)
    port._profile_sync(*devs)
    monkeypatch.setenv("LCPC_PROFILE_PROTO", "0")
    port._profile_sync(*devs)
    assert synced == []
    monkeypatch.setenv("LCPC_PROFILE_PROTO", "1")
    port._profile_sync(*devs)
    assert synced == [torch.device("cuda", 0), torch.device("cuda", 1)]
