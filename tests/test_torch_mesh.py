"""The port's multi-device paths on meshes of CPU shards, in one process.

- the collectives (``parallel/mesh.py``) against plain tensor slicing;
- ``cross_chip_ntt``, forward and inverse, at meshes of 2, 4 and 8 shards
  on ft63 and ft127, equal to the JAX package's one-device ``ntt`` / ``intt``;
- row-sharded commit roots (ragged rows, Ligero and Brakedown) equal to the
  JAX package's one-device ``commit``'s, as its pins in
  tests/golden_vectors.json hold them;
- the ``wide_merkle_sha``, ``wide_proof_sha`` and ``wide_proof_len`` pins
  of tests/golden_vectors.json at a mesh of 8;
- the budget switch of ``sharded_commit`` and ``check_comm``'s width rule;
- legs a-g of ``__graft_entry__.dryrun_multichip`` on the port at a mesh of
  8 (e: the streamed commit, as there), each held against the port's
  one-device path.

The JAX side runs only single-device functions, never its mesh programs.
Inputs come from seeds; every comparison is exact.
"""

import hashlib
import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lcpc_proof_of_storage_tpu.fields import field as jax_field
from lcpc_proof_of_storage_tpu.ops import ntt as jax_ntt
from lcpc_proof_of_storage_tpu_torch.codes.brakedown import BrakedownEncoding
from lcpc_proof_of_storage_tpu_torch.codes.ligero import LigeroEncoding
from lcpc_proof_of_storage_tpu_torch.core import commit as port
from lcpc_proof_of_storage_tpu_torch.core.storage import DeviceRows, ShardedRows
from lcpc_proof_of_storage_tpu_torch.core.streamed import commit_streamed
from lcpc_proof_of_storage_tpu_torch.crypto.transcript import Transcript
from lcpc_proof_of_storage_tpu_torch.fields import FIELDS, FT63, FT255
from lcpc_proof_of_storage_tpu_torch.fields.field import limbs_to_ints
from lcpc_proof_of_storage_tpu_torch.fields.limb import limb_field
from lcpc_proof_of_storage_tpu_torch.ops import expander as ex
from lcpc_proof_of_storage_tpu_torch.ops.collapse import collapse
from lcpc_proof_of_storage_tpu_torch.ops.ntt import encode_rows
from lcpc_proof_of_storage_tpu_torch.parallel import mesh as pm
from lcpc_proof_of_storage_tpu_torch.parallel.cross_chip_ntt import (cross_chip_ntt,
                                                                    split_lengths,
                                                                    wide_encode_rows)
from lcpc_proof_of_storage_tpu_torch.parallel import sharded
from lcpc_proof_of_storage_tpu_torch.parallel.sharded import (make_mesh, sharded_collapse,
                                                              sharded_commit, training_step)
from lcpc_proof_of_storage_tpu_torch.parallel.wide import wide_commit
from lcpc_proof_of_storage_tpu_torch.utils import serde

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden_vectors.json").read_text())
GOLDEN_COEFFS = [(i * 2654435761 + 12345) % FT63.modulus for i in range(512)]


def _limbs(rng, shape, spec):
    """Canonical random limbs (the top limb below p's)."""
    L = spec.num_limbs16
    x = rng.integers(0, 1 << 16, size=(*shape, L), dtype=np.int64)
    x[..., L - 1] = rng.integers(0, spec.modulus >> (16 * (L - 1)), size=shape)
    return torch.from_numpy(x.astype(np.int32))


def _tr(root: bytes, label=b"golden"):
    tr = Transcript(label)
    tr.append_message(b"polycommit", root)
    return tr


def _point(spec, n_rows, n_per_row, x):
    p = spec.modulus
    xr = pow(x, n_per_row, p)
    return [pow(xr, i, p) for i in range(n_rows)], [pow(x, j, p) for j in range(n_per_row)]


def _eval(coeffs, spec, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % spec.modulus
    return acc


def _cpu_mesh(D):
    return make_mesh(D, device="cpu")


# -- meshes and collectives ----------------------------------------------------

def test_make_mesh_on_the_cpu_and_without_a_card():
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and set(mesh.devices) == {torch.device("cpu")}
    assert make_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_commit([1, 2, 3], LigeroEncoding.new_from_dims(2, 4, FT63), make_mesh(2))


@pytest.mark.parametrize("D", [1, 3, 4])
def test_collectives_move_blocks_like_slicing(D):
    mesh = _cpu_mesh(D)
    x = torch.arange(2 * 12 * D * 4 * D * 3, dtype=torch.int32).reshape(2, 12 * D, 4 * D, 3)
    blocks = pm.scatter(x, mesh, 1)
    assert [tuple(b.shape) for b in blocks] == [(2, 12, 4 * D, 3)] * D
    assert torch.equal(pm.gather(blocks, "cpu", 1), x)
    gathered = pm.all_gather(blocks, mesh, 1)
    assert len(gathered) == D and all(torch.equal(g, x) for g in gathered)
    # all_to_all: split the columns, join the rows: column block j of all rows
    swapped = pm.all_to_all(blocks, mesh, 2, 1)
    for j, s in enumerate(swapped):
        assert torch.equal(s, x[:, :, 4 * j:4 * (j + 1)])
    padded = pm.scatter(x, mesh, 2, 4 * D + 2 * D - 1)
    joined = pm.gather(padded, "cpu", 2)
    assert torch.equal(joined[:, :, :4 * D], x) and not joined[:, :, 4 * D:].any()
    assert [s.stop - s.start for s in pm.shard_slices(10, 4)] == [3, 3, 3, 1]
    assert [s.stop - s.start for s in pm.shard_slices(2, 3)] == [1, 1, 0]
    bad = [b[:, :, :1] for b in blocks] if D > 1 else blocks + blocks
    with pytest.raises(ValueError, match="all_to_all"):
        pm.all_to_all(bad, mesh, 2, 1)


# -- the cross-device NTT --------------------------------------------------------

@pytest.fixture(scope="module")
def ntt_case():
    """Per field: seeded (3, 64, L) rows, their JAX ntt and the JAX intt of
    the rows read as evaluations (jitted: one cached program each)."""
    out = {}
    for name in ("ft63", "ft127"):
        spec = FIELDS[name]
        x = _limbs(np.random.default_rng(len(name)), (3, 64), spec)
        jspec = jax_field.FIELDS[name]
        xj = jnp.asarray(x.numpy().astype(np.uint32))
        fwd, inv = (np.asarray(jax.jit(f, static_argnums=1)(xj, jspec)).astype(np.int32)
                    for f in (jax_ntt.ntt, jax_ntt.intt))
        out[name] = (x, torch.from_numpy(fwd), torch.from_numpy(inv))
    return out


@pytest.mark.parametrize("name", ["ft63", "ft127"])
@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_cross_chip_ntt_matches_reference(ntt_case, name, D, inverse):
    x, fwd, inv = ntt_case[name]
    mesh = _cpu_mesh(D)
    got = cross_chip_ntt(pm.scatter(x, mesh, 1), FIELDS[name], mesh, inverse=inverse)
    assert [tuple(b.shape) for b in got] == [(3, 64 // D, x.shape[-1])] * D
    assert torch.equal(pm.gather(got, "cpu", 1), inv if inverse else fwd)


def test_cross_chip_split_rule():
    assert split_lengths(32768, 4) == (128, 256)
    assert split_lengths(64, 8) == (8, 8)
    assert split_lengths(256, 8, n1=32) == (32, 8)
    with pytest.raises(ValueError, match="does not split"):
        split_lengths(64, 16)


def test_wide_encode_rows_equals_encode_rows():
    rng = np.random.default_rng(4)
    rows = _limbs(rng, (5, 100), FT255)
    mesh = _cpu_mesh(4)
    got = pm.gather(wide_encode_rows(rows, FT255, 512, mesh), "cpu", 1)
    assert torch.equal(got, encode_rows(rows, FT255, 512))


def test_wide_ligero_decode_is_the_cross_device_inverse():
    enc = LigeroEncoding.new_from_dims(64, 256, FT63)
    rows = _limbs(np.random.default_rng(8), (3, 64), FT63)
    code = enc.encode(rows)
    wenc = enc.with_mesh(_cpu_mesh(8))
    assert torch.equal(wenc.encode(rows), code)
    back = wenc.decode(code)
    assert torch.equal(back[:, :64], rows) and not back[:, 64:].any()
    assert enc.mesh is None and wenc.mesh is not None


# -- the Brakedown wide encode ----------------------------------------------------

@pytest.fixture(scope="module")
def bd_case():
    rng = random.Random(0xD15)
    coeffs = [rng.randrange(FT63.modulus) for _ in range(2000)]
    enc = BrakedownEncoding.new(2000, seed=0, field=FT63)
    return coeffs, enc, port.commit(coeffs, enc, device="cpu")


def test_natural_gather_mat_undoes_the_slot_sort(bd_case):
    _, enc, _ = bd_case
    for tab in list(enc.encoder.pre) + list(enc.encoder.post):
        again = ex.GatherTables(ex.natural_gather_mat(tab))
        for name in ("idx", "vals", "counts", "order"):
            assert torch.equal(getattr(again, name), getattr(tab, name)), name


@pytest.mark.parametrize("D", [3, 8])
def test_brakedown_encode_wide_shards_rows_in_natural_order(bd_case, D):
    """Each shard's tables are a block of the level's natural rows, and the
    wide encode equals the one-device encode, zero-padded to a multiple of D."""
    _, enc, comm = bd_case
    mesh = _cpu_mesh(D)
    ops = enc.encoder.wide_operands(mesh)
    for tab, blocks in zip(list(enc.encoder.pre) + list(enc.encoder.post),
                           ops["pre"] + ops["post"]):
        whole = ex.natural_gather_mat(tab)
        for s, block in zip(pm.shard_slices(tab.rows, D), blocks):
            part = ex.natural_gather_mat(block)
            assert np.array_equal(part.idx, whole.idx[:, s])
            assert np.array_equal(part.vals, whole.vals[:, s])
    wenc = enc.with_mesh(mesh)
    out = wenc.encode_wide(pm.scatter(comm.coeffs, mesh, 1, -(-enc.n_cols // D) * D))
    joined = pm.gather(out, "cpu", 1)
    assert joined.shape[1] % D == 0
    assert torch.equal(joined[:, :enc.n_cols], comm.comm) and not joined[:, enc.n_cols:].any()
    assert torch.equal(wenc.encode(comm.coeffs), comm.comm)


# -- commits against the JAX package and the pins ----------------------------------

@pytest.mark.parametrize("D", [3, 5])
def test_sharded_commit_roots_match_reference(D):
    """Ragged rows (32, a multiple of neither 3 nor 5): the sharded commit's
    root equals the ligero_ft63_root pin, the JAX package's one-device root
    of these inputs; and a proof from it, proof_sha."""
    enc = LigeroEncoding.new_from_dims(16, 64, FT63)
    comm = sharded_commit(GOLDEN_COEFFS, enc, _cpu_mesh(D))
    root = comm.get_root().root
    assert root.hex() == GOLDEN["ligero_ft63_root"]
    assert isinstance(comm.comm_rows, ShardedRows) and comm.comm_rows.shape == (32, 64, 4)
    outer, _ = _point(FT63, comm.n_rows, comm.n_per_row, 123456789)
    blob = serde.serialize_proof(port.prove(comm, outer, enc, _tr(root)), FT63)
    assert hashlib.sha256(blob).hexdigest() == GOLDEN["proof_sha"]


def test_sharded_brakedown_root_matches_reference():
    """The brakedown_ft63_root pin is the JAX package's one-device root of
    these inputs (the JAX Brakedown commit itself takes tens of seconds on
    the CPU)."""
    coeffs = [(i * 97 + 5) % FT63.modulus for i in range(512)]
    comm = sharded_commit(coeffs, BrakedownEncoding.new(512, seed=7, field=FT63), _cpu_mesh(3))
    assert comm.get_root().root.hex() == GOLDEN["brakedown_ft63_root"]


def test_wide_pins_at_a_mesh_of_8():
    enc = LigeroEncoding.new_from_dims(16, 64, FT63)
    mesh = _cpu_mesh(8)
    wide = wide_commit(GOLDEN_COEFFS, enc, mesh)
    sha = hashlib.sha256(np.ascontiguousarray(wide.hashes.numpy()).tobytes()).hexdigest()
    assert sha == GOLDEN["wide_merkle_sha"]
    assert isinstance(wide.comm_rows, ShardedRows) and isinstance(wide.coeff_rows, ShardedRows)
    root = wide.get_root().root
    outer, _ = _point(FT63, wide.n_rows, wide.n_per_row, 123456789)
    blob = serde.serialize_proof(port.prove(wide, outer, enc.with_mesh(mesh), _tr(root)), FT63)
    assert hashlib.sha256(blob).hexdigest() == GOLDEN["wide_proof_sha"]
    assert len(blob) == GOLDEN["wide_proof_len"]


def test_budget_switches_sharded_commit_to_wide(monkeypatch):
    """Rows up to the column budget are row-sharded (coefficients kept
    whole), wider ones go wide (coefficients column-sharded).  The default
    budget is the columns whose full-width rows fit the device's free memory
    ROW_PATH_COPIES times for every shard it carries."""
    enc = LigeroEncoding.new_from_dims(16, 64, FT63)
    mesh = _cpu_mesh(2)
    rows_sharded = sharded_commit(GOLDEN_COEFFS, enc, mesh)
    assert isinstance(rows_sharded.coeff_rows, DeviceRows)
    wide = sharded_commit(GOLDEN_COEFFS, enc, mesh, col_budget=32)
    assert isinstance(wide.coeff_rows, ShardedRows)
    assert wide.get_root().root.hex() == rows_sharded.get_root().root.hex() == \
        GOLDEN["ligero_ft63_root"]
    n_rows = rows_sharded.n_rows
    per_col = -(-n_rows // 2) * 4 * 4 * sharded.ROW_PATH_COPIES * 2    # 2 shards on the CPU
    monkeypatch.setattr(sharded, "free_bytes", lambda dev: 64 * per_col + per_col - 1)
    assert sharded.row_sharded_col_budget(mesh, n_rows, 4) == 64
    assert isinstance(sharded_commit(GOLDEN_COEFFS, enc, mesh).coeff_rows, DeviceRows)
    monkeypatch.setattr(sharded, "free_bytes", lambda dev: 63 * per_col)
    assert isinstance(sharded_commit(GOLDEN_COEFFS, enc, mesh).coeff_rows, ShardedRows)


def test_generic_digest_refuses_a_mesh():
    enc = LigeroEncoding.new_from_dims(16, 64, FT63).with_mesh(_cpu_mesh(2))
    with pytest.raises(port.ProverError, match="one device"):
        port.commit(GOLDEN_COEFFS, enc, digest="blake2b")


def test_sharded_stores_gather_and_collapse_like_one_device(bd_case):
    _, _, comm = bd_case
    mesh = _cpu_mesh(3)
    store = ShardedRows(pm.scatter(comm.coeffs, mesh, 1))
    t = _limbs(np.random.default_rng(2), (2, comm.n_rows), FT63)
    want = collapse(comm.coeffs, t, FT63)
    assert torch.equal(store.collapse(t, FT63), want)
    assert torch.equal(sharded_collapse(comm.coeffs, t, FT63, mesh), want)
    cols = [0, comm.n_per_row - 1, 5, 5, store.starts[1], store.starts[1] - 1]
    assert np.array_equal(store.gather(cols), DeviceRows(comm.coeffs).gather(cols))


# -- dryrun_multichip's legs on the port ----------------------------------------------

@pytest.fixture(scope="module")
def dryrun():
    """The inputs of __graft_entry__.dryrun_multichip at 8 devices, and the
    port's one-device commitments they are held against."""
    D = 8
    spec = FT63
    mesh = _cpu_mesh(D)
    rnd = random.Random(0xD15)
    enc = LigeroEncoding.new_from_dims(16, 64, spec)
    n_rows = 2 * D + 3
    coeffs = [rnd.randrange(spec.modulus) for _ in range(16 * n_rows - 5)]
    n_cols = max(256, 4 * D * D)
    npr = n_cols // 4
    wcoeffs = [rnd.randrange(spec.modulus) for _ in range(npr * 3 - 1)]
    wenc = LigeroEncoding.new_from_dims(npr, n_cols, spec)
    bn = 2000
    bcoeffs = [rnd.randrange(spec.modulus) for _ in range(bn)]
    benc = BrakedownEncoding.new(bn, seed=0, field=spec)
    return {"D": D, "mesh": mesh, "rnd": rnd, "enc": enc, "coeffs": coeffs,
            "single": port.commit(coeffs, enc, device="cpu"),
            "wenc": wenc, "wcoeffs": wcoeffs,
            "wsingle": port.commit(wcoeffs, wenc, device="cpu"),
            "wide": wide_commit(wcoeffs, wenc, mesh),
            "benc": benc, "bcoeffs": bcoeffs,
            "bsingle": port.commit(bcoeffs, benc, device="cpu"),
            "bwide": wide_commit(bcoeffs, benc, mesh)}


def test_check_comm_allows_a_wider_matrix_only_under_a_mesh(dryrun):
    wide, enc = dryrun["bwide"], dryrun["benc"]
    assert wide.comm_rows.shape[1] > wide.n_cols                 # padded to a multiple of 8
    port.check_comm(wide, enc.with_mesh(dryrun["mesh"]))
    with pytest.raises(port.ProverError, match="inconsistent"):
        port.check_comm(wide, enc)


@pytest.mark.parametrize("wide, single", [("wide", "wsingle"), ("bwide", "bsingle")])
def test_wide_commit_serde_equals_one_device(dryrun, wide, single):
    """A wide commitment serializes to the one-device commitment's bytes
    (Brakedown's padding columns left out), and reads back to them."""
    blob = serde.serialize_commit(dryrun[wide], FT63)
    assert blob == serde.serialize_commit(dryrun[single], FT63)
    back = serde.deserialize_commit(blob, FT63, device="cpu")
    assert serde.serialize_commit(back, FT63) == blob


def test_leg_a_row_sharded_commit(dryrun):
    shard = sharded_commit(dryrun["coeffs"], dryrun["enc"], dryrun["mesh"])
    assert torch.equal(shard.hashes, dryrun["single"].hashes)


def test_leg_b_wide_commit(dryrun):
    wide = dryrun["wide"]
    assert torch.equal(wide.hashes, dryrun["wsingle"].hashes)
    assert [b.shape[1] for b in wide.comm_rows.data] == [dryrun["wenc"].n_cols // 8] * 8


def test_leg_c_training_step(dryrun):
    """The sharded step's encode, leaves and K3 chain against the one-device
    encode, the commit's leaves and a host modular dot."""
    D, enc, spec = dryrun["D"], dryrun["enc"], FT63
    lf = limb_field(spec)
    rnd = random.Random(7)
    sr = 2 * D
    rows = [[rnd.randrange(spec.modulus) for _ in range(enc.n_per_row)] for _ in range(sr)]
    coeff = torch.stack([lf.array(r) for r in rows])
    rand = lf.array([rnd.randrange(spec.modulus) for _ in range(sr)])
    outer = lf.array([rnd.randrange(spec.modulus) for _ in range(sr)])
    comm, leaves, p_random, p_eval = training_step(enc, dryrun["mesh"])(coeff, rand, outer)
    assert torch.equal(pm.gather(comm, "cpu", 1), enc.encode(coeff))
    flat = [v for r in rows for v in r]
    assert torch.equal(leaves, port.commit(flat, enc, device="cpu").hashes[:enc.n_cols])
    r_ints = limbs_to_ints(rand.numpy())
    want = [sum(r_ints[i] * rows[i][j] for i in range(sr)) % spec.modulus
            for j in range(enc.n_per_row)]
    assert limbs_to_ints(p_random.numpy()) == want
    assert torch.equal(p_eval, collapse(coeff, outer[None], spec)[0])


def test_leg_d_wide_prove_and_verify(dryrun):
    spec, mesh, wenc, wide = FT63, dryrun["mesh"], dryrun["wenc"], dryrun["wide"]
    root = wide.get_root().root
    x = 987654321
    outer, inner = _point(spec, wide.n_rows, wide.n_per_row, x)
    enc_w = wenc.with_mesh(mesh)
    proof_w = port.prove(wide, outer, enc_w, _tr(root, b"dryrun"))
    proof_s = port.prove(dryrun["wsingle"], outer, wenc, _tr(root, b"dryrun"))
    assert serde.serialize_proof(proof_w, spec) == serde.serialize_proof(proof_s, spec)
    assert port.verify(root, outer, inner, proof_w, enc_w, _tr(root, b"dryrun")) == \
        _eval(dryrun["wcoeffs"], spec, x)


def test_leg_e_streamed_commit(dryrun):
    spec, enc, single = FT63, dryrun["enc"], dryrun["single"]
    st = commit_streamed(dryrun["coeffs"], enc, target_batch_rows=4, keep_comm=False,
                         device="cpu")
    assert torch.equal(st.hashes, single.hashes)
    outer, _ = _point(spec, st.n_rows, st.n_per_row, 55)
    root = single.get_root().root
    assert (serde.serialize_proof(port.prove(st, outer, enc, _tr(root)), spec)
            == serde.serialize_proof(port.prove(single, outer, enc, _tr(root)), spec))


def test_leg_f_brakedown_sharded_commit_prove_verify(dryrun):
    spec, benc, bsingle = FT63, dryrun["benc"], dryrun["bsingle"]
    bshard = sharded_commit(dryrun["bcoeffs"], benc, dryrun["mesh"])
    assert torch.equal(bshard.hashes, bsingle.hashes)
    root = bshard.get_root().root
    x = 31337
    outer, inner = _point(spec, bshard.n_rows, bshard.n_per_row, x)
    proof = port.prove(bshard, outer, benc, _tr(root, b"dryrun brakedown"))
    proof_s = port.prove(bsingle, outer, benc, _tr(root, b"dryrun brakedown"))
    assert serde.serialize_proof(proof, spec) == serde.serialize_proof(proof_s, spec)
    assert port.verify(root, outer, inner, proof, benc, _tr(root, b"dryrun brakedown"),
                       device="cpu") == _eval(dryrun["bcoeffs"], spec, x)


def test_leg_g_brakedown_wide_commit(dryrun):
    spec, benc, mesh, bwide = FT63, dryrun["benc"], dryrun["mesh"], dryrun["bwide"]
    assert bwide.get_root().root == dryrun["bsingle"].get_root().root
    root = bwide.get_root().root
    x = 4242
    outer, inner = _point(spec, bwide.n_rows, bwide.n_per_row, x)
    enc_w = benc.with_mesh(mesh)
    proof = port.prove(bwide, outer, enc_w, _tr(root))
    assert (serde.serialize_proof(proof, spec)
            == serde.serialize_proof(port.prove(dryrun["bsingle"], outer, benc, _tr(root)), spec))
    assert port.verify(root, outer, inner, proof, enc_w, _tr(root)) == \
        _eval(dryrun["bcoeffs"], spec, x)
