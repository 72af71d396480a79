"""Core 2d linear-code polynomial commitment engine.

Counterpart of ``lcpc_proof_of_storage_tpu/core/commit.py`` (itself a
re-creation of lcpc-2d/src/lib.rs: commit 651-700, merkleize 720-815,
open_column 818-855, prove 1034-1123, verify 862-982), for any
:class:`~.encoding.LcEncoding` (Ligero, Brakedown).  The row encode, column
hash, Merkle layers and tensor collapse run on the commitment's device (the
encoding's kernel, K2 and K3 on CUDA); the merlin transcript, ChaCha
challenge expansion and the Merkle path folds run on the host through the
port's copies of the reference's host modules, so challenges and proofs are
bit-equal.  A digest other than Blake3 (``crypto/digest.py``) hashes the
leaves and the Merkle layers on the host while the encode stays on the
device.  An encoding with a mesh (``LcEncoding.with_mesh``) commits through
the wide pipeline (:func:`wide_commit_from_matrix`): its commitment keeps the
encoded matrix column-sharded over the mesh (``core/storage.py
ShardedRows``), and prove and verify read it and re-encode through the mesh.

Proof objects live on the host and keep the reference's attribute names
(``LcColumn._col/_limbs/_path/_sibs/_sibi``, ``_LimbRow._limbs``), so
``utils.serde.serialize_proof`` writes the reference's bincode bytes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..crypto.blake3_ref import blake3
from ..crypto.chacha import ChaChaRng, UniformUsize
from ..crypto.digest import HostDigest, column_leaves_host, get_digest, merkle_tree_host
from ..crypto.transcript import Transcript
from ..fields.field import FieldSpec, ints_to_limbs, limbs_to_ints
from ..fields.limb import limb_field
from ..native import fold_paths_native
from ..ops.blake3 import digest_to_bytes, digests_to_bytes, hash_columns, merkle_array, merkle_tree
from ..parallel.mesh import gather, scatter
from ..utils.profiling import phase as _phase
from .encoding import (LABEL_CO, LABEL_DT, LABEL_PE, LABEL_PR, LcEncoding, ceil_log2,
                       next_power_of_two)
from .storage import HostRows, as_rows, limb_matrix


class ProverError(Exception):
    pass


class VerifierError(Exception):
    """kind in {NumColOpens, ColumnPath, ColumnEval, ColumnDegree,
    OuterTensor, InnerTensor, EncodingDims} (lcpc-2d error enums)."""

    def __init__(self, kind: str, msg: str = ""):
        self.kind = kind
        super().__init__(f"{kind}: {msg}" if msg else kind)


class LcColumn:
    """One opened column + Merkle path (lcpc-2d/src/lib.rs:424-433).

    The column is an (n_rows, L) uint32 limb array, converted to python ints
    only when ``.col`` is read; the path is either a list of 32-byte digests
    or row ``sib_idx`` of a (k, depth, 32) packed sibling array, turned into
    bytes only when ``.path`` is read."""

    __slots__ = ("_col", "_limbs", "_spec", "_path", "_sibs", "_sibi")

    def __init__(self, col: list[int] | None = None, path: list[bytes] = (),
                 col_limbs: np.ndarray | None = None, spec: FieldSpec = None,
                 sibs: np.ndarray | None = None, sib_idx: int = 0):
        if col is None and (col_limbs is None or spec is None):
            raise ValueError("LcColumn needs col, or col_limbs and spec")
        self._col = col
        self._limbs = col_limbs
        self._spec = spec
        if sibs is not None:
            self._path = None
            self._sibs = sibs
            self._sibi = sib_idx
        else:
            self._path = list(path)
            self._sibs = None
            self._sibi = 0

    @property
    def path(self) -> list[bytes]:
        if self._path is None:
            row = self._sibs[self._sibi]
            self._path = [row[d].tobytes() for d in range(row.shape[0])]
        return self._path

    @property
    def col(self) -> list[int]:
        if self._col is None:
            self._col = limbs_to_ints(np.asarray(self._limbs))
        return self._col

    def col_limbs(self, spec: FieldSpec) -> np.ndarray:
        """(n_rows, L) uint32 limbs; a materialised .col is authoritative."""
        if self._col is not None:
            return ints_to_limbs(self._col, spec)
        return self._limbs

    def __len__(self):
        return self._limbs.shape[0] if self._limbs is not None else len(self._col)

    def __repr__(self):
        return f"LcColumn(n_rows={len(self)}, path_len={len(self.path)})"


class _LimbRow(list):
    """list[int] proof row backed by its (n, L) uint32 limb array.  Any
    in-place mutation drops the backing: the ints are authoritative."""

    def __init__(self, ints, limbs=None):
        super().__init__(ints)
        self._limbs = limbs

    def _inv(self):
        self._limbs = None

    def row_limbs(self, spec: FieldSpec) -> np.ndarray:
        if self._limbs is not None and self._limbs.shape == (len(self), spec.num_limbs16):
            return np.asarray(self._limbs, np.uint32)
        return ints_to_limbs(list(self), spec)

    def __reduce__(self):
        return (_LimbRow, (list(self), self._limbs))


for _m in ("__setitem__", "__delitem__", "__iadd__", "__imul__", "append",
           "extend", "insert", "pop", "remove", "clear", "sort", "reverse"):
    def _make(_m=_m):
        base = getattr(list, _m)

        def method(self, *a, **kw):
            self._inv()
            return base(self, *a, **kw)

        method.__name__ = _m
        return method

    setattr(_LimbRow, _m, _make())
del _m, _make


def _row_limbs_of(v, spec: FieldSpec) -> np.ndarray:
    if isinstance(v, _LimbRow):
        return v.row_limbs(spec)
    return ints_to_limbs(v, spec)


@dataclass
class LcEvalProof:
    """Evaluation proof (lcpc-2d/src/lib.rs:516-529)."""
    n_cols: int
    p_eval: list[int]
    p_random_vec: list[list[int]]
    columns: list[LcColumn]

    def get_n_cols(self) -> int:
        return self.n_cols

    def get_n_per_row(self) -> int:
        return len(self.p_eval)


@dataclass
class LcRoot:
    root: bytes


class LcCommit:
    """Commitment state (lcpc-2d/src/lib.rs:174-191), on one device.

    hashes is the Merkle array of 2*np2(n_cols)-1 digests as (n, 8) int32
    words (leaves first, then layers, root last), on the commitment's device.
    coeffs (n_rows, n_per_row, L) and comm (n_rows, n_cols, L) are limb
    matrices kept as core/storage.py says (``coeff_rows`` and ``comm_rows``
    are their stores): int32 tensors on that device, or a streamed
    commitment's 16-bit limbs on the device or in host memory.  A streamed
    commitment may keep no comm (prove then re-encodes the opened columns);
    a synthetic one keeps no coeffs and serves its root alone."""

    def __init__(self, coeffs, comm, n_rows: int, n_cols: int, n_per_row: int,
                 hashes: torch.Tensor):
        self.coeff_rows = as_rows(coeffs, hashes.device)
        self.comm_rows = as_rows(comm, hashes.device)
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.n_per_row = n_per_row
        self.hashes = hashes

    @property
    def coeffs(self) -> torch.Tensor | np.ndarray | None:
        return None if self.coeff_rows is None else self.coeff_rows.data

    @property
    def comm(self) -> torch.Tensor | np.ndarray | None:
        return None if self.comm_rows is None else self.comm_rows.data

    @property
    def device(self) -> torch.device:
        return self.hashes.device

    @property
    def hashes_len(self) -> int:
        return self.hashes.shape[0]

    def get_root(self) -> LcRoot:
        return LcRoot(digest_to_bytes(self.hashes[-1]))

    def get_n_per_row(self) -> int:
        return self.n_per_row

    def get_n_cols(self) -> int:
        return self.n_cols

    def get_n_rows(self) -> int:
        return self.n_rows


# --------------------------------------------------------------------------
# commit
# --------------------------------------------------------------------------

def merkle_tree_device(n_cols: int, device, write_leaves) -> torch.Tensor:
    """Merkle array [leaves padded with zero digests to np2] ++ [layer 1] ++
    ... ++ [root] (lcpc-2d/src/lib.rs:685-694), allocated once on `device`:
    write_leaves(out) puts the n_cols leaves into its rows [0, n_cols)
    (hash_columns or merge_cvs with ``out=``), and merkle_tree fills the
    layers (on CUDA in one or two launches of K2's tree entry)."""
    hashes = merkle_array(n_cols, device)
    write_leaves(hashes[:n_cols])
    return merkle_tree(hashes)


def default_device(device=None) -> torch.device:
    """`device` if given, else the current CUDA card: the entry points run on
    the card unless asked for the CPU with ``device="cpu"``.  With no card
    and no device this raises; nothing falls back to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' to run on the host")
    return torch.device("cuda", torch.cuda.current_device())


def _device_for(enc: LcEncoding, device):
    """`device`, else the first device of the encoding's mesh, else None."""
    if device is None and enc.mesh is not None:
        return enc.mesh.devices[0]
    return device


def commit(coeffs, enc: LcEncoding, device=None, digest: str = "blake3") -> LcCommit:
    """lcpc-2d/src/lib.rs:651-700, on `device` (default: the device of a
    CUDA coefficient tensor, else the first device of the encoding's mesh,
    else :func:`default_device`).

    `digest` is the reference's digest type parameter (``LcCommit<D, E>``,
    lib.rs:174-191).  Blake3 (default) hashes the columns and builds the
    Merkle tree on the device (K2).  Another digest of ``crypto/digest.py``
    (e.g. ``"blake2b"``) encodes on the device (K1 or K5), lays the leaf
    messages out there and reads them back once, and hashes the leaves and
    the layers on the host.  An encoding with a mesh commits through
    :func:`wide_commit_from_matrix`, Blake3 only."""
    if device is None and isinstance(coeffs, torch.Tensor) and coeffs.is_cuda:
        device = coeffs.device
    device = default_device(_device_for(enc, device))
    if digest != "blake3" and enc.mesh is not None:
        raise ProverError("generic digests commit on one device only")
    host_digest = None if digest == "blake3" else get_digest(digest)
    coeff_mat, dims = limb_matrix(coeffs, enc, device)
    n_rows, n_per_row, n_cols = dims
    if enc.mesh is not None:
        return wide_commit_from_matrix(coeff_mat, dims, enc)
    comm = enc.encode(coeff_mat)
    if host_digest is None:
        hashes = merkle_tree_device(n_cols, comm.device,
                                    lambda out: hash_columns(comm, enc.spec, out=out))
    else:
        leaves = column_leaves_host(comm, enc.spec, host_digest)
        hashes = merkle_tree_host(leaves, n_cols, host_digest, comm.device)
    return LcCommit(coeffs=coeff_mat, comm=comm, n_rows=n_rows, n_cols=n_cols,
                    n_per_row=n_per_row, hashes=hashes)


def wide_commit_from_matrix(coeff_mat: torch.Tensor, dims: tuple[int, int, int],
                            enc: LcEncoding) -> LcCommit:
    """The wide pipeline (``parallel/wide.py``) on a prepared (n_rows,
    n_per_row, L) int32 coefficient matrix, for an encoding with a mesh: the
    encoded-column axis sharded over the mesh (``enc.encode_wide``), each
    shard hashing its own columns (K2's leaves), K2's tree over the gathered
    leaves on the mesh's first device.  Brakedown's ragged width is padded to
    a multiple of the mesh size for the encode and the leaves, and the
    padding's digests are sliced off before the tree.  The commitment keeps
    the encoded matrix column-sharded (padding included), and the
    coefficients too where the mesh size divides n_per_row."""
    n_rows, n_per_row, n_cols = dims
    mesh = enc.mesh
    D = mesh.size
    comm = enc.encode_wide(scatter(coeff_mat, mesh, 1, -(-n_cols // D) * D))
    leaves = [hash_columns(block, enc.spec) for block in comm]
    device = mesh.devices[0]
    hashes = merkle_tree_device(
        n_cols, device, lambda out: out.copy_(gather(leaves, device, 0)[:n_cols]))
    coeffs = scatter(coeff_mat, mesh, 1) if n_per_row % D == 0 else coeff_mat
    return LcCommit(coeffs=coeffs, comm=comm, n_rows=n_rows, n_cols=n_cols,
                    n_per_row=n_per_row, hashes=hashes)


def check_comm(comm: LcCommit, enc: LcEncoding) -> None:
    """Raise ProverError unless the commitment's fields agree with each other
    and with `enc`.  comm may be None (a streamed commitment that keeps no
    encoded matrix); where it is kept, its width is exactly n_cols, or, under
    a mesh only, at least n_cols (a wide Brakedown matrix is zero-padded to a
    multiple of the mesh size; no column past n_cols is opened)."""
    if comm.coeff_rows is None:
        raise ProverError("a synthetic commitment keeps no coefficients to prove from")
    if comm.comm_rows is None:
        width_ok = True
    else:
        rows, width = comm.comm_rows.shape[:2]
        width_ok = rows == comm.n_rows and (
            width >= comm.n_cols if enc.mesh is not None else width == comm.n_cols)
    ok = (width_ok
          and comm.coeff_rows.shape[:2] == (comm.n_rows, comm.n_per_row)
          and comm.hashes_len == 2 * next_power_of_two(comm.n_cols) - 1
          and enc.dims_ok(comm.n_per_row, comm.n_cols))
    if not ok:
        raise ProverError("inconsistent commitment fields")


# --------------------------------------------------------------------------
# column opening
# --------------------------------------------------------------------------

def open_column(comm: LcCommit, column: int, spec: FieldSpec | None = None) -> LcColumn:
    """lcpc-2d/src/lib.rs:818-855."""
    if column >= comm.n_cols:
        raise ProverError("bad column number")
    if comm.comm_rows is None:
        raise ProverError("a streamed commitment without its encoded matrix opens columns "
                          "only inside prove")
    limbs = comm.comm_rows.gather([column])[:, 0]
    path = merkle_path(comm.hashes, comm.n_cols, column)
    if spec is not None:
        return LcColumn(col_limbs=limbs, spec=spec, path=path)
    return LcColumn(col=limbs_to_ints(limbs), path=path)


def merkle_path(hashes, n_cols: int, column: int) -> list[bytes]:
    """Sibling digests, leaf level upward (sibling = (col&~1)|(~col&1))."""
    rows = hashes[torch.from_numpy(_path_indices(n_cols, [column])).to(hashes.device)]
    return digests_to_bytes(rows)


def _path_indices(n_cols: int, columns: list[int]) -> np.ndarray:
    """(k*depth,) flat Merkle-array indices of every column's sibling path
    (row-major per column, leaf level upward)."""
    depth = ceil_log2(n_cols)
    cur = np.asarray(columns, np.int64)
    width = next_power_of_two(n_cols)
    offset = 0
    idxs = np.empty((depth, len(columns)), np.int64)
    for lvl in range(depth):
        idxs[lvl] = offset + ((cur & ~1) | (~cur & 1))
        offset += width
        width //= 2
        cur >>= 1
    return idxs.T.reshape(-1)


def _packed_from_sibs(sibs: np.ndarray, k: int, depth: int) -> np.ndarray:
    """(k*depth, 8) 32-bit sibling words -> (k, depth, 32) uint8 array."""
    return np.ascontiguousarray(sibs).view("<u4").view(np.uint8).reshape(k, depth, 32)


def merkle_paths_batch(comm: LcCommit, columns: list[int]) -> list[list[bytes]]:
    """merkle_path for many columns in one gather on the device."""
    depth = ceil_log2(comm.n_cols)
    k = len(columns)
    if depth == 0 or k == 0:
        return [[] for _ in range(k)]
    flat = torch.from_numpy(_path_indices(comm.n_cols, columns)).to(comm.device)
    blob = digests_to_bytes(comm.hashes[flat])
    return [blob[i * depth:(i + 1) * depth] for i in range(k)]


# --------------------------------------------------------------------------
# prove
# --------------------------------------------------------------------------

def _challenge_tensor(tr: Transcript, spec: FieldSpec, n: int) -> list[int]:
    """LABEL_DT challenge -> ChaCha20 -> n field elements (ff::random)."""
    return spec.random_vec(ChaChaRng(tr.challenge_bytes(LABEL_DT, 32), 20), n)


def _collapse_rows(comm: LcCommit, tensors: list[list[int]], spec: FieldSpec):
    """Collapse of several tensors against the committed coefficients: one K3
    call where they are on the device, one K3p pass over row batches where
    they are in host memory (core/storage.py); returns [(python ints,
    (n_per_row, L) uint32 limbs)...]."""
    lf = limb_field(spec)
    t = torch.stack([lf.array(tv) for tv in tensors]).to(comm.device)
    out = comm.coeff_rows.collapse(t, spec).cpu().numpy().astype(np.uint32)
    return [(limbs_to_ints(out[i]), out[i]) for i in range(len(tensors))]


def _append_coeffs(tr: Transcript, label: bytes, limbs: np.ndarray, spec: FieldSpec):
    """Append a coefficient vector, given as (n, L) 16-bit limbs, to the
    transcript (one repr per value).  The LE repr is the limb buffer
    (big-endian fields reverse each element).  A value >= p raises, as the
    reference's per-value to_repr would."""
    le = np.ascontiguousarray(np.asarray(limbs, np.uint32).astype("<u2"))
    p_limbs = np.frombuffer(spec.modulus.to_bytes(spec.repr_bytes, "little"), "<u2")
    lt = np.zeros(len(le), bool)
    decided = np.zeros(len(le), bool)
    for j in reversed(range(le.shape[-1])):
        a = le[:, j]
        lt |= ~decided & (a < p_limbs[j])
        decided |= a != p_limbs[j]
    if not lt.all():
        raise ValueError("non-canonical field value in coefficient vector")
    if spec.endianness == "little":
        msgs = le.tobytes()
    else:
        msgs = np.ascontiguousarray(le.view(np.uint8).reshape(len(le), -1)[:, ::-1]).tobytes()
    tr.append_messages_batch(label, msgs, spec.repr_bytes, len(le))


def _columns_to_open(tr: Transcript, n_cols: int, n: int) -> list[int]:
    """Column challenge expansion (lcpc-2d lib.rs:1102-1110), consuming the
    ChaCha stream exactly like the serial widening-multiply sampler."""
    rng = ChaChaRng(tr.challenge_bytes(LABEL_CO, 32), 20)
    dist = UniformUsize(0, n_cols)
    if n_cols >= (1 << 32):
        return [dist.sample(rng) for _ in range(n)]
    out: list[int] = []
    while len(out) < n:
        need = n - len(out)
        W = rng.peek_u64_array(need + 8 + need // 8)
        ok, vals = dist.candidates(W)
        idx = np.nonzero(ok)[0]
        if len(idx) >= need:
            take = idx[:need]
            out.extend(int(v) for v in vals[take])
            rng.advance_u64(int(take[-1]) + 1)
        else:
            out.extend(int(v) for v in vals[idx])
            rng.advance_u64(len(W))
    return out


def _profile_sync(*devices) -> None:
    """With LCPC_PROFILE_PROTO=1 (read at each call, as the JAX package
    reads it), wait for the work queued on these devices, so that a device
    leg's span holds its card time and the readback after it does not;
    otherwise nothing: the spans add no sync and no launch."""
    if os.environ.get("LCPC_PROFILE_PROTO") != "1":
        return
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def prove(comm: LcCommit, outer_tensor: list[int], enc: LcEncoding,
          tr: Transcript) -> LcEvalProof:
    """lcpc-2d/src/lib.rs:1034-1123, on the commitment's device.

    Its legs are phase spans of utils/profiling.GLOBAL_PHASES (actor
    "prove"), named as the JAX package names them: challenge, collapse,
    transcript, sample, then open (a streamed commitment without its
    encoded matrix, or one kept in host memory) or open_device and
    open_readback, then paths and build."""
    check_comm(comm, enc)
    if len(outer_tensor) != comm.n_rows:
        raise ProverError("outer tensor: wrong size")
    spec = enc.spec

    # the eval collapse needs only the caller's outer tensor, so it shares
    # the first degree test's kernel call; the transcript order is unchanged
    p_random_vec = []
    p_eval = pe_limbs = None
    for i in range(enc.get_n_degree_tests()):
        with _phase("challenge", "prove"):
            rand_tensor = _challenge_tensor(tr, spec, comm.n_rows)
        with _phase("collapse", "prove"):
            if i == 0:
                (p_random, pr_limbs), (p_eval, pe_limbs) = _collapse_rows(
                    comm, [rand_tensor, outer_tensor], spec)
            else:
                (p_random, pr_limbs), = _collapse_rows(comm, [rand_tensor], spec)
        with _phase("transcript", "prove"):
            _append_coeffs(tr, LABEL_PR, pr_limbs, spec)
        p_random_vec.append(_LimbRow(p_random, pr_limbs))
    if p_eval is None:
        with _phase("collapse", "prove"):
            (p_eval, pe_limbs), = _collapse_rows(comm, [outer_tensor], spec)
    with _phase("transcript", "prove"):
        _append_coeffs(tr, LABEL_PE, pe_limbs, spec)

    # the opened columns and their sibling paths in one gather each (a
    # streamed commitment without its encoded matrix re-encodes the rows
    # instead); the paths stay one packed (k, depth, 32) array (depth >= 1:
    # check_comm requires n_cols > n_per_row >= 1), with no per-column byte
    # lists
    with _phase("sample", "prove"):
        cols_to_open = _columns_to_open(tr, comm.n_cols, enc.get_n_col_opens())
    k = len(cols_to_open)
    store = comm.comm_rows
    if store is None or isinstance(store, HostRows):
        with _phase("open", "prove"):
            cols_arr = (comm.coeff_rows.open_columns(enc, comm.n_cols, cols_to_open)
                        if store is None else store.gather(cols_to_open))    # (rows, k, L)
    else:
        with _phase("open_device", "prove"):
            taken = store.take(cols_to_open)
            _profile_sync(*store.devices)
        with _phase("open_readback", "prove"):
            cols_arr = store.readback(taken)
    with _phase("paths", "prove"):
        pidx = torch.from_numpy(_path_indices(comm.n_cols, cols_to_open)).to(comm.device)
        paths_packed = _packed_from_sibs(comm.hashes[pidx].cpu().numpy(), k,
                                         ceil_log2(comm.n_cols))
    with _phase("build", "prove"):
        packed = np.ascontiguousarray(cols_arr.transpose(1, 0, 2)).astype(np.uint32)
        columns = [LcColumn(col_limbs=packed[i], spec=spec, sibs=paths_packed, sib_idx=i)
                   for i in range(k)]
        proof = LcEvalProof(n_cols=comm.n_cols, p_eval=_LimbRow(p_eval, pe_limbs),
                            p_random_vec=p_random_vec, columns=columns)
        proof._paths_packed = paths_packed
    return proof


# --------------------------------------------------------------------------
# verify
# --------------------------------------------------------------------------

def _verify_checks_fused(enc: LcEncoding, rows_mat: np.ndarray, rand_mats: torch.Tensor,
                         outer_mat: torch.Tensor, cols: np.ndarray, cols_to_open: list[int],
                         dev: torch.device, hash_leaves: bool = True):
    """The verifier's device work: re-encode the degree-test and eval rows
    (the encoding's kernel: K1 for Ligero, K5 for Brakedown; through the mesh
    under one), compare them at the opened positions with the column dot
    products, and, with `hash_leaves`, hash the column leaves (K2).  rows_mat
    is (ndt+1, width, L) with width >= n_per_row for a malformed proof; the
    encode is given all `width` coefficients (Ligero reads them all, so an
    over-long row fails the degree check; Brakedown reads n_per_row, as the
    reference does).
    Returns (rand_ok (ndt, k), eval_ok (k,), leaves (k, 8) or None)."""
    lf = limb_field(enc.spec)
    with _phase("upload", "verify"):
        rows_dev = torch.from_numpy(rows_mat).to(dev)
        cols_dev = torch.from_numpy(cols.astype(np.int32)).to(dev)             # (k, rows, L)
        open_dev = torch.tensor(cols_to_open, dtype=torch.int64, device=dev)
        _profile_sync(dev)
    with _phase("device", "verify"):
        sel = enc.encode(rows_dev)[:, open_dev]                                # (ndt+1, k, L)
        d_rand = lf.dot(cols_dev[None], rand_mats[:, None], axis=2)           # (ndt, k, L)
        d_eval = lf.dot(cols_dev, outer_mat[None], axis=1)                    # (k, L)
        rand_ok = (d_rand == sel[:-1]).all(dim=-1)
        eval_ok = (d_eval == sel[-1]).all(dim=-1)
        leaves = (hash_columns(cols_dev.transpose(0, 1).contiguous(), enc.spec) if hash_leaves
                  else None)
        _profile_sync(dev, *(enc.mesh.devices if enc.mesh is not None else ()))
    with _phase("readback", "verify"):
        return rand_ok.cpu().numpy(), eval_ok.cpu().numpy(), leaves


def _fold_path(leaf: bytes, col_num: int, path: list[bytes]) -> bytes:
    """Merkle path fold, leaf -> root."""
    h = leaf
    col = col_num
    for p in path:
        h = blake3(h + p) if col % 2 == 0 else blake3(p + h)
        col >>= 1
    return h


def verify_column_path(column: LcColumn, col_num: int, root: bytes, spec: FieldSpec,
                       digest: str = "blake3") -> bool:
    """lcpc-2d/src/lib.rs:985-1008 on the host, for one column: its leaf
    H(0^32 || reprs) folded up its path equals `root`.  verify checks all
    opened columns at once instead; this is the single-column entry."""
    msg = b"\x00" * 32 + b"".join(spec.to_repr(v) for v in column.col)
    if digest == "blake3":
        return _fold_path(blake3(msg), col_num, column.path) == root
    d = get_digest(digest)
    return _fold_paths_generic([d.hash(msg)], [col_num], [column.path], d)[0] == root


def _fold_paths_generic(leaf_bytes: list[bytes], col_nums: list[int],
                        paths: list[list[bytes]], d: HostDigest) -> list[bytes]:
    """_fold_path for a host digest of crypto/digest.py: a level of every
    path at a time through ``d.hash_many`` where the paths are well formed
    (one depth, 32-byte entries), else column by column, so a malformed proof
    fails the root comparison."""
    k = len(col_nums)
    depth = len(paths[0]) if k else 0
    if any(len(p) != depth or any(len(e) != 32 for e in p) for p in paths):
        out = []
        for h, col, path in zip(leaf_bytes, col_nums, paths):
            for p in path:
                h = d.hash(h + p) if col % 2 == 0 else d.hash(p + h)
                col >>= 1
            out.append(h)
        return out
    h = np.frombuffer(b"".join(leaf_bytes), np.uint8).reshape(k, 32)
    sibs = np.frombuffer(b"".join(b"".join(p) for p in paths), np.uint8).reshape(k, depth, 32)
    right = (np.asarray(col_nums, np.int64)[:, None] >> np.arange(depth)) & 1 == 1
    for lvl in range(depth):
        s = sibs[:, lvl]
        odd = right[:, lvl, None]
        h = d.hash_many(np.concatenate([np.where(odd, s, h), np.where(odd, h, s)], axis=1))
    return [h[i].tobytes() for i in range(k)]


def _fold_paths_batch(leaf_bytes: list[bytes], col_nums: list[int],
                      paths: list[list[bytes]] | None,
                      sibs_packed: np.ndarray | None = None) -> list[bytes]:
    """_fold_path for many columns in one native call (the reference's
    ``native.fold_paths_native``; one by one in Python where the native
    library is not built).  `sibs_packed` ((k, depth, 32) uint8) replaces
    `paths` when the caller vouches for it.  Paths of unequal length or with
    non-32-byte entries fold one by one, so a malformed proof fails the root
    comparison instead of a reshape."""
    k = len(col_nums)
    if k == 0:
        return []
    if paths is None:
        sibs = sibs_packed
    else:
        depth = len(paths[0])
        if any(len(p) != depth for p in paths) or any(len(e) != 32 for p in paths for e in p):
            return [_fold_path(leaf_bytes[i], col_nums[i], paths[i]) for i in range(k)]
        sibs = np.frombuffer(b"".join(b"".join(p) for p in paths), np.uint8).reshape(k, depth, 32)
    if sibs.shape[1] == 0:
        return list(leaf_bytes)
    h = np.frombuffer(b"".join(leaf_bytes), np.uint8).reshape(k, 32)
    folded = fold_paths_native(h, sibs, np.asarray(col_nums, np.int64))
    if folded is None:
        return [_fold_path(leaf_bytes[i], col_nums[i], [bytes(s) for s in sibs[i]])
                for i in range(k)]
    return [folded[i].tobytes() for i in range(k)]


def verify(root: bytes, outer_tensor: list[int], inner_tensor: list[int],
           proof: LcEvalProof, enc: LcEncoding, tr: Transcript, device=None,
           digest: str = "blake3") -> int:
    """lcpc-2d/src/lib.rs:862-982.  Returns the evaluation <inner, p_eval>.

    The proof lives on the host; its checks run on `device` (default: the
    first device of the encoding's mesh, else :func:`default_device`: the
    current CUDA card; without one it raises, so pass ``device="cpu"`` for
    the host).  `digest` must be the committer's (the root binds it): the
    re-encode and the column dots stay on the device, and a digest other
    than Blake3 hashes the leaves and folds the paths on the host, as the
    reference does (core/commit.py:1140-1153 of the JAX package).

    Its legs are phase spans of utils/profiling.GLOBAL_PHASES (actor
    "verify"), named as the JAX package names them: limbs, transcript,
    sample, stage, upload, device (the re-encode, the column dots and the
    leaves), readback, fold and eval."""
    dev = default_device(_device_for(enc, device))
    host_digest = None if digest == "blake3" else get_digest(digest)
    spec = enc.spec
    lf = limb_field(spec)

    n_col_opens = enc.get_n_col_opens()
    if n_col_opens != len(proof.columns) or n_col_opens == 0:
        raise VerifierError("NumColOpens")
    n_rows = len(proof.columns[0])
    n_cols = proof.get_n_cols()
    n_per_row = proof.get_n_per_row()
    if len(inner_tensor) != n_per_row:
        raise VerifierError("InnerTensor")
    if len(outer_tensor) != n_rows:
        raise VerifierError("OuterTensor")
    if not enc.dims_ok(n_per_row, n_cols):
        raise VerifierError("EncodingDims")

    n_degree = enc.get_n_degree_tests()
    with _phase("limbs", "verify"):
        row_limbs = [_row_limbs_of(v, spec) for v in proof.p_random_vec + [proof.p_eval]]
    with _phase("transcript", "verify"):
        rand_tensor_vec = []
        for i in range(n_degree):
            rand_tensor_vec.append(_challenge_tensor(tr, spec, n_rows))
            _append_coeffs(tr, LABEL_PR, row_limbs[i], spec)
        _append_coeffs(tr, LABEL_PE, row_limbs[-1], spec)
    with _phase("sample", "verify"):
        cols_to_open = _columns_to_open(tr, n_cols, n_col_opens)

    if any(len(c) != n_rows for c in proof.columns):
        # such a proof can never verify (the leaf hash covers the column)
        raise VerifierError("OuterTensor", "ragged column lengths")
    with _phase("stage", "verify"):
        cols_np = np.stack([c.col_limbs(spec) for c in proof.columns])     # (k, rows, L)
        rand_mats = torch.stack([lf.array(t) for t in rand_tensor_vec]).to(dev)
        outer_mat = lf.array(outer_tensor, dev)

    # a malformed proof may carry longer rows: the reference copies each
    # row into an n_cols buffer and truncates (lib.rs:913-916), so widen to
    # the longest row (capped at n_cols) and encode every coefficient
    width = min(n_cols, max([n_per_row] + [len(l) for l in row_limbs]))
    with _phase("stage", "verify"):
        rows_mat = np.zeros((n_degree + 1, width, lf.L), np.int32)
        for i, limbs in enumerate(row_limbs):
            rows_mat[i, : min(len(limbs), width)] = limbs[:width]
    rand_ok_arr, eval_ok_arr, leaves = _verify_checks_fused(
        enc, rows_mat, rand_mats, outer_mat, cols_np, cols_to_open, dev,
        hash_leaves=host_digest is None)

    with _phase("fold", "verify"):
        if host_digest is not None:
            leaf_rows = column_leaves_host(cols_np.transpose(1, 0, 2), spec, host_digest)
            folded = _fold_paths_generic([r.tobytes() for r in leaf_rows], cols_to_open,
                                         [c.path for c in proof.columns], host_digest)
        else:
            # the packed sibling array is trusted only while every column is
            # still lazily backed by its own row of it
            sp = getattr(proof, "_paths_packed", None)
            packed_ok = (sp is not None and sp.ndim == 3 and sp.shape[0] == len(proof.columns)
                         and sp.shape[2] == 32
                         and all(c._path is None and c._sibs is sp and c._sibi == i
                                 for i, c in enumerate(proof.columns)))
            folded = _fold_paths_batch(digests_to_bytes(leaves), cols_to_open,
                                       None if packed_ok else [c.path for c in proof.columns],
                                       sibs_packed=sp if packed_ok else None)
    for k, col_num in enumerate(cols_to_open):
        if not all(rand_ok_arr[i][k] for i in range(n_degree)):
            raise VerifierError("ColumnDegree", f"column {col_num}")
        if not eval_ok_arr[k]:
            raise VerifierError("ColumnEval", f"column {col_num}")
        if folded[k] != root:
            raise VerifierError("ColumnPath", f"column {col_num}")

    with _phase("eval", "verify"):
        return sum(t * e for t, e in zip(inner_tensor, proof.p_eval)) % spec.modulus
