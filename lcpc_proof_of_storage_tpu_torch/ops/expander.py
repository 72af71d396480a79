"""Brakedown / SDIG expander code: seeded matrix generation and the encode.

Counterpart of ``lcpc_proof_of_storage_tpu/ops/expander.py`` (itself a
re-creation of lcpc-brakedown-pc/src/{codespec,matgen,encode}.rs).

Matrix generation runs on the host with the reference's exact RNG semantics
(ChaCha20 per-level streams, uniform distinct column sampling, nonzero
value rejection: matgen.rs:28-188), through the C++ walk of ``native/`` or,
without it, the numpy stream simulation; both give the draw-by-draw
oracle's tables.  Each sparse level is transposed into row-gather form
(:class:`GatherMat`), and the encode is one mat-vec per level: kernel K5
(``csrc/expander.cu``) on CUDA, :func:`gather_matvec_plain` on the CPU.  The
Reed-Solomon base case (encode.rs:97-110, Vandermonde at points 1, 2, 3,
...) and the concatenations are plain torch ops.  Over a mesh
(``parallel/mesh.py``), :meth:`ExpanderEncoder.encode_wide` shards every
level by its output rows (:meth:`ExpanderEncoder.wide_operands`).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .. import native
from ..crypto.chacha import ChaChaRng, UniformUsize, seed_from_u64
from ..fields.field import FieldSpec, ints_to_limbs
from ..fields.limb import limb_field
from ..parallel.mesh import Mesh, all_gather, shard_slices

# --------------------------------------------------------------------------
# code specifications (codespec.rs)
# --------------------------------------------------------------------------


def _ent(z: float) -> float:
    assert 0.0 < z < 1.0
    return -z * math.log2(z) - (1 - z) * math.log2(1 - z)


@dataclass(frozen=True)
class SdigSpec:
    """alpha/beta/r as exact ratios + base-case length (codespec.rs:24-163)."""
    alpha_num: int
    alpha_den: int
    beta_num: int
    beta_den: int
    r_num: int
    r_den: int
    baselen: int = 20

    @property
    def alpha(self) -> float:
        return self.alpha_num / self.alpha_den

    @property
    def beta(self) -> float:
        return self.beta_num / self.beta_den

    @property
    def r(self) -> float:
        return self.r_num / self.r_den

    def dist(self) -> float:
        return (self.beta_num * self.r_den) / (self.beta_den * self.r_num)

    def mu(self) -> float:
        return self.r - 1.0 - self.r * self.alpha

    def nu(self) -> float:
        return self.beta + self.alpha * self.beta + 0.03

    def cnst_cn_1(self) -> float:
        return _ent(self.beta) + self.alpha * _ent(1.28 * self.beta / self.alpha)

    def cnst_cn_2(self) -> float:
        return self.beta * math.log2(self.alpha / (1.28 * self.beta))

    def cnst_dn_1(self) -> float:
        return (self.r * self.alpha * _ent(self.beta / self.r)
                + self.mu() * _ent(self.nu() / self.mu()))

    def cnst_dn_2(self) -> float:
        return self.alpha * self.beta * math.log2(self.mu() / self.nu())


# Brakedown paper table 1 presets (codespec.rs:169-232)
SDIG_CODE_1 = SdigSpec(239, 2000, 71, 2500, 71, 50)
SDIG_CODE_2 = SdigSpec(69, 500, 111, 2500, 147, 100)
SDIG_CODE_3 = SdigSpec(89, 500, 61, 1000, 1521, 1000)
SDIG_CODE_4 = SdigSpec(1, 5, 41, 500, 41, 25)
SDIG_CODE_5 = SdigSpec(211, 1000, 97, 1000, 202, 125)
SDIG_CODE_6 = SdigSpec(119, 500, 241, 2000, 43, 25)
SDIG_CODES = [SDIG_CODE_1, SDIG_CODE_2, SDIG_CODE_3, SDIG_CODE_4, SDIG_CODE_5, SDIG_CODE_6]


def _ceil_muldiv(n: int, num: int, den: int) -> int:
    return (n * num + den - 1) // den


def get_dims(n: int, log2p: float, spec: SdigSpec):
    """matgen.rs:56-112: per-level (ni, mi, cn) and (ni', mi', dn)."""
    baselen = spec.baselen
    assert n > baselen

    sizes = []
    ni = n
    while ni > baselen:
        sizes.append(ni)
        ni = _ceil_muldiv(ni, spec.alpha_num, spec.alpha_den)
    assert ni <= baselen
    sizes.append(ni)
    assert len(sizes) > 1

    pre_dims = []
    for ni, mi in zip(sizes, sizes[1:]):
        cn = min(
            max(
                _ceil_muldiv(ni, 32 * spec.beta_num, 25 * spec.beta_den),
                4 + _ceil_muldiv(ni, spec.beta_num, spec.beta_den),
            ),
            math.ceil((110.0 / ni + spec.cnst_cn_1()) / spec.cnst_cn_2()),
        )
        cn = min(cn, mi)
        pre_dims.append((ni, mi, cn))

    post_dims = []
    for ni, mi, _ in pre_dims:
        niprime = _ceil_muldiv(mi, spec.r_num, spec.r_den)
        miprime = _ceil_muldiv(ni, spec.r_num, spec.r_den) - ni - niprime
        tmp1 = _ceil_muldiv(ni, 2 * spec.beta_num, spec.beta_den)
        tmp2 = _ceil_muldiv(ni, spec.r_num, spec.r_den) - ni + 110
        dn = min(
            tmp1 + math.ceil(tmp2 / log2p),
            math.ceil((110.0 / ni + spec.cnst_dn_1()) / spec.cnst_dn_2()),
        )
        dn = min(dn, miprime)
        post_dims.append((niprime, miprime, dn))

    return pre_dims, post_dims


# --------------------------------------------------------------------------
# sparse matrix generation (matgen.rs)
# --------------------------------------------------------------------------

class SparseCode:
    """Column-regular sparse matrix, rows x cols, in CSC triplet form.

    Backed either by per-column python lists (sequential generator) or by
    dense (cols, d) numpy arrays (vectorized generator; every column has
    exactly d entries by construction).  The list views are materialized
    lazily: only host oracles and tests want python ints."""

    def __init__(self, rows: int, cols: int, col_indices=None, col_values=None,
                 idx_np: np.ndarray | None = None, val_limbs_np: np.ndarray | None = None):
        self.rows = rows
        self.cols = cols
        self._col_indices = col_indices
        self._col_values = col_values
        self.idx_np = idx_np               # (cols, d) int64 sorted row indices
        self.val_limbs_np = val_limbs_np   # (cols, d, L) uint32 16-bit limbs

    @property
    def col_indices(self) -> list:
        if self._col_indices is None:
            self._col_indices = self.idx_np.tolist()
        return self._col_indices

    @property
    def col_values(self) -> list:
        if self._col_values is None:
            arr = self.val_limbs_np.astype(object)
            out = arr[..., 0]
            for j in range(1, arr.shape[-1]):
                out = out + (arr[..., j] << (16 * j))
            self._col_values = out.tolist()
        return self._col_values


def gen_code_seq(n: int, m: int, d: int, rng: ChaChaRng, field: FieldSpec) -> SparseCode:
    """matgen.rs:115-188, draw-by-draw: n columns, each with d distinct
    uniform rows in [0, m) and nonzero values; consumes the RNG exactly like
    the reference (distinct-filtered Uniform stream, then values in
    sorted-row order).  The oracle for the vectorized gen_code."""
    dist = UniformUsize(0, m)
    col_indices = []
    col_values = []
    for _ in range(n):
        seen: list[int] = []
        while len(seen) < d:
            x = dist.sample(rng)
            if x not in seen:
                seen.append(x)
        seen.sort()
        vals = []
        for _row in seen:
            v = field.random(rng)
            while v == 0:
                v = field.random(rng)
            vals.append(v)
        col_indices.append(seen)
        col_values.append(vals)
    return SparseCode(rows=m, cols=n, col_indices=col_indices, col_values=col_values)


# -- vectorized matgen ------------------------------------------------------
#
# The whole ChaCha stream of a level is peeked as one numpy window and the
# rejection sampling is walked over it, by the C++ walk of native/ or, where
# the library is not built, simulated vectorized in numpy:
#
#   * every u64 of the window gets its uniform accept bit + candidate value
#     (widening-multiply zone test) and, per k-word alignment class, its
#     field-attempt accept bit (masked repr in (0, p)): all O(N) vector ops;
#   * the per-column stream consumption then reduces to two sorted-array
#     lookups per column (position of the d-th accepted uniform draw, then
#     of the d-th accepted field attempt);
#   * duplicate-row rejections (rare, ~d^2/2m per column) fall back to an
#     exact per-column walk of the same window.
#
# Both consume the RNG exactly like gen_code_seq.

def _digits16_of_int(v: int, width: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(width)], np.uint64)


def _np_conv_const(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Product digits of (M, La) 16-bit digit rows times a constant of Lc
    digits; raw digits < Lc * 2^32 (u64-safe)."""
    M, La = a.shape
    Lc = len(c)
    out = np.zeros((M, La + Lc), np.uint64)
    for j in range(Lc):
        out[:, j: j + La] += a * c[j]
    return out


def _np_carry(raw: np.ndarray, width: int) -> np.ndarray:
    """Normalize raw u64 digits to `width` 16-bit digits (truncating)."""
    M, Lr = raw.shape
    out = np.zeros((M, width), np.uint64)
    carry = np.zeros(M, np.uint64)
    for j in range(min(Lr, width)):
        t = raw[:, j] + carry
        out[:, j] = t & np.uint64(0xFFFF)
        carry = t >> np.uint64(16)
    j = Lr
    while j < width and carry.any():
        out[:, j] = carry & np.uint64(0xFFFF)
        carry = carry >> np.uint64(16)
        j += 1
    return out


def _np_sub_trunc(a: np.ndarray, b: np.ndarray):
    """(a - b) mod b^width on 16-bit digit rows, plus underflow flag."""
    M, Wd = a.shape
    out = np.empty_like(a)
    borrow = np.zeros(M, np.uint64)
    for j in range(Wd):
        t = a[:, j] - b[:, j] - borrow          # u64 wrap-around
        borrow = t >> np.uint64(63)             # digits <= 2^16: neg iff top bit
        out[:, j] = t & np.uint64(0xFFFF)
    return out, borrow


def _np_cond_sub(r: np.ndarray, p_d: np.ndarray) -> np.ndarray:
    p_pad = np.zeros((1, r.shape[1]), np.uint64)
    p_pad[0, : len(p_d)] = p_d
    d, borrow = _np_sub_trunc(r, np.broadcast_to(p_pad, r.shape))
    return np.where(borrow[:, None].astype(bool), r, d)


def _values_from_reprs_np(w: np.ndarray, field: FieldSpec) -> np.ndarray:
    """(M, k) masked u64 reprs (each in (0, p)) -> (M, L) uint32 16-bit limb
    values of repr * R^-1 mod p (ff_derive's Montgomery interpretation of
    random draws), by the truncated Barrett of fields/limb.py."""
    M, k = w.shape
    Lp = field.num_limbs16
    a = np.zeros((M, 4 * k), np.uint64)
    for j in range(k):
        for t in range(4):
            a[:, 4 * j + t] = (w[:, j] >> np.uint64(16 * t)) & np.uint64(0xFFFF)
    rinv = field.montgomery_r_inv
    rinv_len = max(1, (rinv.bit_length() + 15) // 16)
    z = _np_carry(_np_conv_const(a, _digits16_of_int(rinv, rinv_len)), 2 * Lp)
    # truncated Barrett (z < p * 2^num_bits <= b^2Lp)
    p = field.modulus
    mu = (1 << (16 * 2 * Lp)) // p
    mu_len = max(1, (mu.bit_length() + 15) // 16)
    mu_d = _digits16_of_int(mu, mu_len)
    p_d = _digits16_of_int(p, Lp)
    q1 = z[:, Lp - 1:]                                           # (M, Lp+1)
    q_wide = _np_carry(_np_conv_const(q1, mu_d), Lp + 1 + mu_len)
    qd = q_wide[:, Lp + 1: Lp + 1 + mu_len]
    qp = _np_carry(_np_conv_const(qd, p_d), Lp + 1)
    r, _ = _np_sub_trunc(z[:, : Lp + 1], qp)
    for _ in range(3):
        r = _np_cond_sub(r, p_d)
    return r[:, :Lp].astype(np.uint32)


def _field_accept_np(wr: np.ndarray, field: FieldSpec):
    """Accept bits for (A, k) u64 field attempts: masked repr in (0, p).
    Returns (accept, masked_words)."""
    k = field.u64_limbs
    shave = 64 * k - field.num_bits
    w = wr.copy()
    if shave:
        w[:, k - 1] &= np.uint64((1 << (64 - shave)) - 1)
    p_words = [(field.modulus >> (64 * j)) & 0xFFFFFFFFFFFFFFFF for j in range(k)]
    decided = np.zeros(len(w), bool)
    lt = np.zeros(len(w), bool)
    nz = np.zeros(len(w), bool)
    for j in range(k - 1, -1, -1):
        pj = np.uint64(p_words[j])
        less = w[:, j] < pj
        more = w[:, j] > pj
        lt |= (~decided) & less
        decided |= less | more
        nz |= w[:, j] != 0
    return lt & nz, w


def _column_slow(W: np.ndarray, s: int, d: int, dist: UniformUsize, field: FieldSpec):
    """Exact sequential walk of one column over the peeked window (duplicate
    -row fallback).  Returns (rows_sorted, value_ints, end) or None if the
    window ran out."""
    N = len(W)
    i = s
    seen: list[int] = []
    rng_range, zone, low = dist.range, dist.zone, dist.low
    while len(seen) < d:
        if i >= N:
            return None
        v = int(W[i])
        i += 1
        mprod = v * rng_range
        if (mprod & 0xFFFFFFFFFFFFFFFF) <= zone:
            x = low + (mprod >> 64)
            if x not in seen:
                seen.append(x)
    seen.sort()
    k = field.u64_limbs
    mask = (1 << field.num_bits) - 1
    vals: list[int] = []
    while len(vals) < d:
        if i + k > N:
            return None
        v = 0
        for j in range(k):
            v |= int(W[i + j]) << (64 * j)
        i += k
        v &= mask
        if 0 < v < field.modulus:
            vals.append((v * field.montgomery_r_inv) % field.modulus)
    return seen, vals, i


def _simulate_gen(W: np.ndarray, n: int, m: int, d: int, dist: UniformUsize,
                  field: FieldSpec):
    """One pass of the numpy stream simulation over window W; None if W is
    too short.  Returns (rows (n, d), values (n, d, L), words consumed)."""
    N = len(W)
    ok_u, val_u = dist.candidates(W)
    nzU = np.flatnonzero(ok_u)
    k = field.u64_limbs
    cls_nz, cls_repr = [], []
    for r in range(k):
        A = (N - r) // k
        acc, masked = _field_accept_np(W[r: r + A * k].reshape(A, k), field)
        cls_nz.append(np.flatnonzero(acc))
        cls_repr.append(masked)
    rows_out = np.empty((n, d), np.int64)
    val_ref = np.full((n, 2), -1, np.int64)       # (alignment class, jf)
    slow_vals: dict[int, list[int]] = {}
    ar = np.arange(d)
    cur = 0
    for c in range(n):
        j0 = np.searchsorted(nzU, cur)
        if j0 + d > len(nzU):
            return None
        upos = nzU[j0 + d - 1]
        uvals = val_u[nzU[j0: j0 + d]]
        su = np.sort(uvals)
        if d > 1 and (su[1:] == su[:-1]).any():
            sres = _column_slow(W, cur, d, dist, field)
            if sres is None:
                return None
            rows_out[c], slow_vals[c], cur = sres
            continue
        rows_out[c] = su
        s2 = int(upos) + 1
        r = s2 % k
        t0 = s2 // k
        nzF = cls_nz[r]
        jf = np.searchsorted(nzF, t0)
        if jf + d > len(nzF):
            return None
        val_ref[c] = (r, jf)
        cur = r + (int(nzF[jf + d - 1]) + 1) * k
    Lp = field.num_limbs16
    vals_np = np.empty((n, d, Lp), np.uint32)
    for r in range(k):
        cols_r = np.flatnonzero(val_ref[:, 0] == r)
        if len(cols_r) == 0:
            continue
        att = cls_nz[r][val_ref[cols_r, 1][:, None] + ar]     # (n_r, d)
        w = cls_repr[r][att.ravel()]
        vals_np[cols_r] = _values_from_reprs_np(w, field).reshape(len(cols_r), d, Lp)
    for c, vints in slow_vals.items():
        vals_np[c] = ints_to_limbs(vints, field)
    return rows_out, vals_np, cur


def _matgen_native(W: np.ndarray, n: int, m: int, d: int, dist: UniformUsize,
                   field: FieldSpec):
    """The C++ draw-by-draw walk over the peeked window (the contract of
    _simulate_gen; values converted from Montgomery reprs in C++ too).
    False where the native library is not built."""
    k = field.u64_limbs
    shave = 64 * k - field.num_bits
    top_mask = ((1 << (64 - shave)) - 1) if shave else (1 << 64) - 1
    p_words = np.array([(field.modulus >> (64 * j)) & 0xFFFFFFFFFFFFFFFF for j in range(k)],
                       np.uint64)
    res = native.matgen_walk(W, n, d, dist.range, dist.zone, dist.low, k, top_mask, p_words)
    if not res:
        return res
    rows_np, reprs, consumed = res
    pinv = (-pow(field.modulus, -1, 1 << 64)) % (1 << 64)
    vals = native.mont_redc_limbs(reprs, p_words, pinv, field.num_limbs16)
    return rows_np, vals.reshape(n, d, field.num_limbs16), consumed


def gen_code(n: int, m: int, d: int, rng: ChaChaRng, field: FieldSpec) -> SparseCode:
    """Vectorized matgen.rs:115-188: output and RNG consumption bit-identical
    to gen_code_seq.  The C++ walk where the host library is built, else the
    numpy stream simulation."""
    if n * d < 4096:
        return gen_code_seq(n, m, d, rng, field)
    dist = UniformUsize(0, m)
    k = field.u64_limbs
    q = field.modulus / float(1 << field.num_bits)    # field-attempt accept p
    cap = int(n * (d * (1.0 + 2.0 * d / m) + k * d / q * 1.05)) + 4096
    while True:
        W = rng.peek_u64_array(cap)
        res = _matgen_native(W, n, m, d, dist, field)
        if res is False:                 # no native library: numpy simulation
            res = _simulate_gen(W, n, m, d, dist, field)
        if res is not None:
            break
        cap *= 2
    rows_np, vals_np, consumed = res
    rng.advance_u64(consumed)
    return SparseCode(rows=m, cols=n, idx_np=rows_np, val_limbs_np=vals_np)


def generate(n: int, seed: int, field: FieldSpec, spec: SdigSpec):
    """matgen.rs:28-52: per-level ChaCha20 streams; precode then postcode
    from the same stream."""
    pre_dims, post_dims = get_dims(n, float(field.num_bits - 1), spec)
    precodes, postcodes = [], []
    base_seed = seed_from_u64(seed)
    for i, ((ni, mi, cn), (nip, mip, dn)) in enumerate(zip(pre_dims, post_dims)):
        rng = ChaChaRng(base_seed, 20)
        rng.set_stream(i)
        precodes.append(gen_code(ni, mi, cn, rng, field))
        postcodes.append(gen_code(nip, mip, dn, rng, field))
    return precodes, postcodes


def codeword_length(precodes: list, postcodes: list) -> int:
    """encode.rs:18-33."""
    return (precodes[0].cols
            + postcodes[-1].cols
            + sum(pc.rows for pc in precodes[:-1])
            + sum(pc.rows for pc in postcodes))


# --------------------------------------------------------------------------
# row-gather form
# --------------------------------------------------------------------------

@dataclass
class GatherMat:
    """Row-gather form of a sparse matrix: y[r] = sum_k vals[k,r]*x[idx[k,r]].

    idx (K, rows) and vals (K, rows, L) numpy arrays, K = max row-nnz, padded
    with (index 0, value 0); the reference's layout."""
    rows: int
    cols: int
    idx: np.ndarray
    vals: np.ndarray


def to_gather(mat: SparseCode, field: FieldSpec) -> GatherMat:
    if mat.idx_np is not None:
        return _to_gather_np(mat, field)
    rows_entries: list[list] = [[] for _ in range(mat.rows)]
    for j in range(mat.cols):
        for r, v in zip(mat.col_indices[j], mat.col_values[j]):
            rows_entries[r].append((j, v))
    K = max(1, max(len(e) for e in rows_entries))
    L = field.num_limbs16
    idx = np.zeros((K, mat.rows), np.int32)
    vals = np.zeros((K, mat.rows, L), np.uint32)
    for r, entries in enumerate(rows_entries):
        for k, (j, v) in enumerate(entries):
            idx[k, r] = j
            vals[k, r] = ints_to_limbs([v], field)[0]
    return GatherMat(rows=mat.rows, cols=mat.cols, idx=idx, vals=vals)


def _to_gather_np(mat: SparseCode, field: FieldSpec) -> GatherMat:
    """Vectorized CSC -> row-gather transpose (same entry order as the loop
    form: within a row, entries sorted by column)."""
    n, d = mat.idx_np.shape
    L = field.num_limbs16
    rows_flat = mat.idx_np.ravel()
    cols_flat = np.repeat(np.arange(n, dtype=np.int64), d)
    order = np.lexsort((cols_flat, rows_flat))
    r_sorted = rows_flat[order]
    counts = np.bincount(r_sorted, minlength=mat.rows)
    K = max(1, int(counts.max()))
    row_starts = np.zeros(mat.rows, np.int64)
    np.cumsum(counts[:-1], out=row_starts[1:])
    slot = np.arange(len(r_sorted)) - row_starts[r_sorted]
    idx = np.zeros((K, mat.rows), np.int32)
    vals = np.zeros((K, mat.rows, L), np.uint32)
    idx[slot, r_sorted] = cols_flat[order]
    vals[slot, r_sorted] = mat.val_limbs_np.reshape(-1, L)[order]
    return GatherMat(rows=mat.rows, cols=mat.cols, idx=idx, vals=vals)


# --------------------------------------------------------------------------
# device mat-vec
# --------------------------------------------------------------------------

MAX_SLOTS = (1 << 31) - 1   # csrc/wide.cuh kMaxTerms: K5's sums are exact to this many slots
_PLAIN_SLOTS = 1 << 24      # gather_matvec_plain carries its int64 digit sums this often


def b_tile(W: int, b: int) -> int:
    """Batch rows a K5 thread sums at once (csrc/wide.cuh expander_b_tile)."""
    return (2 if b >= 32 else 1) if W >= 6 else 8 // W


class GatherTables(torch.nn.Module):
    """One level's row-gather tables in the kernel's layout, rows ordered by
    their slot count, longest first, so that the 32 rows of a K5 warp run
    near-equal loops: table row r holds output row ``order[r]``.  ``idx``
    (K, rows) int32, ``vals`` (K, W, rows) int32 holding the values' W = L/2
    32-bit words (neighbouring rows adjacent, so the threads of a warp read
    neighbouring words), ``counts`` (rows,) int32, the slots in use per table
    row (1 + its last nonzero slot), and ``order`` (rows,) int32."""

    def __init__(self, gm: GatherMat):
        super().__init__()
        K, rows = gm.idx.shape
        if gm.vals.shape[:2] != (K, rows) or rows != gm.rows:
            raise ValueError(f"GatherMat idx {gm.idx.shape} and vals {gm.vals.shape} differ")
        if K > MAX_SLOTS:
            raise ValueError(f"{K} gather slots: K5's sums are exact to {MAX_SLOTS}")
        self.rows, self.cols = gm.rows, gm.cols
        limbs = np.asarray(gm.vals, np.uint32)                       # (K, rows, L)
        nz = (limbs != 0).any(axis=-1)                               # (K, rows)
        counts = np.where(nz.any(0), K - np.argmax(nz[::-1], axis=0), 0)
        order = np.argsort(-counts, kind="stable")
        words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)          # (K, rows, W)
        self.register_buffer("idx", torch.from_numpy(
            np.ascontiguousarray(np.asarray(gm.idx, np.int32)[:, order])))
        self.register_buffer("vals", torch.from_numpy(np.ascontiguousarray(
            words[:, order].transpose(0, 2, 1)).view(np.int32)))
        self.register_buffer("counts", torch.from_numpy(counts[order].astype(np.int32)))
        self.register_buffer("order", torch.from_numpy(order.astype(np.int32)))

    @property
    def slots(self) -> int:
        return self.idx.shape[0]


def natural_gather_mat(tab: GatherTables) -> GatherMat:
    """The level's row-gather form back in its natural row order (undoing
    the tables' sort by slot count), as host numpy arrays."""
    order = tab.order.cpu().numpy().astype(np.int64)
    words = tab.vals.cpu().numpy().view(np.uint32).transpose(0, 2, 1)     # (K, rows, W)
    limbs = np.empty(words.shape[:2] + (2 * words.shape[2],), np.uint32)
    limbs[..., 0::2], limbs[..., 1::2] = words & 0xFFFF, words >> 16
    idx = np.empty(tuple(tab.idx.shape), np.int32)
    vals = np.empty_like(limbs)
    idx[:, order] = tab.idx.cpu().numpy()
    vals[:, order] = limbs
    return GatherMat(rows=tab.rows, cols=tab.cols, idx=idx, vals=vals)


def _word_limbs(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., 2W) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((w & 0xFFFF, w >> 16), dim=-1).flatten(-2)


def gather_matvec_plain(tab: GatherTables, x: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """y = A x for batched x (b, cols, L) -> (b, rows, L) int32: the
    reference's slot loop (one gather and one exact limb product per slot,
    summed unreduced in int64, one Barrett at the end) over the kernel's
    tables, the words split into limbs, the rows put back in order; on x's
    device."""
    lf = limb_field(field)
    width = 2 * lf.L + 2
    acc = torch.zeros((x.shape[0], tab.rows, width), dtype=torch.int64, device=x.device)
    for k in range(tab.slots):
        xg = x[:, tab.idx[k].long()]                                  # (b, rows, L)
        acc[..., :2 * lf.L] += lf._mul_digits(_word_limbs(tab.vals[k].t())[None], xg)
        if k % _PLAIN_SLOTS == _PLAIN_SLOTS - 1:
            acc = lf._carry_norm(acc, width)
    y = lf.barrett_reduce(lf._carry_norm(acc, width)).to(torch.int32)
    out = torch.empty_like(y)
    out[:, tab.order.long()] = y
    return out


def gather_matvec(tab: GatherTables, x: torch.Tensor, field: FieldSpec) -> torch.Tensor:
    """One expander level (K5 on CUDA, :func:`gather_matvec_plain` on CPU)."""
    b, cols, L = x.shape
    if cols != tab.cols or L != field.num_limbs16 or 2 * tab.vals.shape[1] != L:
        raise ValueError(f"gather_matvec: x {tuple(x.shape)} against a level of "
                         f"{tab.cols} columns ({field.name})")
    if x.device.type == "cpu":
        return gather_matvec_plain(tab, x, field)
    kernels.check_cuda("gather_matvec x", x, torch.int32)
    for name in ("idx", "vals", "counts", "order"):
        t = getattr(tab, name)
        kernels.check_cuda(f"gather_matvec {name}", t, torch.int32)
        if t.device != x.device:
            raise ValueError(f"gather_matvec: {name} on {t.device}, x on {x.device}")
    if (L not in (4, 8, 12, 16) or x.data_ptr() % 16 or tab.rows >= 1 << 31
            or -(-b // b_tile(L // 2, b)) > 65535):
        raise ValueError(f"expander kernel: unsupported x {tuple(x.shape)} or {tab.rows} rows")
    p, mu = limb_field(field).wide_consts
    out = torch.empty((b, tab.rows, L), dtype=torch.int32, device=x.device)
    if b == 0 or tab.rows == 0:
        return out
    with torch.cuda.device(x.device):
        kernels.EXPANDER(kernels.ptr(x), kernels.ptr(tab.idx), kernels.ptr(tab.vals),
                         kernels.ptr(tab.counts), kernels.ptr(tab.order), kernels.ptr(out), b,
                         cols, tab.rows, L, kernels.ptr(p), kernels.ptr(mu), len(mu),
                         kernels.stream_of(x))
    return out


def vandermonde_matrix(n_points: int, width: int, field: FieldSpec) -> np.ndarray:
    """(n_points, width, L) uint32 limbs: V[r, j] = (r+1)^j (encode.rs:97-110
    points)."""
    rows = []
    for r in range(n_points):
        x = (r + 1) % field.modulus
        row = [1] * width
        for j in range(1, width):
            row[j] = (row[j - 1] * x) % field.modulus
        rows.append(ints_to_limbs(row, field))
    return np.stack(rows)


class ExpanderEncoder(torch.nn.Module):
    """The encode of one (n, seed, field, spec) instance: every level's
    gather tables and the Vandermonde matrix as buffers, built on the CPU
    and copied once to each other device it encodes on (:meth:`on`).
    :meth:`encode` runs on its input's device."""

    def __init__(self, field: FieldSpec, spec: SdigSpec, precodes: list[GatherMat],
                 postcodes: list[GatherMat], vander: np.ndarray | None = None):
        super().__init__()
        self.field = field
        self.spec = spec
        self.n_per_row = precodes[0].cols
        self.codeword_len = codeword_length(precodes, postcodes)
        self.pre = torch.nn.ModuleList(GatherTables(gm) for gm in precodes)
        self.post = torch.nn.ModuleList(GatherTables(gm) for gm in postcodes)
        if vander is None:
            vander = vandermonde_matrix(postcodes[-1].cols, precodes[-1].rows, field)
        self.register_buffer("vander", torch.from_numpy(np.asarray(vander, np.int32)))
        self._on = {self.vander.device: self}

    @classmethod
    def build(cls, n: int, seed: int, field: FieldSpec, spec: SdigSpec):
        """Generate the matrices (matgen.rs) and build their tables."""
        precodes, postcodes = generate(n, seed, field, spec)
        return cls(field, spec, [to_gather(m, field) for m in precodes],
                   [to_gather(m, field) for m in postcodes])

    def on(self, device: torch.device) -> "ExpanderEncoder":
        """This encoder's copy on `device` (an indexed device, as a tensor's)."""
        if device not in self._on:
            dup = copy.copy(self)            # shares _on; deepcopy would copy it
            dup._modules = copy.deepcopy(self._modules)
            dup._buffers = dict(self._buffers)
            dup.to(device)
            self._on[device] = dup
        return self._on[device]

    def encode(self, x: torch.Tensor, matvec=None) -> torch.Tensor:
        """(b, n_per_row, L) int32 -> (b, codeword_len, L), following
        encode.rs:36-95, on x's device.  Each level goes through `matvec`
        (default :func:`gather_matvec`; a checker passes its own)."""
        matvec = matvec or gather_matvec
        me = self.on(x.device)
        lf = limb_field(self.field)
        nl = len(me.pre)
        parts = [x]                              # parts[i] = input to level i
        cur = x
        for tab in me.pre[:-1]:
            cur = matvec(tab, cur, self.field)
            parts.append(cur)
        temp = matvec(me.pre[nl - 1], cur, self.field)
        # RS base case: out[r] = sum_j temp[j] * (r+1)^j
        parts.append(lf.dot(me.vander[None], temp[:, None], axis=-2).to(torch.int32))
        for i in range(nl - 1, -1, -1):
            zin = torch.cat(parts[i + 1:], dim=1)
            parts.append(matvec(me.post[i], zin, self.field))
        out = torch.cat(parts, dim=1)
        assert out.shape[1] == self.codeword_len
        return out

    # The expander's per-level gather graph (encode.rs:36-110) is sharded over
    # the mesh by output rows, as in the JAX package: shard k computes block k
    # of each level's output rows from the level's whole input, and the blocks
    # are all-gathered into the next level's input.  The graphs are seeded
    # uniform with ~7-10 inputs an output column, so a block of output rows
    # reads most of the input rows anyway: exact halos would move about as
    # much as the all-gather does.

    def wide_operands(self, mesh: Mesh) -> dict[str, list[list[GatherTables]]]:
        """Each level's tables cut into the mesh's blocks of output rows, in
        the level's natural row order (:func:`natural_gather_mat`; each block
        then sorted by slot count on its own) and put on the block's device:
        ``{"pre": [[block k of level i, ...], ...], "post": [...]}``.
        Blocks of :func:`parallel.mesh.shard_slices`: the last ones may be
        shorter or empty.  Kept for the last mesh asked for."""
        cached = getattr(self, "_wide_operands", None)
        if cached is not None and cached[0] == mesh.devices:
            return cached[1]

        def split(tab: GatherTables) -> list[GatherTables]:
            gm = natural_gather_mat(tab)
            return [GatherTables(GatherMat(rows=s.stop - s.start, cols=gm.cols,
                                           idx=gm.idx[:, s], vals=gm.vals[:, s])).to(dev)
                    for s, dev in zip(shard_slices(gm.rows, mesh.size), mesh.devices)]

        ops = {"pre": [split(t) for t in self.pre], "post": [split(t) for t in self.post]}
        self._wide_operands = (mesh.devices, ops)
        return ops

    def encode_wide(self, blocks: list[torch.Tensor], mesh: Mesh, matvec=None
                    ) -> list[torch.Tensor]:
        """:meth:`encode` over the mesh.  `blocks`: the D column blocks of
        (b, w, L) int32 rows, block k on ``mesh.devices[k]``, with the
        coefficients in the first n_per_row columns (w >= n_per_row; the
        rest is ignored).  Returns the D column blocks of the codewords,
        zero-padded to ncp = codeword_len rounded up to a multiple of D, ncp/D
        columns each.  Each level runs `matvec` (default
        :func:`gather_matvec`, K5 on CUDA) on every shard's block of rows;
        the RS base case and the concatenations run once a device."""
        matvec = matvec or gather_matvec
        ops = self.wide_operands(mesh)
        lf = limb_field(self.field)
        D = mesh.size
        b, _, L = blocks[0].shape

        def level(tabs, inputs):
            ys = [matvec(tab, inputs[dev], self.field) for tab, dev in zip(tabs, mesh.devices)]
            return dict(zip(mesh.devices, all_gather(ys, mesh, 1)))

        x = dict(zip(mesh.devices, all_gather(blocks, mesh, 1)))
        x = {dev: v[:, :self.n_per_row].contiguous() for dev, v in x.items()}
        nl = len(self.pre)
        parts = [x]                              # parts[i] = input to level i, a device
        cur = x
        for i in range(nl - 1):
            cur = level(ops["pre"][i], cur)
            parts.append(cur)
        temp = level(ops["pre"][nl - 1], cur)
        parts.append({dev: lf.dot(self.on(dev).vander[None], t[:, None], axis=-2)
                      .to(torch.int32) for dev, t in temp.items()})
        for i in range(nl - 1, -1, -1):
            zin = {dev: torch.cat([p[dev] for p in parts[i + 1:]], dim=1) for dev in x}
            parts.append(level(ops["post"][i], zin))
        out = {dev: torch.cat([p[dev] for p in parts], dim=1) for dev in x}
        c = -(-self.codeword_len // D)
        shards = []
        for k, dev in enumerate(mesh.devices):
            block = torch.zeros((b, c, L), dtype=torch.int32, device=dev)
            take = max(0, min(c, self.codeword_len - k * c))
            block[:, :take] = out[dev][:, k * c:k * c + take]
            shards.append(block)
        return shards
