"""Brakedown's SDIG expander code as lcpc-brakedown-pc defines it.

The code's dimensions (codespec.rs, matgen.rs:56-112), the seeded matrices
(matgen.rs:28-188: one ChaCha20 stream a level, the precode's then the
postcode's columns, each column d distinct uniform rows, then d nonzero
field values read as Montgomery forms) and the encoding of one row
(encode.rs:36-110, the Reed-Solomon base case at the points 1, 2, 3, ...).
The matrices are generated by walking a peeked window of the stream with
numpy searches, column after column, as a plain reading of the generator.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass

import numpy as np

from .chacha import ChaCha, M64, seed_from_u64, uniform_zone
from .field import Field
from .ligero import LAMBDA, ceil_log2


@dataclass(frozen=True)
class Sdig:
    alpha: tuple[int, int]
    beta: tuple[int, int]
    r: tuple[int, int]
    baselen: int = 20

    def dist(self) -> float:
        return (self.beta[0] * self.r[1]) / (self.beta[1] * self.r[0])


CODES = {"sdig3": Sdig((89, 500), (61, 1000), (1521, 1000))}


def _ent(z: float) -> float:
    return -z * math.log2(z) - (1 - z) * math.log2(1 - z)


def _cmd(n: int, f: tuple[int, int]) -> int:
    return (n * f[0] + f[1] - 1) // f[1]


def level_dims(n: int, field: Field, code: Sdig):
    """Per level: the precode's (n, m, d) and the postcode's (n', m', d')."""
    a, b, r = (x[0] / x[1] for x in (code.alpha, code.beta, code.r))
    mu = r - 1.0 - r * a
    nu = b + a * b + 0.03
    cn1, cn2 = _ent(b) + a * _ent(1.28 * b / a), b * math.log2(a / (1.28 * b))
    dn1, dn2 = r * a * _ent(b / r) + mu * _ent(nu / mu), a * b * math.log2(mu / nu)
    log2p = float(field.bits - 1)
    sizes = [n]
    while sizes[-1] > code.baselen:
        sizes.append(_cmd(sizes[-1], code.alpha))
    pre, post = [], []
    for ni, mi in zip(sizes, sizes[1:]):
        cn = min(max(_cmd(ni, (32 * code.beta[0], 25 * code.beta[1])),
                     4 + _cmd(ni, code.beta)),
                 math.ceil((110.0 / ni + cn1) / cn2))
        pre.append((ni, mi, min(cn, mi)))
        nip = _cmd(mi, code.r)
        mip = _cmd(ni, code.r) - ni - nip
        dn = min(_cmd(ni, (2 * code.beta[0], code.beta[1]))
                 + math.ceil((_cmd(ni, code.r) - ni + 110) / log2p),
                 math.ceil((110.0 / ni + dn1) / dn2))
        post.append((nip, mip, min(dn, mip)))
    return pre, post


def codeword_len(pre, post) -> int:
    return pre[0][0] + post[-1][0] + sum(m for _, m, _ in pre[:-1]) + sum(m for _, m, _ in post)


def n_col_opens(code: Sdig) -> int:
    return math.ceil(-LAMBDA / math.log2(1.0 - code.dist() / 3.0))


def n_degree_tests(n_cols: int, field: Field) -> int:
    den = field.bits - 1 - ceil_log2(n_cols)
    return (LAMBDA + den - 1) // den


def dims(length: int, field: Field, code: Sdig) -> tuple[int, int, int]:
    """(n_rows, n_per_row, n_cols) of BrakedownEncoding::new (lib.rs:69-99)."""
    lncf = float(n_col_opens(code) * length)
    ndt = float(n_degree_tests(math.ceil(math.sqrt(lncf)) * 2, field))
    np1 = min(math.ceil(math.sqrt(lncf / ndt)), length)
    np2 = np1 // 2
    sz = [n_col_opens(code) * -(-length // w) + (1 + n_degree_tests(2 * w, field)) * w
          for w in (np1, np2)]
    npr = np1 if sz[0] < sz[1] else np2
    pre, post = level_dims(npr, field, code)
    return -(-length // npr), npr, codeword_len(pre, post)


@dataclass
class Level:
    """One sparse matrix in column form: rows (n, d) and the drawn values
    (n, d) as Python ints (the Montgomery forms; each level's sums are
    multiplied by R^-1 once)."""
    n: int
    m: int
    rows: np.ndarray
    drawn: np.ndarray


def _field_tries(W: np.ndarray, k: int, field: Field):
    """Accept bits and shaved words of every k-word try starting at each
    alignment class r (tries at r, r+k, ...)."""
    shave = 64 * k - field.bits
    p_words = [(field.modulus >> (64 * j)) & M64 for j in range(k)]
    out = []
    for r in range(k):
        A = (len(W) - r) // k
        w = W[r:r + A * k].reshape(A, k).copy()
        if shave:
            w[:, k - 1] &= np.uint64((1 << (64 - shave)) - 1)
        lt = np.zeros(A, bool)
        decided = np.zeros(A, bool)
        nz = np.zeros(A, bool)
        for j in range(k - 1, -1, -1):
            pj = np.uint64(p_words[j])
            lt |= ~decided & (w[:, j] < pj)
            decided |= w[:, j] != pj
            nz |= w[:, j] != 0
        out.append((np.flatnonzero(lt & nz), w))
    return out


def _walk(W: np.ndarray, n: int, m: int, d: int, field: Field):
    """The column-by-column walk over a peeked window W of u64 draws; None
    if W runs out.  Returns (rows (n, d), reprs (n, d, k) uint64, used)."""
    k = (field.bits + 63) // 64
    zone = np.uint64(uniform_zone(m))
    rng_m = np.uint64(m)
    lo = W * rng_m
    hi = ((W >> np.uint64(32)) * rng_m + (((W & np.uint64(0xFFFFFFFF)) * rng_m) >> np.uint64(32))
          ) >> np.uint64(32)
    ok_u = np.flatnonzero(lo <= zone)
    pos, cand = ok_u.tolist(), hi[ok_u].tolist()
    tries = _field_tries(W, k, field)
    goods = [g.tolist() for g, _ in tries]
    ptr = [0] * k
    rows = []
    col_class = np.empty(n, np.int64)
    col_first = np.empty(n, np.int64)
    cur = j = 0
    npos = len(pos)
    for c in range(n):
        j = bisect.bisect_left(pos, cur, j)
        # d distinct rows: the accepted draws from `cur` on, duplicates skipped
        seen = cand[j:j + d]
        if len(set(seen)) == d:
            j += d
        else:
            seen = []
            while len(seen) < d:
                if j >= npos:
                    return None
                v = cand[j]
                j += 1
                if v not in seen:
                    seen.append(v)
        if j > npos:
            return None
        seen.sort()
        rows.append(seen)
        # then d accepted field tries, k words each, from the next word on
        start = pos[j - 1] + 1
        r = start % k
        t0 = (start - r) // k
        g = goods[r]
        p = bisect.bisect_left(g, t0, ptr[r])
        if p + d > len(g):
            return None
        col_class[c], col_first[c] = r, p
        ptr[r] = p + d
        cur = r + (g[p + d - 1] + 1) * k
    reprs = np.empty((n, d, k), np.uint64)
    for r in range(k):
        cols = np.flatnonzero(col_class == r)
        if len(cols):
            good, words = tries[r]
            reprs[cols] = words[good[col_first[cols, None] + np.arange(d)]]
    return np.array(rows, np.int64).reshape(n, d), reprs, cur


def _gen(n: int, m: int, d: int, rng: ChaCha, field: Field) -> Level:
    k = (field.bits + 63) // 64
    cap = int(n * (d * (1.0 + 2.0 * d / m) + k * d * 1.3)) + 4096
    while True:
        res = _walk(rng.peek_u64s(cap), n, m, d, field)
        if res is not None:
            break
        cap *= 2
    rows, reprs, used = res
    rng.skip_u64s(used)
    flat = np.ascontiguousarray(reprs.reshape(-1, k).astype("<u8")).tobytes()
    w = 8 * k
    drawn = np.empty(n * d, dtype=object)
    drawn[:] = [int.from_bytes(flat[i:i + w], "little") for i in range(0, len(flat), w)]
    return Level(n, m, rows, drawn.reshape(n, d))


def matrices(n: int, seed: int, field: Field, code: Sdig) -> tuple[list[Level], list[Level]]:
    pre_dims, post_dims = level_dims(n, field, code)
    base = seed_from_u64(seed)
    pre, post = [], []
    for i, (a, b) in enumerate(zip(pre_dims, post_dims)):
        rng = ChaCha(base, stream=i)
        pre.append(_gen(*a, rng, field))
        post.append(_gen(*b, rng, field))
    return pre, post


def _apply(level: Level, x: np.ndarray, field: Field) -> np.ndarray:
    """y = M x: y[rows[c, i]] += value[c, i] * x[c]."""
    p = field.modulus
    r_inv = pow(pow(2, field.repr_bytes * 8, p), -1, p)
    prods = (level.drawn * x[:level.n, None]).reshape(-1)
    rows = level.rows.reshape(-1)
    order = np.argsort(rows, kind="stable")
    rs = rows[order]
    starts = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]])
    y = np.zeros(level.m, dtype=object)
    y[:] = 0
    y[rs[starts]] = np.add.reduceat(prods[order], starts)
    return (y * r_inv) % p


def encode_row(values: list[int], pre: list[Level], post: list[Level],
               field: Field) -> list[int]:
    """encode.rs:36-110 on one row of n_per_row values."""
    p = field.modulus
    x = np.empty(len(values), dtype=object)
    x[:] = values
    parts = [x]
    cur = x
    for lv in pre[:-1]:
        cur = _apply(lv, cur, field)
        parts.append(cur)
    temp = _apply(pre[-1], cur, field)
    rs = np.empty(post[-1].n, dtype=object)
    for r in range(post[-1].n):
        acc, pw = 0, 1
        for t in temp:
            acc += t * pw
            pw = pw * (r + 1) % p
        rs[r] = acc % p
    parts.append(rs)
    for i in range(len(pre) - 1, -1, -1):
        parts.append(_apply(post[i], np.concatenate(parts[i + 1:]), field))
    return np.concatenate(parts).tolist()


class Code:
    """The reference side of a Brakedown configuration; its matrices are
    generated on first use."""

    def __init__(self, cfg: dict, field: Field):
        self.field = field
        self.code = CODES[cfg["code"]]
        self.seed = cfg["code_seed"]
        self.dims = dims(1 << cfg["log2_coeffs"], field, self.code)
        self.n_col_opens = n_col_opens(self.code)
        self.n_degree_tests = n_degree_tests(self.dims[2], field)
        self.levels = level_dims(self.dims[1], field, self.code)
        self._mats = None

    def encode_row(self, values: list[int]) -> list[int]:
        if self._mats is None:
            self._mats = matrices(self.dims[1], self.seed, self.field, self.code)
        return encode_row(values, *self._mats, self.field)
