"""Prime fields of the configurations, and exact sums of limb matrices.

A field element on the device is L little-endian 16-bit limbs (int32, or
int16 holding the same bits).  The reference's linear combinations of rows
of such a matrix run as float64 matrix products of limbs: a product of two
limbs is below 2^32 and a sum of fewer than 2^21 of them below 2^53, so every
float64 partial sum is an exact integer, whatever order the GPU adds in.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Field:
    name: str
    modulus: int
    generator: int

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def repr_bytes(self) -> int:
        """The canonical repr: the value as [u64; limbs], little-endian."""
        return 8 * ((self.bits + 63) // 64)

    @property
    def limbs(self) -> int:
        return self.repr_bytes // 2

    def root_of_unity(self, n: int) -> int:
        """A primitive n-th root of unity (n a power of two): the generator
        raised to (p - 1) / n."""
        s, v = 0, self.modulus - 1
        while v % 2 == 0:
            s, v = s + 1, v // 2
        if n & (n - 1) or n.bit_length() - 1 > s:
            raise ValueError(f"no subgroup of order {n} in {self.name}")
        w = pow(self.generator, v, self.modulus)
        return pow(w, 1 << (s - (n.bit_length() - 1)), self.modulus)


FIELDS = {f.name: f for f in (
    Field("ft63", 5102708120182849537, 10),
    Field("ft127", 146823888364060453008360742206866194433, 3),
    Field("ft255", 46242760681095663677370860714659204618859642560429202607213929836750194081793,
          5),
)}


def ints_to_limbs(values, field: Field) -> np.ndarray:
    """Python ints -> (n, L) int64 16-bit limbs."""
    w = field.repr_bytes
    buf = b"".join(int(v).to_bytes(w, "little") for v in values)
    return np.frombuffer(buf, "<u2").astype(np.int64).reshape(-1, field.limbs)


def limbs_to_ints(limbs: np.ndarray) -> list[int]:
    """(n, L) 16-bit limbs (any integer dtype) -> Python ints."""
    a = np.ascontiguousarray(np.asarray(limbs).astype("<u2"))
    w = a.shape[-1] * 2
    buf = a.tobytes()
    return [int.from_bytes(buf[i:i + w], "little") for i in range(0, len(buf), w)]


def wide_to_ints(wide: torch.Tensor) -> list[int]:
    """(n, D) int64 digit sums (digit k weighs 2^16k, each below 2^62) ->
    Python ints, by a carry pass into 16-bit digits."""
    n, D = wide.shape
    extra = 4
    out = torch.zeros((n, D + extra), dtype=torch.int64, device=wide.device)
    carry = torch.zeros(n, dtype=torch.int64, device=wide.device)
    for k in range(D + extra):
        t = carry + (wide[:, k] if k < D else 0)
        out[:, k] = t & 0xFFFF
        carry = t >> 16
    if bool((carry != 0).any()):
        raise OverflowError("digit sums exceed the carry pass")
    return limbs_to_ints(out.cpu().numpy())


def _limb_matrix_f64(rows: torch.Tensor) -> torch.Tensor:
    """(..., L) int16 / int32 limbs -> the same 16-bit digits as float64."""
    return (rows.to(torch.int32) & 0xFFFF).to(torch.float64)


def _convolve(prod: torch.Tensor, L: int) -> torch.Tensor:
    """(La, n, Lb) float64 digit products -> (n, La + Lb - 1) int64 sums
    over a + b = k."""
    La, n, Lb = prod.shape
    p = prod.to(torch.int64)
    out = torch.zeros((n, La + Lb - 1), dtype=torch.int64, device=prod.device)
    for a in range(La):
        out[:, a:a + Lb] += p[a]
    return out


def combine_rows(weights: list[int], mat: torch.Tensor, field: Field,
                 block: int = 8192) -> list[int]:
    """sum_i weights[i] * mat[i, c] mod p for every column c of a
    (n_rows, n_cols, L) limb matrix on any device, in column blocks."""
    n_rows, n_cols, L = mat.shape
    if n_rows >= 1 << 21:
        raise ValueError("too many rows for exact float64 sums")
    w = torch.from_numpy(ints_to_limbs(weights, field).T.copy()).to(
        device=mat.device, dtype=torch.float64)                        # (L, n_rows)
    out: list[int] = []
    p = field.modulus
    for c0 in range(0, n_cols, block):
        c1 = min(c0 + block, n_cols)
        m = _limb_matrix_f64(mat[:, c0:c1]).reshape(n_rows, -1)          # (n_rows, B*L)
        prod = (w @ m).reshape(L, c1 - c0, L)
        del m
        out += [v % p for v in wide_to_ints(_convolve(prod, L))]
    return out


def row_dots(mat: torch.Tensor, vectors: list[list[int]], field: Field,
             block: int = 64) -> list[list[int]]:
    """For each vector v (n_per_row values): <mat[i], v> mod p for every row
    i of a (n_rows, n_per_row, L) limb matrix, in row blocks."""
    n_rows, npr, L = mat.shape
    if npr >= 1 << 21:
        raise ValueError("rows too long for exact float64 sums")
    P = len(vectors)
    v = torch.from_numpy(np.concatenate([ints_to_limbs(x, field) for x in vectors], axis=1)
                         ).to(device=mat.device, dtype=torch.float64)      # (npr, P*L)
    res: list[list[int]] = [[] for _ in range(P)]
    p = field.modulus
    for r0 in range(0, n_rows, block):
        r1 = min(r0 + block, n_rows)
        m = _limb_matrix_f64(mat[r0:r1]).permute(0, 2, 1).reshape(-1, npr)   # ((r, a), j)
        prod = (m @ v).reshape(r1 - r0, L, P, L)                          # r, a, p, b
        del m
        prod = prod.permute(1, 0, 2, 3).reshape(L, (r1 - r0) * P, L)
        vals = [x % p for x in wide_to_ints(_convolve(prod, L))]
        for i in range(r1 - r0):
            for k in range(P):
                res[k].append(vals[i * P + k])
    return res


def noncanonical(mat: torch.Tensor, field: Field, block: int = 1 << 23) -> int:
    """How many limb vectors of a contiguous (..., L) matrix are >= p."""
    L = mat.shape[-1]
    flat = mat.reshape(-1, L)
    p_limbs = [int(v) for v in ints_to_limbs([field.modulus], field)[0]]
    count = 0
    for e0 in range(0, flat.shape[0], block):
        x = flat[e0:e0 + block].to(torch.int32) & 0xFFFF
        lt = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        eq = torch.ones_like(lt)
        for j in range(L - 1, -1, -1):
            lt |= eq & (x[:, j] < p_limbs[j])
            eq &= x[:, j] == p_limbs[j]
        count += int((~lt).sum())
    return count
