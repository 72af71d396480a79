"""Ligero (Reed-Solomon over an NTT domain) as lcpc-ligero-pc defines it.

The dimensions solver (lcpc-ligero-pc/src/lib.rs:61-118) and the encoding of
one row: the n_per_row coefficients, zero-padded to n_cols, evaluated at the
powers of a primitive n_cols-th root of unity, w^0 .. w^(n_cols-1) (the
generator raised to (p-1)/n_cols), in natural order.
"""

from __future__ import annotations

import math

import numpy as np

from .field import Field

LAMBDA = 128


def ceil_log2(v: int) -> int:
    return 0 if v <= 1 else (v - 1).bit_length()


def n_degree_tests(n_cols: int, field: Field) -> int:
    den = field.bits - 1 - ceil_log2(n_cols)
    return (LAMBDA + den - 1) // den


def n_col_opens(rho: tuple[int, int]) -> int:
    r = rho[0] / rho[1]
    return math.ceil(-LAMBDA / math.log2((1.0 + r) / 2.0))


def next_pow2(v: int) -> int:
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


def dims(length: int, field: Field, rho: tuple[int, int]) -> tuple[int, int, int]:
    """(n_rows, n_per_row, n_cols): the proof-size-optimising solver."""
    r = rho[0] / rho[1]
    lncf = float(n_col_opens(rho) * length)
    ndt = float(n_degree_tests(math.ceil(math.sqrt(lncf) / r), field))
    nc1 = next_pow2(math.ceil(math.sqrt(lncf / ndt) / r))
    np1 = nc1 * rho[0] // rho[1]
    nr1 = -(-length // np1)
    nc2, np2 = nc1 // 2, np1 // 2
    if np2 == 0:
        return nr1, np1, nc1
    nr2 = -(-length // np2)
    sz1 = n_col_opens(rho) * nr1 + (1 + n_degree_tests(nc1, field)) * np1
    sz2 = n_col_opens(rho) * nr2 + (1 + n_degree_tests(nc2, field)) * np2
    return (nr1, np1, nc1) if sz1 < sz2 else (nr2, np2, nc2)


def encode_row(values: list[int], n_cols: int, field: Field) -> list[int]:
    """The codeword of one row: y[k] = sum_j values[j] w^(j k) mod p, by a
    radix-2 transform on Python integers (numpy object arrays)."""
    p = field.modulus
    n = n_cols
    log_n = n.bit_length() - 1
    x = np.zeros(n, dtype=object)
    x[:len(values)] = values
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((np.arange(n) >> b) & 1) << (log_n - 1 - b)
    a = x[rev]
    w = field.root_of_unity(n)
    tw = np.empty(n // 2, dtype=object)
    acc = 1
    for j in range(n // 2):
        tw[j] = acc
        acc = acc * w % p
    half = 1
    while half < n:
        # sums and differences are left unreduced (Python integers grow a
        # bit a stage); only the twiddle products are reduced
        a = a.reshape(-1, 2, half)
        t = (a[:, 1, :] * tw[::n // (2 * half)][None, :]) % p
        u = a[:, 0, :]
        a = np.stack([u + t, u - t], axis=1).reshape(-1)
        half *= 2
    return (a % p).tolist()


class Code:
    """The reference side of a Ligero configuration."""

    def __init__(self, cfg: dict, field: Field):
        self.field = field
        self.rho = tuple(cfg["rho"])
        self.dims = dims(1 << cfg["log2_coeffs"], field, self.rho)
        self.n_col_opens = n_col_opens(self.rho)
        self.n_degree_tests = n_degree_tests(self.dims[2], field)

    def encode_row(self, values: list[int]) -> list[int]:
        return encode_row(values, self.dims[2], self.field)
