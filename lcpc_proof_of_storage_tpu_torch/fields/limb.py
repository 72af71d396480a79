"""Prime-field arithmetic on 16-bit limb tensors (plain PyTorch).

Counterpart of ``lcpc_proof_of_storage_tpu/fields/limb.py``.  A field
element is a vector of ``L = num_limbs16`` canonical 16-bit limbs in the
trailing axis, little-endian limb order.  At module boundaries limbs are
``torch.int32`` (the reference's uint32 bits for values below 2^16), or
``torch.int16`` bit patterns where a streamed commitment stores them in 16
bits (:func:`widen_limbs`, :func:`narrow_limbs`); every
operation here widens to int64, where limb products and their sums are exact
without the reference's lo/hi 16-bit splitting.

The algorithms are the reference's: carry normalisation, schoolbook
products, truncated Barrett with mu = floor(2^(16m)/p) and three conditional
subtractions, lazily reduced dot products.  All results are canonical, so
they are bit-equal to the reference on canonical inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .field import FieldSpec, ints_to_limbs

I64 = torch.int64
MASK16 = 0xFFFF


def _int_to_limbs(v: int, n: int) -> list[int]:
    return [(v >> (16 * i)) & MASK16 for i in range(n)]


class LimbField:
    """Per-field constants and limb ops over tensors of any leading shape."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.L = spec.num_limbs16
        self.p_int = spec.modulus
        self.p = _int_to_limbs(spec.modulus, self.L)
        self._mu: dict[int, list[int]] = {}

    # -- constants ----------------------------------------------------------
    def mu(self, m: int) -> list[int]:
        """floor(2^(16m) / p) as limbs (for reducing m-limb wide values)."""
        if m not in self._mu:
            mu_int = (1 << (16 * m)) // self.p_int
            self._mu[m] = _int_to_limbs(mu_int, max(1, (mu_int.bit_length() + 15) // 16))
        return self._mu[m]

    @functools.cached_property
    def wide_consts(self) -> tuple[np.ndarray, np.ndarray]:
        """The host uint32 arrays K3 and K5 take: p's limbs and those of
        mu(2L + 2)."""
        return np.asarray(self.p, np.uint32), np.asarray(self.mu(2 * self.L + 2), np.uint32)

    def _const(self, limbs: list[int], like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(limbs, dtype=I64, device=like.device)

    def array(self, values, device=None) -> torch.Tensor:
        """list of python ints -> (n, L) int32 limb tensor."""
        return torch.from_numpy(
            ints_to_limbs(list(values), self.spec).astype(np.int32)).to(device)

    # -- carry plumbing ------------------------------------------------------
    @staticmethod
    def _carry_norm(digits: torch.Tensor, out_len: int) -> torch.Tensor:
        """Normalise base-2^16 digits (non-negative, < 2^62) to out_len
        16-bit limbs; overflow past out_len limbs is dropped."""
        digits = digits.to(I64)
        n = digits.shape[-1]
        outs = []
        carry = torch.zeros(digits.shape[:-1], dtype=I64, device=digits.device)
        for i in range(out_len):
            t = carry + digits[..., i] if i < n else carry
            outs.append(t & MASK16)
            carry = t >> 16
        return torch.stack(outs, dim=-1)

    @staticmethod
    def _add_raw(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
        """a + b as out_len 16-bit limbs (no modular reduction)."""
        n = max(a.shape[-1], b.shape[-1])
        pa = torch.nn.functional.pad(a.to(I64), (0, n - a.shape[-1]))
        pb = torch.nn.functional.pad(b.to(I64), (0, n - b.shape[-1]))
        return LimbField._carry_norm(pa + pb, out_len)

    @staticmethod
    def _sub_raw(a: torch.Tensor, b: torch.Tensor):
        """(a - b) mod 2^(16*len(a)), plus the final borrow (1 if a < b)."""
        a = a.to(I64)
        b = b.to(I64)
        outs = []
        shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        borrow = torch.zeros(shape, dtype=I64, device=a.device)
        for i in range(a.shape[-1]):
            y = (b[..., i] if i < b.shape[-1] else 0) + borrow
            t = a[..., i] + (1 << 16) - y
            outs.append(t & MASK16)
            borrow = 1 - (t >> 16)
        return torch.stack(outs, dim=-1), borrow

    @staticmethod
    def _mul_digits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Unnormalised product digits: (..., m) x (..., n) -> (..., m+n),
        digit k = sum_{i+j=k} a_i b_j (< min(m, n) * 2^32)."""
        a = a.to(I64)
        b = b.to(I64)
        m, n = a.shape[-1], b.shape[-1]
        shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        acc = torch.zeros((*shape, m + n), dtype=I64, device=a.device)
        for i in range(m):
            acc[..., i:i + n] += a[..., i:i + 1] * b
        return acc

    @staticmethod
    def _mul_raw(a: torch.Tensor, b: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
        """Product of limb vectors, exact (default out_len = m + n) or mod
        2^(16*out_len)."""
        if out_len is None:
            out_len = a.shape[-1] + b.shape[-1]
        return LimbField._carry_norm(LimbField._mul_digits(a, b), out_len)

    # -- modular ops ---------------------------------------------------------
    def _cond_sub_p(self, a: torch.Tensor) -> torch.Tensor:
        """a - p if a >= p else a; a may have >= L limbs."""
        d, borrow = self._sub_raw(a, self._const(self.p, a))
        return torch.where((borrow == 0)[..., None], d, a.to(I64))

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._cond_sub_p(self._add_raw(a, b, self.L + 1))[..., : self.L]

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d, borrow = self._sub_raw(a, b)
        dp = self._add_raw(d, self._const(self.p, d), self.L)
        return torch.where((borrow > 0)[..., None], dp, d)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def barrett_reduce(self, z: torch.Tensor) -> torch.Tensor:
        """Reduce z (m limbs, z < 2^(16m)) mod p -> L limbs."""
        m = z.shape[-1]
        L = self.L
        z = z.to(I64)
        if m <= L:
            return self._cond_sub_p(torch.nn.functional.pad(z, (0, L - m)))
        q1 = z[..., L - 1:]                                 # floor(z / b^(L-1))
        q = self._mul_raw(q1, self._const(self.mu(m), z))[..., m - L + 1:]
        qp = self._mul_raw(q, self._const(self.p, z), out_len=L + 1)
        r, _ = self._sub_raw(z[..., : L + 1], qp)           # r < 4p, exact
        r = self._cond_sub_p(r)
        r = self._cond_sub_p(r)
        r = self._cond_sub_p(r)
        return r[..., :L]

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.barrett_reduce(self._mul_raw(a, b))

    # -- lazy dot products ---------------------------------------------------
    def dot(self, a: torch.Tensor, b: torch.Tensor, axis: int = -2) -> torch.Tensor:
        """Modular dot product: sum over `axis` of a*b (limb axis last).

        Product digits are summed unreduced in int64 (each < L * 2^32, so
        any count below 2^26 fits) and reduced once per output element."""
        prod = self._mul_digits(a, b)
        if prod.shape[axis] >= (1 << 26):
            raise ValueError("dot: reduction axis too long for int64 digit sums")
        s = prod.sum(dim=axis)
        return self.barrett_reduce(self._carry_norm(s, 2 * self.L + 2))

    def sum(self, a: torch.Tensor, axis: int = -2) -> torch.Tensor:
        """Modular sum along an axis (not the limb axis)."""
        s = a.to(I64).sum(dim=axis)
        return self.barrett_reduce(self._carry_norm(s, self.L + 2))


def widen_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """Limbs as int32: 16-bit limbs stored as int16 bit patterns are read
    unsigned; int32 limbs pass through."""
    if limbs.dtype == torch.int16:
        return limbs.to(torch.int32) & MASK16
    return limbs.to(torch.int32)


def narrow_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical limbs (< 2^16) -> the same bits as int16 (the 16-bit storage
    of streamed commitments: torch has no arithmetic on uint16)."""
    x = limbs.to(torch.int32)
    return (x - ((x >> 15) << 16)).to(torch.int16)


@functools.lru_cache(maxsize=None)
def limb_field(spec: FieldSpec) -> LimbField:
    return LimbField(spec)
