"""Batched forward and inverse NTT over limb-decomposed fields.

Counterpart of ``lcpc_proof_of_storage_tpu/ops/ntt.py`` (plain versions),
of ``ops/ntt_pallas3.py`` (kernel K1, ``csrc/ntt.cu``) and of the inverse
half of ``ops/ntt_pallas2.py`` (kernel K4, ``csrc/ntt.cu``
``lcpc_ntt_inverse``; K4's forward half is K1's function).  Along axis -2 of
a (batch, n, L) limb tensor, the forward transform gives the natural-order
evaluations at w^0..w^(n-1) of the coefficients in the first ``n_nonzero``
positions (positions at or past ``n_nonzero`` are read as zero); the
inverse gives the coefficients back from the evaluations.

:func:`ntt` and :func:`intt` are the entry points: a CPU tensor goes to
:func:`ntt_plain` / :func:`intt_plain`, a CUDA tensor to the kernel.
:func:`encode_rows` and :func:`decode_rows` are the Ligero row encode and
its inverse built on them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..fields.field import FieldSpec, ints_to_limbs
from ..fields.limb import LimbField, limb_field, widen_limbs


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _mont_words(vals: list[int], spec: FieldSpec) -> np.ndarray:
    """Values v -> (len, W) uint32 words of the Montgomery form v * 2^(32W)
    mod p (W = L/2 words of 32 bits, least significant first)."""
    p = spec.modulus
    r = (1 << (16 * spec.num_limbs16)) % p
    mont = ints_to_limbs([v * r % p for v in vals], spec).astype(np.int64)
    return (mont[:, 0::2] | (mont[:, 1::2] << 16)).astype(np.uint32)


def _ntt_tables(spec: FieldSpec, n: int):
    """Twiddles w^j and w^-j for j < n/2, each as (n/2, L) int32 limbs and,
    for the kernels, as (n/2, W) 32-bit words of the Montgomery form.  Stage
    s (half = 2^s) uses w_{2 half}^k = w^(k * n / (2 half)).  Since
    w^(n/2) = -1, w^-j = p - w^(n/2 - j) for 0 < j < n/2."""
    p = spec.modulus
    w = spec.nth_root_of_unity(n)
    h = n // 2
    vals = [1] * h
    for j in range(1, h):
        vals[j] = vals[j - 1] * w % p
    inv = [1] + [p - vals[h - j] for j in range(1, h)]
    return [(ints_to_limbs(v, spec).astype(np.int32), _mont_words(v, spec).view(np.int32))
            for v in (vals, inv)]


class NttTables(torch.nn.Module):
    """Twiddle tables of one transform size, as buffers that move with the
    module: ``tw`` / ``tw_inv`` (w^j / w^-j limbs) for the plain versions,
    ``tw_mont`` / ``tw_inv_mont`` (their Montgomery words) for the kernels,
    and ``n_inv`` (n^-1 mod p as limbs).  ``p_words`` and ``n_inv_mont``
    (n^-1 in Montgomery form) are host words the kernels take by value."""

    def __init__(self, spec: FieldSpec, n: int):
        super().__init__()
        if n < 2 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
        self.spec = spec
        self.n = n
        (tw, mont), (tw_inv, mont_inv) = _ntt_tables(spec, n)
        self.register_buffer("tw", torch.from_numpy(tw))
        self.register_buffer("tw_mont", torch.from_numpy(np.ascontiguousarray(mont)))
        self.register_buffer("tw_inv", torch.from_numpy(tw_inv))
        self.register_buffer("tw_inv_mont", torch.from_numpy(np.ascontiguousarray(mont_inv)))
        p = spec.modulus
        n_inv = spec.inv(n % p)
        self.register_buffer("n_inv", torch.from_numpy(
            ints_to_limbs([n_inv], spec)[0].astype(np.int32)))
        L = spec.num_limbs16
        self.p_words = np.array([(p >> (32 * i)) & 0xFFFFFFFF for i in range(L // 2)],
                                dtype=np.uint32)
        self.n_inv_mont = _mont_words([n_inv], spec)[0]

    @property
    def device(self) -> torch.device:
        return self.tw.device


def _ntt_core(x: torch.Tensor, lf: LimbField, tw: torch.Tensor) -> torch.Tensor:
    """Radix-2 DIT stages on bit-reversed (batch, n, L) input, int64."""
    batch, n, L = x.shape
    log_n = n.bit_length() - 1
    for s in range(log_n):
        half = 1 << s
        xv = x.reshape(batch, n // (2 * half), 2, half, L)
        a, b = xv[:, :, 0], xv[:, :, 1]
        w = tw[torch.arange(half, device=x.device) << (log_n - 1 - s)]
        y = lf.mul(b, w)
        x = torch.stack([lf.add(a, y), lf.sub(a, y)], dim=2).reshape(batch, n, L)
    return x


def ntt_plain(x: torch.Tensor, spec: FieldSpec, n_nonzero: int | None = None,
              tables: NttTables | None = None) -> torch.Tensor:
    """Plain PyTorch forward NTT (any device): (batch, n, L) -> int32."""
    batch, n, L = x.shape
    n_nonzero = _check_args(x, spec, n_nonzero)
    tables = _tables_for(spec, n, x, tables)
    x = x.to(torch.int64)
    if n_nonzero < n:
        x = x.clone()
        x[:, n_nonzero:] = 0
    x = x[:, torch.from_numpy(_bit_reverse_perm(n)).to(x.device)]
    return _ntt_core(x, limb_field(spec), tables.tw).to(torch.int32)


def intt_plain(x: torch.Tensor, spec: FieldSpec, tables: NttTables | None = None) -> torch.Tensor:
    """Plain PyTorch inverse NTT (any device): the DIT stages of
    :func:`ntt_plain` with the w^-j twiddles, then the n^-1 scale;
    (batch, n, L) evaluations -> int32 coefficients."""
    batch, n, L = x.shape
    _check_args(x, spec, None)
    tables = _tables_for(spec, n, x, tables)
    lf = limb_field(spec)
    x = x.to(torch.int64)[:, torch.from_numpy(_bit_reverse_perm(n)).to(x.device)]
    return lf.mul(_ntt_core(x, lf, tables.tw_inv), tables.n_inv).to(torch.int32)


def _check_kernel_shape(x: torch.Tensor, what: str) -> int:
    batch, n, L = x.shape
    kernels.check_cuda(what, x, torch.int32)
    W = L // 2
    if W not in (2, 4, 6, 8) or batch * n >= (1 << 31):
        raise ValueError(f"{what} kernel: unsupported shape {tuple(x.shape)}")
    return W


def _ntt_cuda(x: torch.Tensor, spec: FieldSpec, n_nonzero: int,
              tables: NttTables) -> torch.Tensor:
    batch, n, L = x.shape
    W = _check_kernel_shape(x, "ntt")
    out = torch.empty_like(x)
    work = torch.empty((batch, n, W), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        kernels.NTT_FORWARD(kernels.ptr(x), kernels.ptr(out), kernels.ptr(work),
                            kernels.ptr(tables.tw_mont), batch, n.bit_length() - 1,
                            n_nonzero, W, kernels.ptr(tables.p_words), kernels.stream_of(x))
    return out


def _intt_cuda(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    batch, n, L = x.shape
    W = _check_kernel_shape(x, "intt")
    out = torch.empty_like(x)
    work = torch.empty((batch, n, W), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        kernels.NTT_INVERSE(kernels.ptr(x), kernels.ptr(out), kernels.ptr(work),
                            kernels.ptr(tables.tw_inv_mont), batch, n.bit_length() - 1, W,
                            kernels.ptr(tables.p_words), kernels.ptr(tables.n_inv_mont),
                            kernels.stream_of(x))
    return out


def ntt(x: torch.Tensor, spec: FieldSpec, n_nonzero: int | None = None,
        tables: NttTables | None = None) -> torch.Tensor:
    """Forward NTT along axis -2 (K1 on CUDA, :func:`ntt_plain` on CPU)."""
    if x.device.type == "cpu":
        return ntt_plain(x, spec, n_nonzero, tables)
    if x.device.type != "cuda":
        raise ValueError(f"ntt: no kernel for device {x.device}")
    n_nonzero = _check_args(x, spec, n_nonzero)
    return _ntt_cuda(x, spec, n_nonzero, _tables_for(spec, x.shape[1], x, tables))


def intt(x: torch.Tensor, spec: FieldSpec, tables: NttTables | None = None) -> torch.Tensor:
    """Inverse NTT along axis -2 (K4's inverse entry on CUDA,
    :func:`intt_plain` on CPU)."""
    if x.device.type == "cpu":
        return intt_plain(x, spec, tables)
    if x.device.type != "cuda":
        raise ValueError(f"intt: no kernel for device {x.device}")
    _check_args(x, spec, None)
    return _intt_cuda(x, _tables_for(spec, x.shape[1], x, tables))


def encode_rows(coeff_rows: torch.Tensor, spec: FieldSpec, n_cols: int,
                tables: NttTables | None = None) -> torch.Tensor:
    """Ligero row encode: (batch, n_per_row, L) coefficient rows zero-padded
    to n_cols, then :func:`ntt` with n_nonzero = n_per_row."""
    b, npr, L = coeff_rows.shape
    if npr > n_cols:
        raise ValueError(f"encode_rows: rows of {npr} coefficients, code has {n_cols}")
    padded = coeff_rows.new_zeros((b, n_cols, L), dtype=torch.int32)
    padded[:, :npr] = widen_limbs(coeff_rows)
    return ntt(padded, spec, npr, tables)


def decode_rows(enc_rows: torch.Tensor, spec: FieldSpec, n_per_row: int,
                tables: NttTables | None = None) -> torch.Tensor:
    """Inverse of :func:`encode_rows`: :func:`intt`, then the first
    n_per_row coefficients of each row."""
    return intt(enc_rows, spec, tables)[:, :n_per_row]


def _check_args(x: torch.Tensor, spec: FieldSpec, n_nonzero: int | None) -> int:
    if x.dim() != 3 or x.shape[-1] != spec.num_limbs16:
        raise ValueError(f"ntt: expected (batch, n, {spec.num_limbs16}), got {tuple(x.shape)}")
    n = x.shape[1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"ntt: n must be a power of two >= 2, got {n}")
    n_nonzero = n if n_nonzero is None else n_nonzero
    if not 0 <= n_nonzero <= n:
        raise ValueError(f"ntt: n_nonzero {n_nonzero} outside [0, {n}]")
    return n_nonzero


def _tables_for(spec: FieldSpec, n: int, x: torch.Tensor,
                tables: NttTables | None) -> NttTables:
    if tables is None:
        return NttTables(spec, n).to(x.device)
    if tables.n != n or tables.spec != spec:
        raise ValueError("ntt: tables are for another field or size")
    if tables.device != x.device:
        raise ValueError(f"ntt: tables on {tables.device}, input on {x.device}")
    return tables
