"""Batched forward NTT over limb-decomposed fields.

Counterpart of ``lcpc_proof_of_storage_tpu/ops/ntt.py`` (plain version) and
of ``ops/ntt_pallas3.py`` (kernel K1, ``csrc/ntt.cu``).  Both compute, along
axis -2 of a (batch, n, L) limb tensor, the natural-order evaluations at
w^0..w^(n-1) of the coefficients in the first ``n_nonzero`` positions;
positions at or past ``n_nonzero`` are read as zero.

:func:`ntt` is the one entry point: a CPU tensor goes to :func:`ntt_plain`,
a CUDA tensor to the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..fields.field import FieldSpec, ints_to_limbs
from ..fields.limb import LimbField, limb_field


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _ntt_tables(spec: FieldSpec, n: int):
    """Twiddles w^j for j < n/2, as (n/2, L) limbs and, for the kernel, as
    (n/2, W) 32-bit words of the Montgomery form w^j * 2^(32W) mod p.  Stage
    s (half = 2^s) uses w_{2 half}^k = w^(k * n / (2 half))."""
    p = spec.modulus
    w = spec.nth_root_of_unity(n)
    vals = [1] * (n // 2)
    for j in range(1, n // 2):
        vals[j] = vals[j - 1] * w % p
    L = spec.num_limbs16
    r = (1 << (16 * L)) % p
    tw = ints_to_limbs(vals, spec).astype(np.int32)
    mont = ints_to_limbs([v * r % p for v in vals], spec).astype(np.int64)
    mont_words = (mont[:, 0::2] | (mont[:, 1::2] << 16)).astype(np.uint32).view(np.int32)
    return tw, mont_words


class NttTables(torch.nn.Module):
    """Twiddle tables of one transform size, as buffers that move with the
    module: ``tw`` for the plain version, ``tw_mont`` for the kernel."""

    def __init__(self, spec: FieldSpec, n: int):
        super().__init__()
        if n < 2 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
        self.spec = spec
        self.n = n
        tw, mont = _ntt_tables(spec, n)
        self.register_buffer("tw", torch.from_numpy(tw))
        self.register_buffer("tw_mont", torch.from_numpy(np.ascontiguousarray(mont)))
        L = spec.num_limbs16
        p = spec.modulus
        self.p_words = np.array([(p >> (32 * i)) & 0xFFFFFFFF for i in range(L // 2)],
                                dtype=np.uint32)

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


def _ntt_cuda(x: torch.Tensor, spec: FieldSpec, n_nonzero: int,
              tables: NttTables) -> torch.Tensor:
    batch, n, L = x.shape
    kernels.check_cuda("ntt", x, torch.int32)
    W = L // 2
    if W not in (2, 4, 6, 8) or batch * n >= (1 << 31):
        raise ValueError(f"ntt kernel: unsupported shape {tuple(x.shape)}")
    out = torch.empty_like(x)
    work = torch.empty((batch, n, W), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        kernels.NTT_FORWARD(kernels.ptr(x), kernels.ptr(out), kernels.ptr(work),
                            kernels.ptr(tables.tw_mont), batch, n.bit_length() - 1,
                            n_nonzero, W, kernels.ptr(tables.p_words), kernels.stream_of(x))
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
