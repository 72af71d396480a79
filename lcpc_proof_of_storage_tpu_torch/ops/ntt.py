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
:func:`ntt_plain` / :func:`intt_plain`, a CUDA tensor to the kernel, which
runs the radix-2 DIT stages in two passes over device memory for n up to
2^20 (:func:`ntt_pass_plan`; :func:`ntt_passes_plain` runs the same passes
tile by tile in plain PyTorch).  :func:`ntt_rows` is K1 on rows as they are
stored: int32 or 16-bit limbs, narrower than n, and the 16-bit copy of the
output written by the kernel too (the streamed Ligero commit's batches).
:func:`encode_rows` and :func:`decode_rows` are the Ligero row encode and
its inverse built on them.

Two more routes compute the same transforms, bit-equal, for the Ligero
encoding's ``ntt=`` choice (``codes/ligero.py``):

* :func:`ntt_four_step` (forward only) follows the JAX package's
  ``ops/ntt_pallas2.py ntt_four_step`` in its default ``xpose`` mode: n =
  n1 * n2, one pass of packed n2-point sub-NTTs, one pass of n1-point
  sub-NTTs after the diagonal twiddle w_n^(j1 k2) (K4f,
  ``_in_tile_call_mul``), with the permutations between them as torch
  index_select / transpose glue.  Outside the reference's window 1024 < n
  <= 2^20 (``_fs_split``) it is :func:`ntt`, as the reference's dispatch.
* :func:`ntt_fused_small` (forward and inverse) follows ``ops/ntt_pallas.py
  ntt_pallas`` (K6): every stage with half below the tile in one pass
  (``_fused_small_call``), then the stages above it (``_stage_call``) by
  K1's passes, then the n^-1 product for the inverse (``_scale_call``).

Both take n_nonzero as the reference's routes do, as a promise that the
positions at or past it are zero (the Ligero encode's padding), and skip
the stages that would only duplicate values.  Both run on packed 32-bit
words (W = L/2 a value) between their steps and
share one orchestration between the devices: only the calls to the tile
kernel KT (:func:`ntt_tile_stages`, ``csrc/ntt_tile.cu``), to K1's passes
(:func:`ntt_stages`) and to the modular product KM
(:func:`mul_mod`) dispatch, to the kernel for a CUDA tensor and to the plain
version for a CPU tensor.  Given a ``calls`` list, a route appends each KT
and KM call it makes (:class:`TileCall`, :class:`MulModCall`: the inputs and
arguments), so a caller can run that call again, or its plain version, on
the very inputs the route gave it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import kernels
from ..fields.field import FieldSpec, ints_to_limbs
from ..fields.limb import LimbField, limb_field, narrow_limbs, widen_limbs
from ..utils.profiling import KernelCost, modmul_cost, tile_cost


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


ROUTES = ("stages", "four_step", "fused_small")
FS_MAX = 1024        # the four-step's largest sub-length (ntt_pallas2.py _TILE2)
# fused_small's tile: the reference's v1 tile (ntt_pallas.py _TILE), 11 stages in
# one pass; its 64 KB of words at W = 8 leave room for three blocks an SM
FUSED_TILE = 2048
TILE_MAX = 4096      # the largest tile KT's shared memory holds at W = 8 (128 KB)


def _fs_split(n: int) -> tuple[int, int] | None:
    """(n1, n2), n1 * n2 = n, both <= FS_MAX, n1 <= n2; None outside the
    four-step's window 1024 < n <= 2^20 (ntt_pallas2.py _fs_split)."""
    if n <= FS_MAX or n > FS_MAX * FS_MAX:
        return None
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def _skip_for(n: int, n_nonzero: int | None) -> int:
    """Stages that only duplicate values when positions >= n_nonzero are zero:
    log2(n / np2(n_nonzero)) (ntt_pallas.py / ntt_pallas2.py _skip_for)."""
    if n_nonzero is not None and 0 < n_nonzero < n:
        np2 = 1 << (n_nonzero - 1).bit_length()
        return (n // np2).bit_length() - 1
    return 0


def _words(limbs: np.ndarray) -> np.ndarray:
    """(..., L) 16-bit limbs -> (..., W) uint32 words, least significant first."""
    limbs = limbs.astype(np.int64)
    return (limbs[..., 0::2] | (limbs[..., 1::2] << 16)).astype(np.uint32)


def _neg_limbs(limbs: np.ndarray, spec: FieldSpec) -> np.ndarray:
    """p - v for (m, L) canonical nonzero limbs v."""
    L = spec.num_limbs16
    p = [(spec.modulus >> (16 * i)) & 0xFFFF for i in range(L)]
    out = np.empty(limbs.shape, np.int64)
    borrow = np.zeros(limbs.shape[0], np.int64)
    for i in range(L):
        d = p[i] - limbs[:, i].astype(np.int64) - borrow
        borrow = (d < 0).astype(np.int64)
        out[:, i] = d + (borrow << 16)
    return out


def _four_step_twiddles(spec: FieldSpec, n: int, n1: int, tw: np.ndarray, mont: np.ndarray):
    """The diagonal twiddle of the four-step's second pass at lane h*n1 + u:
    w_n^(rev1[u] * h) (ntt_pallas2.py _fs_tables_np), as (n, L) limbs and as
    (n, W) Montgomery words.  Gathered from the w^j tables of j < n/2, with
    w^(j + n/2) = -w^j."""
    rev1 = _bit_reverse_perm(n1)
    e = ((np.arange(n // n1, dtype=np.int64)[:, None] * rev1[None, :]) % n).reshape(-1)
    mont_limbs = np.empty((mont.shape[0], 2 * mont.shape[1]), np.int64)
    m = mont.view(np.uint32).astype(np.int64)
    mont_limbs[:, 0::2], mont_limbs[:, 1::2] = m & 0xFFFF, m >> 16
    full = np.concatenate([tw.astype(np.int64), _neg_limbs(tw, spec)])
    full_mont = np.concatenate([mont_limbs, _neg_limbs(mont_limbs, spec)])
    return full[e].astype(np.int32), _words(full_mont[e]).view(np.int32)


class NttTables(torch.nn.Module):
    """Twiddle tables of one transform size, as buffers that move with the
    module: ``tw`` / ``tw_inv`` (w^j / w^-j limbs) for the plain versions,
    ``tw_mont`` / ``tw_inv_mont`` (their Montgomery words) for the kernels,
    and ``n_inv`` (n^-1 mod p as limbs).  ``p_words`` and ``n_inv_mont``
    (n^-1 in Montgomery form) are host words the kernels take by value.

    ``route`` adds what one of :data:`ROUTES` needs besides: ``rev`` (the
    bit-reversal of n) for ``fused_small``; ``rev1`` / ``rev2`` (those of n1
    and n2) and the diagonal twiddle ``fs_tw`` / ``fs_tw_mont`` ((n, L) limbs
    and (n, W) Montgomery words) for ``four_step`` inside its window.  Every
    sub-length's stage twiddles are entries of ``tw_mont``: w_m = w_n^(n/m)."""

    def __init__(self, spec: FieldSpec, n: int, route: str = "stages"):
        super().__init__()
        if n < 2 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
        if route not in ROUTES:
            raise ValueError(f"NTT route must be one of {ROUTES}, got {route!r}")
        self.spec = spec
        self.n = n
        self.route = route
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
        if route == "fused_small":
            self.register_buffer("rev", torch.from_numpy(_bit_reverse_perm(n)))
        split = _fs_split(n)
        if route == "four_step" and split is not None:
            n1, n2 = split
            self.register_buffer("rev1", torch.from_numpy(_bit_reverse_perm(n1)))
            self.register_buffer("rev2", torch.from_numpy(_bit_reverse_perm(n2)))
            fs_tw, fs_mont = _four_step_twiddles(spec, n, n1, tw, mont)
            self.register_buffer("fs_tw", torch.from_numpy(fs_tw))
            self.register_buffer("fs_tw_mont", torch.from_numpy(np.ascontiguousarray(fs_mont)))

    @property
    def device(self) -> torch.device:
        return self.tw.device


def _dit_stage(x: torch.Tensor, lf: LimbField, tw: torch.Tensor, s: int, log_n: int,
               s_lo: int = 0, lo: torch.Tensor | None = None) -> torch.Tensor:
    """One radix-2 DIT stage over aligned runs of (batch, m, L) int64 values:
    stage s of a 2^log_n transform whose runs start at stage s_lo, so the
    pairs are i and i + half, half = 2^(s - s_lo), m a multiple of 2 half.
    tw holds the transform's w^j (or w^-j); pair i takes entry
    ((i mod half) << s_lo | lo) << (log_n-1-s), lo each row's low position
    bits (K1's strided tiles, ``lo`` of shape (batch,)) or 0."""
    batch, m, L = x.shape
    half = 1 << (s - s_lo)
    xv = x.reshape(batch, m // (2 * half), 2, half, L)
    a, b = xv[:, :, 0], xv[:, :, 1]
    k = torch.arange(half, device=x.device) << s_lo
    if lo is None:
        w = tw[k << (log_n - 1 - s)]
    else:
        w = tw[(k[None, :] | lo[:, None]) << (log_n - 1 - s)][:, None]
    y = lf.mul(b, w)
    return torch.stack([lf.add(a, y), lf.sub(a, y)], dim=2).reshape(batch, m, L)


def _ntt_core(x: torch.Tensor, lf: LimbField, tw: torch.Tensor, s0: int = 0) -> torch.Tensor:
    """Radix-2 DIT stages s0 .. log2(n)-1 on bit-reversed (batch, n, L)
    input, int64."""
    log_n = x.shape[1].bit_length() - 1
    for s in range(s0, log_n):
        x = _dit_stage(x, lf, tw, s, log_n)
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


K_MAX = 10   # the most stages one pass of K1 / K4 runs: tiles of up to 2^10 values


def ntt_pass_plan(n: int, k_max: int = K_MAX) -> list[tuple[int, int]]:
    """The stage groups [s_lo, s_hi) of K1's and K4's passes (``csrc/ntt.cu``
    ``pass_group``): the stages 0 .. log2(n)-1 in P = ceil(log2(n) / k_max)
    consecutive groups, the first log2(n) mod P of them one stage longer."""
    log_n = n.bit_length() - 1
    if n < 2 or n & (n - 1) or k_max < 1:
        raise ValueError(f"ntt_pass_plan: n = {n}, k_max = {k_max}")
    P = -(-log_n // k_max)
    q, r = divmod(log_n, P)
    groups, lo = [], 0
    for g in range(P):
        hi = lo + q + (g < r)
        groups.append((lo, hi))
        lo = hi
    return groups


def ntt_pass_tiles(n: int, s_lo: int, s_hi: int, first: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The tiles of one pass over a row of n, as ``csrc/ntt.cu ntt_pass`` maps
    them: (n / 2^k, 2^k) positions j in transform order (tile, slot), k =
    s_hi - s_lo, and each tile's lo (j mod 2^s_lo).  A tile is the elements
    j = hi * 2^s_hi + i * 2^s_lo + lo; tile id r is lo fastest, except in the
    first pass of a transform, where tile r reads natural column r, so its hi
    is the bit-reversal of r.  The kernel's block takes T consecutive ids."""
    k = s_hi - s_lo
    r = torch.arange(n >> k, dtype=torch.int64)
    if first:
        hi, lo = torch.from_numpy(_bit_reverse_perm(n >> k)), torch.zeros_like(r)
    else:
        hi, lo = r >> s_lo, r & ((1 << s_lo) - 1)
    i = torch.arange(1 << k, dtype=torch.int64)
    return (hi << s_hi | lo)[:, None] + (i << s_lo)[None, :], lo


def ntt_passes_plain(x: torch.Tensor, tables: NttTables, n_nonzero: int | None = None,
                     inverse: bool = False, k_max: int = K_MAX) -> torch.Tensor:
    """K1 (or, with ``inverse``, K4's inverse) the way ``csrc/ntt.cu`` runs it,
    in plain PyTorch: the passes of :func:`ntt_pass_plan`, each gathering its
    tiles by :func:`ntt_pass_tiles`, running its stages on them with
    :func:`_dit_stage` and scattering them back.  The first pass's gather is
    the prologue: slot j of a row holds x[rev(j & ~(2^skip - 1))], zero at
    or past n_nonzero (the pruned stages, :func:`_skip_for`);
    the inverse scales by n^-1 at the end.  Equal to :func:`ntt_plain` /
    :func:`intt_plain`; it exists to check the plan and the index map on a
    CPU, and no path calls it.  (batch, n, L) limbs -> int32 limbs."""
    batch, n, L = x.shape
    spec = tables.spec
    n_nonzero = _check_args(x, spec, None if inverse else n_nonzero)
    tables = _tables_for(spec, n, x, tables)
    log_n = n.bit_length() - 1
    skip = 0 if inverse else _skip_for(n, n_nonzero)
    lf = limb_field(spec)
    tw = tables.tw_inv if inverse else tables.tw
    x = x.to(torch.int64)
    work = torch.empty((batch, n, L), dtype=torch.int64, device=x.device)
    for g, (s_lo, s_hi) in enumerate(ntt_pass_plan(n, k_max)):
        pos, lo = (t.to(x.device) for t in ntt_pass_tiles(n, s_lo, s_hi, g == 0))
        if g == 0:
            src = torch.from_numpy(_bit_reverse_perm(n)).to(x.device)[pos & ~((1 << skip) - 1)]
            y = torch.where((src < n_nonzero)[None, :, :, None], x[:, src], 0)
        else:
            y = work[:, pos]
        ntiles, size = pos.shape
        y = y.reshape(batch * ntiles, size, L)
        lo = lo.repeat(batch)
        for s in range(max(skip, s_lo), s_hi):
            y = _dit_stage(y, lf, tw, s, log_n, s_lo, lo)
        work[:, pos] = y.reshape(batch, ntiles, size, L)
    if inverse:
        work = lf.mul(work, tables.n_inv)
    return work.to(torch.int32)


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


def _check_rows_args(x: torch.Tensor, spec: FieldSpec, n: int, n_nonzero: int | None,
                     out16: torch.Tensor | None) -> int:
    L = spec.num_limbs16
    if x.dim() != 3 or x.shape[-1] != L:
        raise ValueError(f"ntt_rows: expected (batch, width, {L}), got {tuple(x.shape)}")
    if x.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"ntt_rows: expected int16 or int32 limbs, got {x.dtype}")
    if n < 2 or n & (n - 1):
        raise ValueError(f"ntt_rows: n must be a power of two >= 2, got {n}")
    batch, width, _ = x.shape
    if not 1 <= width <= n:
        raise ValueError(f"ntt_rows: rows of {width} values, transform of {n}")
    n_nonzero = width if n_nonzero is None else n_nonzero
    if not 0 <= n_nonzero <= width:
        raise ValueError(f"ntt_rows: n_nonzero {n_nonzero} outside [0, {width}]")
    if out16 is not None:
        if out16.dtype != torch.int16:
            raise TypeError(f"ntt_rows: out16 must be int16, got {out16.dtype}")
        if tuple(out16.shape) != (batch, n, L) or out16.device != x.device:
            raise ValueError(f"ntt_rows: out16 must be ({batch}, {n}, {L}) on {x.device}, "
                             f"got {tuple(out16.shape)} on {out16.device}")
    return n_nonzero


def _ntt_rows_cuda(x: torch.Tensor, n: int, n_nonzero: int, tables: NttTables,
                   out16: torch.Tensor | None) -> torch.Tensor:
    batch, width, L = x.shape
    W = L // 2
    kernels.check_cuda("ntt_rows", x, x.dtype)
    if out16 is not None:
        kernels.check_cuda("ntt_rows out16", out16, torch.int16)
    if W not in (2, 4, 6, 8) or batch * n >= (1 << 31):
        raise ValueError(f"ntt_rows kernel: unsupported shape {tuple(x.shape)} to n = {n}")
    for t in (x, out16):        # a value's words move in 16-byte pieces, or 8 at W = 2, 6
        if t is None:
            continue
        piece = 16 if t.dtype == torch.int32 or W % 4 == 0 else 8
        if t.data_ptr() % piece:
            raise ValueError(f"ntt_rows kernel: a tensor at {t.data_ptr():#x} is not "
                             f"{piece}-byte aligned")
    out = torch.empty((batch, n, L), dtype=torch.int32, device=x.device)
    work = torch.empty((batch, n, W), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        kernels.NTT_FORWARD_ROWS(kernels.ptr(x), kernels.ptr(out),
                                 None if out16 is None else kernels.ptr(out16),
                                 kernels.ptr(work), kernels.ptr(tables.tw_mont), batch,
                                 n.bit_length() - 1, width, n_nonzero,
                                 int(x.dtype == torch.int16), W, kernels.ptr(tables.p_words),
                                 kernels.stream_of(x))
    return out


def ntt_rows(x: torch.Tensor, spec: FieldSpec, n: int, n_nonzero: int | None = None,
             tables: NttTables | None = None,
             out16: torch.Tensor | None = None) -> torch.Tensor:
    """Forward NTT of rows as they are stored: x is (batch, width, L) int32
    limbs or 16-bit limbs as int16, width <= n, read as zero-padded to n and
    as zero at or past ``n_nonzero`` (default: width) -> the (batch, n, L)
    int32 evaluations.  Given ``out16``, a contiguous (batch, n, L) int16
    tensor (a row slice of a larger one will do), they are also written there
    as 16-bit limbs.  On CUDA, K1 reads the rows at their own width and its
    last pass writes out16 (``csrc/ntt.cu lcpc_ntt_forward_rows``); on the
    CPU, :func:`widen_limbs`, the zero pad, :func:`ntt_plain` and
    :func:`narrow_limbs`."""
    n_nonzero = _check_rows_args(x, spec, n, n_nonzero, out16)
    tables = _tables_for(spec, n, x, tables)
    if x.device.type == "cuda":
        return _ntt_rows_cuda(x, n, n_nonzero, tables, out16)
    if x.device.type != "cpu":
        raise ValueError(f"ntt_rows: no kernel for device {x.device}")
    batch, width, L = x.shape
    padded = torch.zeros((batch, n, L), dtype=torch.int32)
    padded[:, :width] = widen_limbs(x)
    y = ntt_plain(padded, spec, n_nonzero, tables)
    if out16 is not None:
        out16.copy_(narrow_limbs(y))
    return y


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


def _tables_for(spec: FieldSpec, n: int, x: torch.Tensor, tables: NttTables | None,
                route: str = "stages") -> NttTables:
    if tables is None:
        return NttTables(spec, n, route).to(x.device)
    if tables.n != n or tables.spec != spec:
        raise ValueError("ntt: tables are for another field or size")
    if tables.device != x.device:
        raise ValueError(f"ntt: tables on {tables.device}, input on {x.device}")
    if route != "stages" and tables.route != route:
        raise ValueError(f"ntt: tables built for route {tables.route!r}, not {route!r}")
    return tables


# --------------------------------------------------------------------------
# the four_step and fused_small routes
# --------------------------------------------------------------------------

def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., L) canonical 16-bit limbs -> (..., W) int32 bit patterns of the
    uint32 words (the kernels' layout)."""
    v = limbs[..., 0::2].to(torch.int64) | (limbs[..., 1::2].to(torch.int64) << 16)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_words`: (..., W) words -> (..., L) int32 limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2).to(torch.int32)


def _limbs64(x: torch.Tensor, L: int) -> torch.Tensor:
    """Limbs (..., L) or words (..., L/2) -> int64 limbs (..., L)."""
    if x.shape[-1] == L:
        return x.to(torch.int64)
    if x.shape[-1] == L // 2:
        return unpack_words(x).to(torch.int64)
    raise ValueError(f"expected (..., {L}) limbs or (..., {L // 2}) words, got {tuple(x.shape)}")


def _check_aligned(what: str, *ts: torch.Tensor) -> None:
    """KT and KM move values in 16-byte pieces: raise on a tensor that does
    not start on a 16-byte boundary (a view at an odd offset)."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: a tensor at {t.data_ptr():#x} is not 16-byte "
                             f"aligned")


def _check_tile_args(x: torch.Tensor, tables: NttTables, s0: int, s1: int, diag: bool) -> int:
    """The number of values in x; raises on stages or shapes KT does not take."""
    L = tables.spec.num_limbs16
    if x.shape[-1] not in (L, L // 2):
        raise ValueError(f"ntt_tile: expected (..., {L}) limbs or (..., {L // 2}) words, "
                         f"got {tuple(x.shape)}")
    count = x.numel() // x.shape[-1]
    if not 0 <= s0 <= s1 or (1 << s1) > min(TILE_MAX, tables.n) or count % (1 << s1):
        raise ValueError(f"ntt_tile: stages {s0}..{s1} do not tile {count} values "
                         f"(tables of n = {tables.n}, tiles up to {TILE_MAX})")
    if diag and (not hasattr(tables, "fs_tw") or count % tables.n):
        raise ValueError("ntt_tile: the twiddle prologue needs four_step tables and whole rows")
    return count


TILE_MIN_BLOCKS = 256   # KT holds fewer runs a block while its grid has fewer blocks


def tile_plan(count: int, s1: int, W: int) -> int:
    """log2 of the values one block of KT holds, passed to the kernel as its
    log_span: whole runs of 2^s1, as many as K1's blocks hold (2^11 values at
    W >= 6, 2^10 at W <= 4; one run if it is longer), and half as many while
    the grid of ceil(count / 2^log_span) blocks would have fewer than
    :data:`TILE_MIN_BLOCKS`."""
    log_span = max(s1, 10 if W <= 4 else 11)
    while log_span > s1 and (count + (1 << log_span) - 1) >> log_span < TILE_MIN_BLOCKS:
        log_span -= 1
    return log_span


def ntt_tile_stages_plain(x: torch.Tensor, tables: NttTables, s0: int, s1: int,
                          diag: bool = False, inverse: bool = False,
                          out_limbs: bool = False) -> torch.Tensor:
    """Plain version of KT (any device): on runs of 2^s1 consecutive values of
    x (limbs (..., L) or words (..., W)), optionally multiply each value by
    the four-step's diagonal twiddle of its position in its row of n
    (``diag``), then run the radix-2 DIT stages s0 .. s1-1 with the w^j (or
    w^-j) twiddles.  Returns words, or limbs if ``out_limbs``."""
    count = _check_tile_args(x, tables, s0, s1, diag)
    spec = tables.spec
    L = spec.num_limbs16
    lf = limb_field(spec)
    y = _limbs64(x, L).reshape(count, L)
    if diag:
        y = lf.mul(y.reshape(-1, tables.n, L), tables.fs_tw).reshape(count, L)
    y = y.reshape(count >> s1, 1 << s1, L)
    tw = tables.tw_inv if inverse else tables.tw
    for s in range(s0, s1):
        y = _dit_stage(y, lf, tw, s, tables.n.bit_length() - 1)
    y = y.reshape(*x.shape[:-1], L).to(torch.int32)
    return y if out_limbs else pack_words(y)


def _ntt_tile_cuda(x: torch.Tensor, tables: NttTables, s0: int, s1: int, diag: bool,
                   inverse: bool, out_limbs: bool) -> torch.Tensor:
    count = _check_tile_args(x, tables, s0, s1, diag)
    kernels.check_cuda("ntt_tile", x, torch.int32)
    L = tables.spec.num_limbs16
    W = L // 2
    if W not in (2, 4, 6, 8) or count >= (1 << 31):
        raise ValueError(f"ntt_tile kernel: unsupported shape {tuple(x.shape)}")
    if tables.device != x.device:
        raise ValueError(f"ntt_tile: tables on {tables.device}, input on {x.device}")
    _check_aligned("ntt_tile", x)
    out = torch.empty((*x.shape[:-1], L if out_limbs else W), dtype=torch.int32,
                      device=x.device)
    tw = tables.tw_inv_mont if inverse else tables.tw_mont
    with torch.cuda.device(x.device):
        kernels.NTT_TILE(kernels.ptr(x), kernels.ptr(out), kernels.ptr(tw),
                         kernels.ptr(tables.fs_tw_mont) if diag else None, count,
                         tables.n.bit_length() - 1, s0, s1, tile_plan(count, s1, W),
                         int(x.shape[-1] == L), int(out_limbs), W, kernels.ptr(tables.p_words),
                         kernels.stream_of(x))
    return out


def ntt_tile_stages(x: torch.Tensor, tables: NttTables, s0: int, s1: int, *,
                    diag: bool = False, inverse: bool = False,
                    out_limbs: bool = False) -> torch.Tensor:
    """KT (``csrc/ntt_tile.cu``) on a CUDA tensor, :func:`ntt_tile_stages_plain`
    on a CPU tensor: the same function."""
    if x.device.type == "cpu":
        return ntt_tile_stages_plain(x, tables, s0, s1, diag, inverse, out_limbs)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_tile: no kernel for device {x.device}")
    return _ntt_tile_cuda(x, tables, s0, s1, diag, inverse, out_limbs)


def ntt_stages(words: torch.Tensor, tables: NttTables, s0: int,
               inverse: bool = False) -> torch.Tensor:
    """Radix-2 DIT stages s0 .. log2(n)-1 over whole rows of (batch, n, W)
    words, then the limbs (batch, n, L): on a CUDA tensor K1's own passes
    from stage s0 on (``csrc/ntt.cu`` ``lcpc_ntt_stages``, counted as K1; the
    words are transformed in place), on a CPU tensor :func:`_ntt_core`."""
    batch, n, W = words.shape
    if n != tables.n or W != tables.spec.num_limbs16 // 2 or not 0 <= s0 <= n.bit_length() - 1:
        raise ValueError(f"ntt_stages: words {tuple(words.shape)}, stages from {s0}, "
                         f"tables of n = {tables.n}")
    if words.device.type == "cpu":
        tw = tables.tw_inv if inverse else tables.tw
        x = _limbs64(words, 2 * W)
        return _ntt_core(x, limb_field(tables.spec), tw, s0).to(torch.int32)
    if words.device.type != "cuda":
        raise ValueError(f"ntt_stages: no kernel for device {words.device}")
    kernels.check_cuda("ntt_stages", words, torch.int32)
    if W not in (2, 4, 6, 8) or batch * n >= (1 << 31):
        raise ValueError(f"ntt_stages kernel: unsupported shape {tuple(words.shape)}")
    out = torch.empty((batch, n, 2 * W), dtype=torch.int32, device=words.device)
    tw = tables.tw_inv_mont if inverse else tables.tw_mont
    with torch.cuda.device(words.device):
        kernels.NTT_STAGES(kernels.ptr(words), kernels.ptr(out), kernels.ptr(tw), batch,
                           n.bit_length() - 1, s0, W, kernels.ptr(tables.p_words),
                           kernels.stream_of(words))
    return out


@functools.lru_cache(maxsize=None)
def _mul_mod_consts(spec: FieldSpec) -> tuple[np.ndarray, np.ndarray]:
    """Host words of p and of R^2 mod p, R = 2^(32W)."""
    p = spec.modulus
    W = spec.num_limbs16 // 2
    r2 = (1 << (64 * W)) % p
    return tuple(np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(W)], dtype=np.uint32)
                 for v in (p, r2))


def _check_mul_mod_args(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> None:
    L = spec.num_limbs16
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != L or b.shape[1] != L or b.shape[0] < 1:
        raise ValueError(f"mul_mod: expected (N, {L}) and (b_rows >= 1, {L}), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")


def mul_mod_plain(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Plain version of KM (any device): out[i] = a[i] * b[i mod b_rows] mod p
    for canonical (N, L) and (b_rows, L) limbs; int32."""
    _check_mul_mod_args(a, b, spec)
    idx = torch.arange(a.shape[0], device=a.device) % b.shape[0]
    return limb_field(spec).mul(a, b[idx]).to(torch.int32)


def mul_mod(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """KM (``csrc/ntt_tile.cu`` ``lcpc_mul_mod``) on CUDA tensors,
    :func:`mul_mod_plain` on CPU tensors: out[i] = a[i] * b[i mod b_rows] mod
    p.  It serves the JAX package's ``mul_mod_pallas`` (b_rows = N) and
    ``_scale_call`` (b the single constant n^-1)."""
    if a.device.type == "cpu":
        return mul_mod_plain(a, b, spec)
    if a.device.type != "cuda":
        raise ValueError(f"mul_mod: no kernel for device {a.device}")
    _check_mul_mod_args(a, b, spec)
    kernels.check_cuda("mul_mod", a, torch.int32)
    kernels.check_cuda("mul_mod", b, torch.int32)
    W = spec.num_limbs16 // 2
    if W not in (2, 4, 6, 8) or a.shape[0] >= (1 << 31) or b.device != a.device:
        raise ValueError(f"mul_mod kernel: unsupported inputs {tuple(a.shape)} on {a.device}, "
                         f"{tuple(b.shape)} on {b.device}")
    out = torch.empty_like(a)
    if not a.shape[0]:
        return out
    _check_aligned("mul_mod", a, b)
    p_words, r2_words = _mul_mod_consts(spec)
    with torch.cuda.device(a.device):
        kernels.MUL_MOD(kernels.ptr(a), kernels.ptr(b), kernels.ptr(out), a.shape[0],
                        b.shape[0], W, kernels.ptr(p_words), kernels.ptr(r2_words),
                        kernels.stream_of(a))
    return out


@dataclasses.dataclass(frozen=True)
class TileCall:
    """One KT call of a route: ``call()`` runs :func:`ntt_tile_stages` on
    these inputs, ``call.plain()`` :func:`ntt_tile_stages_plain`."""
    x: torch.Tensor
    tables: NttTables
    s0: int
    s1: int
    diag: bool = False
    inverse: bool = False
    out_limbs: bool = False

    def __call__(self) -> torch.Tensor:
        return ntt_tile_stages(self.x, self.tables, self.s0, self.s1, diag=self.diag,
                               inverse=self.inverse, out_limbs=self.out_limbs)

    def plain(self) -> torch.Tensor:
        return ntt_tile_stages_plain(self.x, self.tables, self.s0, self.s1, self.diag,
                                     self.inverse, self.out_limbs)

    def cost(self) -> KernelCost:
        """:func:`~..utils.profiling.tile_cost` of this call (the prologue's
        twiddles equal to 1 counted in the tables)."""
        L = self.tables.spec.num_limbs16
        ones = 0
        if self.diag:    # the diagonal twiddles equal to 1 (limbs 1, 0, .., 0)
            t = self.tables.fs_tw
            ones = int(((t[:, 0] == 1) & (t[:, 1:] == 0).all(-1)).sum())
        return tile_cost(self.x.numel() // self.x.shape[-1], L, self.s0, self.s1,
                         self.x.shape[-1] == L, self.out_limbs,
                         self.tables.n if self.diag else 0, ones)


@dataclasses.dataclass(frozen=True)
class MulModCall:
    """One KM call of a route: ``call()`` runs :func:`mul_mod`,
    ``call.plain()`` :func:`mul_mod_plain`."""
    a: torch.Tensor
    b: torch.Tensor
    spec: FieldSpec

    def __call__(self) -> torch.Tensor:
        return mul_mod(self.a, self.b, self.spec)

    def plain(self) -> torch.Tensor:
        return mul_mod_plain(self.a, self.b, self.spec)

    def cost(self) -> KernelCost:
        return modmul_cost(self.a.shape[0], self.spec.num_limbs16, self.b.shape[0])


def _launch(call: TileCall | MulModCall, calls: list | None) -> torch.Tensor:
    if calls is not None:
        calls.append(call)
    return call()


def _dup_rows(rev: torch.Tensor, skip: int) -> torch.Tensor:
    """rev[j & ~(2^skip - 1)]: the bit-reversal with each run of 2^skip
    taking its first entry (the pruned stages' duplication)."""
    return rev[::1 << skip].repeat_interleave(1 << skip) if skip else rev


def ntt_four_step(x: torch.Tensor, spec: FieldSpec, n_nonzero: int | None = None,
                  tables: NttTables | None = None, *, calls: list | None = None) -> torch.Tensor:
    """Forward NTT along axis -2 by the four-step split (the JAX package's
    ``ntt_four_step``, ``xpose`` mode), bit-equal to :func:`ntt`.

    Positions at or past n_nonzero must be zero (the Ligero encode's padding):
    as in the reference, the first pass skips the stages that would only
    duplicate them.  With j = j1 + n1 j2 and k = k2 + n2 k1:

    1. P0: rows j2 taken in bit-reversed order (a run of 2^skip rows per
       entry), then the (n2, n1) transpose: one torch gather of the limbs;
    2. KT pass A: the n2-point sub-NTTs, stages skip .. log2(n2)-1, limbs
       in, words out (no launch when every stage is skipped);
    3. P1: rows j1 in bit-reversed order, then the transpose (a gather);
    4. KT pass B: each value times w_n^(j1 k2), then the n1-point
       sub-NTTs, limbs out;
    5. P2: the transpose to natural order.

    Outside 1024 < n <= 2^20 this is :func:`ntt` (K1), as in the reference.
    KT's calls are appended to ``calls`` when it is given."""
    batch, n, L = x.shape
    n_nonzero = _check_args(x, spec, n_nonzero)
    split = _fs_split(n)
    if split is None:
        return ntt(x, spec, n_nonzero, tables)
    tables = _tables_for(spec, n, x, tables, "four_step")
    n1, n2 = split
    skip = _skip_for(n2, -(-n_nonzero // n1) if 0 < n_nonzero < n else None)
    log_n2 = n2.bit_length() - 1
    a = x.reshape(batch, n2, n1, L).transpose(1, 2).index_select(2, _dup_rows(tables.rev2, skip))
    if skip < log_n2:
        a = _launch(TileCall(a, tables, skip, log_n2), calls)
    b = a.transpose(1, 2).index_select(2, tables.rev1)
    c = _launch(TileCall(b, tables, 0, n1.bit_length() - 1, diag=True, out_limbs=True), calls)
    return c.transpose(1, 2).reshape(batch, n, L)


def ntt_fused_small(x: torch.Tensor, spec: FieldSpec, n_nonzero: int | None = None,
                    tables: NttTables | None = None, inverse: bool = False,
                    tile: int = FUSED_TILE, *, calls: list | None = None) -> torch.Tensor:
    """Forward (or, with ``inverse``, inverse) NTT along axis -2 the way the
    JAX package's ``ntt_pallas`` runs it, bit-equal to :func:`ntt` /
    :func:`intt`:

    1. the bit-reversal gather, each run of 2^skip rows taking its first
       (the forward transform's pruned stages; positions at or past
       n_nonzero must be zero);
    2. KT: every stage with half below the tile T = min(tile, n), limbs in;
    3. K1's passes for the stages with half >= T, unpacking in the last;
    4. the inverse's n^-1 product, KM with one broadcast row.

    ``tile`` is a power of two up to :data:`TILE_MAX`.  KT's and KM's calls
    are appended to ``calls`` when it is given."""
    batch, n, L = x.shape
    n_nonzero = _check_args(x, spec, None if inverse else n_nonzero)
    if tile < 2 or tile & (tile - 1) or tile > TILE_MAX:
        raise ValueError(f"ntt_fused_small: tile must be a power of two in [2, {TILE_MAX}]")
    tables = _tables_for(spec, n, x, tables, "fused_small")
    log_n = n.bit_length() - 1
    log_t = min(tile, n).bit_length() - 1
    skip = 0 if inverse else _skip_for(n, n_nonzero)
    g = x.index_select(1, _dup_rows(tables.rev, skip))
    if log_t == log_n:
        y = _launch(TileCall(g, tables, min(skip, log_n), log_n, inverse=inverse,
                             out_limbs=True), calls)
    else:
        words = _launch(TileCall(g, tables, min(skip, log_t), log_t, inverse=inverse), calls)
        y = ntt_stages(words, tables, max(skip, log_t), inverse)
    if inverse:
        y = _launch(MulModCall(y.reshape(batch * n, L), tables.n_inv.reshape(1, L), spec),
                    calls)
    return y.reshape(batch, n, L)
