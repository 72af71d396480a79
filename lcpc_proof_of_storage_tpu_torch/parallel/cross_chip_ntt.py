"""Cross-device NTT: transform rows longer than one device holds.

Counterpart of ``lcpc_proof_of_storage_tpu/parallel/cross_chip_ntt.py``:
the four-step NTT with the transform axis sharded over a mesh
(``parallel/mesh.py``) and the transposes exchanged all-to-all.  With
n = n1 n2, j = j1 + n1 j2 and k = k2 + n2 k1,

    X[k2 + n2 k1] = NTT_n1^{j1 -> k1}( w_n^{j1 k2} * NTT_n2^{j2 -> k2}(x) )

so a size-n transform is local size-n2 transforms, a twiddle product, and
local size-n1 transforms, with three all-to-alls moving the sharded axis
between the steps and leaving the result in natural order, contiguously
sharded.  The local transforms are ``ops/ntt.py`` :func:`ntt` / :func:`intt`
(kernels K1 and K4's inverse on CUDA), whatever the encoding's ``ntt=``
route; the twiddle product is :func:`mul_mod` (kernel KM), each shard's
twiddles on its own device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.field import FieldSpec, ints_to_limbs
from ..ops.ntt import NttTables, intt, mul_mod, ntt
from .mesh import Mesh, all_to_all, scatter


@functools.lru_cache(maxsize=16)
def _cross_twiddles(spec: FieldSpec, n1: int, n2: int, inverse: bool = False) -> np.ndarray:
    """(n1, n2, L) int32 limbs of w_n^(j1 k2) (w^-1 powers for the inverse)."""
    n = n1 * n2
    w = spec.nth_root_of_unity(n)
    if inverse:
        w = spec.inv(w)
    p = spec.modulus
    rows = []
    for j1 in range(n1):
        base = pow(w, j1, p)
        vals = [1] * n2
        for k2 in range(1, n2):
            vals[k2] = (vals[k2 - 1] * base) % p
        rows.append(ints_to_limbs(vals, spec))
    return np.stack(rows).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _cross_tables(spec: FieldSpec, n1: int, n2: int, inverse: bool,
                  devices: tuple[torch.device, ...]):
    """Shard k's (n1/D * n2, L) twiddles on devices[k], and the n1- and
    n2-point NTT tables on each device of the mesh."""
    tw = _cross_twiddles(spec, n1, n2, inverse)
    rows = n1 // len(devices)
    blocks = [torch.from_numpy(np.ascontiguousarray(tw[k * rows:(k + 1) * rows])
                               .reshape(-1, spec.num_limbs16)).to(dev)
              for k, dev in enumerate(devices)]
    tables = {dev: (NttTables(spec, n1).to(dev), NttTables(spec, n2).to(dev))
              for dev in set(devices)}
    return blocks, tables


def split_lengths(n: int, shards: int, n1: int | None = None) -> tuple[int, int]:
    """(n1, n2) of the four-step split of n over `shards` (the reference's
    rule: n1 the largest power of two <= sqrt(n), doubled until the shard
    count divides it); both must be multiples of the shard count."""
    if n1 is None:
        n1 = 1 << ((n.bit_length() - 1) // 2)
        while n1 % shards:
            n1 *= 2
    n2 = n // n1
    if n1 * n2 != n or n1 % shards or n2 % shards:
        raise ValueError(f"cross-device NTT: n = {n} does not split as n1 * n2 with "
                         f"{shards} dividing both (n1 = {n1})")
    return n1, n2


def cross_chip_ntt(x: list[torch.Tensor], spec: FieldSpec, mesh: Mesh, n1: int | None = None,
                   inverse: bool = False) -> list[torch.Tensor]:
    """NTT along axis -2 of the sharded (batch, n, L) int32 tensor `x` (the
    list of its D column blocks, (batch, n/D, L) each on its mesh device).
    Returns the natural-order transform, sharded the same way, bit-equal to
    the one-device :func:`ntt`.  With `inverse`, the four-step form of the
    inverse: the local :func:`intt` calls carry 1/n2 and 1/n1, whose product
    is 1/n, and the twiddles are powers of w^-1."""
    D = mesh.size
    if len(x) != D or len({tuple(b.shape) for b in x}) != 1:
        raise ValueError(f"cross_chip_ntt: {len(x)} blocks for a mesh of {D}")
    batch, n_loc, L = x[0].shape
    n1, n2 = split_lengths(n_loc * D, D, n1)
    twiddles, tables = _cross_tables(spec, n1, n2, inverse, mesh.devices)
    local = intt if inverse else ntt

    def transform(blocks, size, which):
        return [local(b.reshape(-1, size, L), spec, tables=tables[b.device][which])
                for b in blocks]

    # x block: (b, n2/D, n1) [j2 local, all j1]; a2a 1: split j1, join j2 -> (b, n2, n1/D)
    xm = all_to_all([b.reshape(batch, n2 // D, n1, L) for b in x], mesh, 2, 1)
    # inner transforms over j2 (size n2), then the twiddle w^(j1 k2) of the local j1 block
    xm = transform([b.transpose(1, 2) for b in xm], n2, 1)
    xm = [mul_mod(b.reshape(-1, L), tw, spec).reshape(batch, n1 // D, n2, L)
          for b, tw in zip(xm, twiddles)]
    # a2a 2: split k2, join j1 -> (b, n2/D, n1); outer transforms over j1 (size n1)
    xm = all_to_all([b.transpose(1, 2) for b in xm], mesh, 1, 2)
    xm = [b.reshape(batch, n2 // D, n1, L) for b in transform(xm, n1, 0)]
    # a2a 3: split k1, join k2 -> (b, n1/D, n2); k = k1 n2 + k2 flattens row-major
    xm = all_to_all([b.transpose(1, 2) for b in xm], mesh, 1, 2)
    return [b.reshape(batch, n_loc, L) for b in xm]


def wide_encode_rows(coeff_rows: torch.Tensor, spec: FieldSpec, n_cols: int,
                     mesh: Mesh) -> list[torch.Tensor]:
    """Ligero row encode across the mesh: (batch, n_per_row, L) int32
    coefficient rows zero-padded to n_cols and sharded, then
    :func:`cross_chip_ntt`.  The codewords come out as column blocks, the
    layout the column hash wants.  Bit-equal to ``ops/ntt.py encode_rows``."""
    if coeff_rows.shape[1] > n_cols:
        raise ValueError(f"wide_encode_rows: rows of {coeff_rows.shape[1]} coefficients, "
                         f"code has {n_cols}")
    return cross_chip_ntt(scatter(coeff_rows, mesh, 1, n_cols), spec, mesh)
