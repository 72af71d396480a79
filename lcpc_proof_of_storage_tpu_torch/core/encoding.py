"""Linear-code encoding interface (reference: LcEncoding trait,
lcpc-2d/src/lib.rs:75-105), declared again for the PyTorch port.

Counterpart of ``lcpc_proof_of_storage_tpu/core/encoding.py``, with its
mesh hooks (``with_mesh``, ``encode_wide``; the mesh is a
``parallel/mesh.py Mesh``).  The domain-separation labels keep the
reference's def_labels! quirk (lcpc-2d/src/macros.rs:29-36): every encoding
shares b"$l//DT" etc.
"""

from __future__ import annotations

import abc
import copy

import torch

from ..fields.field import FieldSpec
from ..fields.limb import narrow_limbs, widen_limbs

LABEL_DT = b"$l//DT"
LABEL_PR = b"$l//PR"
LABEL_PE = b"$l//PE"
LABEL_CO = b"$l//CO"


def ceil_log2(v: int) -> int:
    """Reference log2 (lcpc-2d/src/lib.rs:857): log2 of next power of two."""
    if v <= 1:
        return 0
    return (v - 1).bit_length()


def n_degree_tests(lam: int, length: int, flog2: int) -> int:
    """lcpc-2d/src/lib.rs:642-645."""
    den = flog2 - ceil_log2(length)
    return (lam + den - 1) // den


def next_power_of_two(v: int) -> int:
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


class LcEncoding(abc.ABC):
    """A linear code usable by the 2d polynomial commitment engine."""

    spec: FieldSpec

    # wide-row mode: when set, commit, encode, decode and verify go through
    # the mesh (parallel/wide.py, parallel/cross_chip_ntt.py)
    mesh = None

    def with_mesh(self, mesh) -> "LcEncoding":
        """A copy of this encoding in wide-row mode: its encoded-column axis
        is sharded over `mesh`.  The receiver is untouched, so one wide
        commit does not turn every later use of the encoding wide, and the
        copy's per-encoding caches start empty (:meth:`_reset_caches`)."""
        new = copy.copy(self)
        new.mesh = mesh
        new._reset_caches()
        return new

    def _reset_caches(self) -> None:
        """Give a copy made by :meth:`with_mesh` caches of its own."""

    def encode_wide(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """Encode over the mesh: `blocks` are the D column blocks, each on its
        mesh device, of (batch, w, L) rows with the coefficients in the first
        n_per_row columns and zeros after, w = n_cols rounded up to a multiple
        of D -> the D column blocks of the codewords, zero-padded to width w
        the same way.  Only codes with a cross-device formulation have it."""
        raise NotImplementedError(f"{type(self).__name__} has no wide encode")

    @abc.abstractmethod
    def encode(self, rows: torch.Tensor) -> torch.Tensor:
        """Encode coefficient rows: (batch, width, L) with n_per_row <= width
        <= n_cols (a verifier widens an over-long proof row) -> (batch, n_cols,
        L) codewords, on the rows' device (through the mesh, where the
        encoding has one).  Each code decides how it reads the coefficients
        past n_per_row."""

    def encode_stored(self, rows: torch.Tensor,
                      out16: torch.Tensor | None = None) -> torch.Tensor:
        """:meth:`encode` of coefficient rows as a commitment stores them (int32
        limbs, or 16-bit limbs as int16) -> the (batch, n_cols, L) int32
        codewords; given ``out16``, a (batch, n_cols, L) int16 tensor, they are
        also written there as 16-bit limbs (the streamed commit's kept
        matrix).  A code whose kernel reads and writes 16-bit limbs itself
        overrides this."""
        comm = self.encode(widen_limbs(rows))
        if out16 is not None:
            out16.copy_(narrow_limbs(comm))
        return comm

    @abc.abstractmethod
    def get_dims(self, length: int) -> tuple[int, int, int]:
        """(n_rows, n_per_row, n_cols) for a coefficient vector length."""

    @abc.abstractmethod
    def dims_ok(self, n_per_row: int, n_cols: int) -> bool: ...

    @abc.abstractmethod
    def get_n_col_opens(self) -> int: ...

    @abc.abstractmethod
    def get_n_degree_tests(self) -> int: ...
