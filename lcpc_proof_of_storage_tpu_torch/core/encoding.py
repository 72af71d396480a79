"""Linear-code encoding interface (reference: LcEncoding trait,
lcpc-2d/src/lib.rs:75-105), declared again for the PyTorch port.

Counterpart of ``lcpc_proof_of_storage_tpu/core/encoding.py`` without the
mesh hooks.  The domain-separation labels keep the reference's def_labels!
quirk (lcpc-2d/src/macros.rs:29-36): every encoding shares b"$l//DT" etc.
"""

from __future__ import annotations

import abc

import torch

from ..fields.field import FieldSpec

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

    @abc.abstractmethod
    def encode(self, rows: torch.Tensor) -> torch.Tensor:
        """Encode coefficient rows: (batch, width, L) with n_per_row <= width
        <= n_cols (a verifier widens an over-long proof row) -> (batch, n_cols,
        L) codewords, on the rows' device.  Each code decides how it reads
        the coefficients past n_per_row."""

    @abc.abstractmethod
    def get_dims(self, length: int) -> tuple[int, int, int]:
        """(n_rows, n_per_row, n_cols) for a coefficient vector length."""

    @abc.abstractmethod
    def dims_ok(self, n_per_row: int, n_cols: int) -> bool: ...

    @abc.abstractmethod
    def get_n_col_opens(self) -> int: ...

    @abc.abstractmethod
    def get_n_degree_tests(self) -> int: ...
