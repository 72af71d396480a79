"""Brakedown (SDIG expander) encoding for the 2d polynomial commitment.

Counterpart of ``lcpc_proof_of_storage_tpu/codes/brakedown.py``
(lcpc-brakedown-pc/src/lib.rs): the same dims solver and soundness formulas,
with the row encode going through :class:`~..ops.expander.ExpanderEncoder`
(kernel K5 on CUDA); under a mesh (``with_mesh``) through its
``encode_wide``, every level sharded by output rows.

  * n_col_opens = ceil(-lambda / log2(1 - dist/3))          (lib.rs:57-61)
  * n_degree_tests via lcpc-2d                              (lib.rs:64-66)
  * np1-vs-np1/2 proof-size optimization in _new_from_np1   (lib.rs:69-99)
"""

from __future__ import annotations

import math

import torch

from ..core.encoding import LcEncoding, n_degree_tests, next_power_of_two
from ..fields.field import FieldSpec
from ..ops.expander import SDIG_CODE_3, ExpanderEncoder, SdigSpec
from ..parallel.mesh import gather, scatter

LAMBDA = 128


class BrakedownEncoding(LcEncoding):
    def __init__(self, encoder: ExpanderEncoder):
        self.encoder = encoder
        self.spec = encoder.field
        self.code_spec = encoder.spec
        self.n_per_row = encoder.n_per_row
        self.n_cols = encoder.codeword_len

    # -- constructors --------------------------------------------------------
    @classmethod
    def new(cls, length: int, seed: int, field: FieldSpec, code: SdigSpec = SDIG_CODE_3):
        lncf = float(cls._n_col_opens(code) * length)
        ndt = float(cls._n_degree_tests_for(math.ceil(math.sqrt(lncf)) * 2, field))
        np1 = math.ceil(math.sqrt(lncf / ndt))
        return cls._new_from_np1(length, np1, seed, field, code)

    @classmethod
    def new_ml(cls, n_vars: int, seed: int, field: FieldSpec, code: SdigSpec = SDIG_CODE_3):
        n_monomials = 1 << n_vars
        lncf = float(cls._n_col_opens(code) * n_monomials)
        ndt = float(cls._n_degree_tests_for(math.ceil(math.sqrt(lncf)) * 2, field))
        np1 = next_power_of_two(math.ceil(math.sqrt(lncf / ndt)))
        return cls._new_from_np1(n_monomials, np1, seed, field, code)

    @classmethod
    def new_from_dims(cls, n_per_row: int, n_cols: int, seed: int, field: FieldSpec,
                      code: SdigSpec = SDIG_CODE_3):
        enc = ExpanderEncoder.build(n_per_row, seed, field, code)
        if (enc.n_per_row, enc.codeword_len) != (n_per_row, n_cols):
            raise ValueError(f"code of {n_per_row} gives {enc.codeword_len} columns, not {n_cols}")
        return cls(enc)

    @classmethod
    def _new_from_np1(cls, length: int, np1: int, seed: int, field: FieldSpec,
                      code: SdigSpec):
        """lib.rs:69-99: n_per_row = np1, or np1/2 where that proof is smaller."""
        np1 = min(np1, length)
        n_col_opens = cls._n_col_opens(code)
        nr1 = (length + np1 - 1) // np1
        nd1 = cls._n_degree_tests_for(np1 * 2, field)
        np2 = np1 // 2
        nr2 = (length + np2 - 1) // np2
        nd2 = cls._n_degree_tests_for(np2 * 2, field)
        sz1 = n_col_opens * nr1 + (1 + nd1) * np1
        sz2 = n_col_opens * nr2 + (1 + nd2) * np2
        n_per_row = np1 if sz1 < sz2 else np2
        return cls(ExpanderEncoder.build(n_per_row, seed, field, code))

    # -- soundness -----------------------------------------------------------
    @staticmethod
    def _n_col_opens(code: SdigSpec) -> int:
        den = math.log2(1.0 - code.dist() / 3.0)
        return math.ceil(-LAMBDA / den)

    @staticmethod
    def _n_degree_tests_for(n_cols: int, field: FieldSpec) -> int:
        return n_degree_tests(LAMBDA, n_cols, field.num_bits - 1)

    # -- LcEncoding ----------------------------------------------------------
    def encode(self, rows: torch.Tensor) -> torch.Tensor:
        """(batch, width, L) coefficient rows -> codewords, on the rows'
        device.  As in the reference (codes/brakedown.py encode), only the
        first n_per_row coefficients of each row enter the codeword: a
        verifier's over-long row loses its extra coefficients here.  Rows of
        exactly n_per_row are encoded without a copy.  Under a mesh the rows
        are sharded, go through :meth:`encode_wide` and are gathered back."""
        if not self.n_per_row <= rows.shape[-2] <= self.n_cols:
            raise ValueError(f"encode: rows of {rows.shape[-2]} coefficients, code has "
                             f"{self.n_per_row} per row")
        if self.mesh is not None:
            width = -(-self.n_cols // self.mesh.size) * self.mesh.size
            blocks = scatter(rows[:, : self.n_per_row], self.mesh, 1, width)
            out = gather(self.encode_wide(blocks), rows.device, 1)
            return out[:, : self.n_cols].contiguous()
        return self.encoder.encode(rows[:, : self.n_per_row].contiguous())

    def encode_wide(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """The expander encode over the mesh (``ExpanderEncoder.encode_wide``):
        the output is n_cols rounded up to a multiple of the mesh size, the
        zero columns last; ``parallel/wide.py`` slices their digests off
        before the Merkle tree.  The reference's graph encode
        (lcpc-brakedown-pc/src/encode.rs:36-110) runs on one host."""
        return self.encoder.encode_wide(blocks, self.mesh)

    def get_dims(self, length: int) -> tuple[int, int, int]:
        n_rows = (length + self.n_per_row - 1) // self.n_per_row
        return (n_rows, self.n_per_row, self.n_cols)

    def dims_ok(self, n_per_row: int, n_cols: int) -> bool:
        return n_per_row < n_cols and n_per_row == self.n_per_row and n_cols == self.n_cols

    def get_n_col_opens(self) -> int:
        return self._n_col_opens(self.code_spec)

    def get_n_degree_tests(self) -> int:
        return self._n_degree_tests_for(self.n_cols, self.spec)

    def __repr__(self):
        return (f"BrakedownEncoding({self.spec.name}, n_per_row={self.n_per_row}, "
                f"n_cols={self.n_cols})")
