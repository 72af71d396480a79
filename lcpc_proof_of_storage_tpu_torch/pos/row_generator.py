"""Streaming encoded-row generator.

Counterpart of ``lcpc_proof_of_storage_tpu/pos/row_generator.py``
(reference: proof-of-storage/src/lcpc_online/row_generator_iter.rs).  Wraps
a field-element iterator into encoded rows, with one-pass streaming column
digests / commitment root / full column openings: the "iterator pipeline ==
in-RAM commit" oracle family (row_generator_iter.rs:188-364).  Rows are
encoded in device batches (K1 on CUDA) and yielded one by one as int32
tensors on that device; the digest accumulator keeps them there until a
chunk boundary.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import torch

from ..core.commit import LcColumn, default_device
from ..fields.field import FieldSpec, limbs_to_ints
from ..fields.limb import limb_field
from ..ops.ntt import encode_rows
from .storage import ColumnDigestAccumulator, ntt_tables


class RowGenerator:
    """Iterates encoded rows from a stream of field element values."""

    BATCH = 128

    def __init__(self, values: Iterable[int], n_per_row: int, n_cols: int,
                 spec: FieldSpec, device=None):
        self.values = iter(values)
        self.n_per_row = n_per_row
        self.n_cols = n_cols
        self.spec = spec
        self.device = default_device(device)

    def __iter__(self) -> Iterator[torch.Tensor]:
        """Yields (n_cols, L) int32 encoded rows, zero-padding the final row."""
        L = self.spec.num_limbs16
        lf = limb_field(self.spec)
        tables = ntt_tables(self.spec, self.n_cols, self.device)
        done = False
        while not done:
            buf: list[int] = []
            target = self.n_per_row * self.BATCH
            while len(buf) < target:
                try:
                    buf.append(next(self.values))
                except StopIteration:
                    done = True
                    break
            if not buf:
                return
            rows = -(-len(buf) // self.n_per_row)
            mat = torch.zeros((rows * self.n_per_row, L), dtype=torch.int32, device=self.device)
            mat[: len(buf)] = lf.array(buf, self.device)
            yield from encode_rows(mat.view(rows, self.n_per_row, L), self.spec, self.n_cols,
                                   tables)

    # -- one-pass consumers (row_generator_iter.rs API) ---------------------
    def get_column_digests(self) -> list[bytes]:
        acc = ColumnDigestAccumulator(self.n_cols, self.spec, device=self.device)
        for row in self:
            acc.update(row)
        return acc.get_column_digests()

    def get_specified_column_digests(self, columns: list[int]) -> list[bytes]:
        acc = ColumnDigestAccumulator(self.n_cols, self.spec, columns=columns,
                                      device=self.device)
        for row in self:
            acc.update(row)
        return acc.get_column_digests()

    def convert_to_commit_root(self) -> bytes:
        acc = ColumnDigestAccumulator(self.n_cols, self.spec, device=self.device)
        for row in self:
            acc.update(row)
        return acc.finalize_to_merkle_tree().root()

    def get_full_columns(self, columns: list[int]) -> list[LcColumn]:
        acc = ColumnDigestAccumulator(self.n_cols, self.spec, device=self.device)
        idx = torch.tensor(list(columns), dtype=torch.int64, device=self.device)
        parts = []
        for row in self:
            acc.update(row)
            parts.append(row[idx])
        tree = acc.finalize_to_merkle_tree()
        cols = torch.stack(parts, dim=1).cpu().numpy()        # (k, n_rows, L)
        return [LcColumn(col=limbs_to_ints(cols[k]), path=tree.get_path(c))
                for k, c in enumerate(columns)]
