"""Ligero (Reed-Solomon) encoding for the 2d polynomial commitment.

Counterpart of ``lcpc_proof_of_storage_tpu/codes/ligero.py``: the same
dimension solver and soundness formulas (lcpc-ligero-pc/src/lib.rs).  The
row transform is the encoding's ``ntt`` route, one of ``ops.ntt.ROUTES``:

  * ``"stages"`` (default): encode by :func:`ops.ntt.ntt` (kernel K1 on
    CUDA), 16-bit rows by :func:`ops.ntt.ntt_rows` (K1 reading them as
    stored), decode by :func:`ops.ntt.intt` (K4's inverse entry);
  * ``"four_step"``: encode by :func:`ops.ntt.ntt_four_step` (the JAX
    package's ``LCPC_NTT_FOURSTEP=1``), decode by :func:`ops.ntt.intt`, as
    the reference's four-step is forward only;
  * ``"fused_small"``: encode and decode by :func:`ops.ntt.ntt_fused_small`
    (the reference's ``LCPC_NTT_KERNEL=v1``).

Every route gives the same codewords, so roots and proofs do not depend on
it.  The route is a field of the encoding, as the reference's mesh is: no
environment variable chooses it.

Under a mesh (``with_mesh``), encode and decode run the cross-device
four-step NTT of ``parallel/cross_chip_ntt.py`` instead, forward and
inverse: its local transforms are :func:`ops.ntt.ntt` and
:func:`ops.ntt.intt` (K1 and K4's inverse on CUDA) and its twiddle product
is KM, whatever the encoding's ``ntt`` route.

  * n_col_opens = ceil(-lambda / log2((1+rho)/2))          (lib.rs:61-64)
  * n_degree_tests via lcpc-2d's formula                    (lib.rs:66-68)
  * _get_dims proof-size-optimizing solver                  (lib.rs:70-112)
  * dims_ok: n_per_row < n_cols and n_cols a power of two   (lib.rs:114-118)
"""

from __future__ import annotations

import copy
import math
from fractions import Fraction

import torch

from ..core.encoding import LcEncoding, n_degree_tests, next_power_of_two
from ..fields.field import FieldSpec
from ..fields.limb import narrow_limbs, widen_limbs
from ..ops.ntt import ROUTES, NttTables, intt, ntt, ntt_four_step, ntt_fused_small, ntt_rows
from ..parallel.cross_chip_ntt import cross_chip_ntt
from ..parallel.mesh import gather, scatter

LAMBDA = 128


class LigeroEncoding(LcEncoding):
    """Reed-Solomon row code at rate rho = rho_num/rho_den (default 1/2).

    The encoding owns the NTT tables of its row length, an ``nn.Module``
    built on the CPU and copied once to each other device it encodes on
    (:meth:`tables`).  :meth:`encode` runs on the device of its input, so
    one encoding serves callers on several devices and no call moves it.
    ``ntt`` names the row transform's route (module docstring)."""

    def __init__(self, spec: FieldSpec, n_per_row: int, n_cols: int,
                 rho: tuple[int, int] = (1, 2), ntt: str = "stages"):
        if not self._dims_ok(n_per_row, n_cols):
            raise ValueError(f"bad Ligero dims ({n_per_row}, {n_cols})")
        if n_cols > (1 << spec.two_adicity):
            raise ValueError("no NTT subgroup of this size")
        if ntt not in ROUTES:
            raise ValueError(f"ntt must be one of {ROUTES}, got {ntt!r}")
        self.spec = spec
        self.rho_num, self.rho_den = rho
        self.n_per_row = n_per_row
        self.n_cols = n_cols
        self.ntt = ntt
        self.ntt_tables = NttTables(spec, n_cols, ntt)
        self._reset_caches()

    def _reset_caches(self) -> None:
        self._tables_on = {self.ntt_tables.device: self.ntt_tables}

    # -- constructors --------------------------------------------------------
    @classmethod
    def new(cls, length: int, spec: FieldSpec, rho: tuple[int, int] = (1, 2),
            ntt: str = "stages"):
        dims = cls._get_dims(length, spec, rho)
        if dims is None:
            raise ValueError("no valid dims")
        _, n_per_row, n_cols = dims
        return cls(spec, n_per_row, n_cols, rho, ntt)

    @classmethod
    def new_ml(cls, n_vars: int, spec: FieldSpec, rho: tuple[int, int] = (1, 2),
               ntt: str = "stages"):
        n_monomials = 1 << n_vars
        dims = cls._get_dims(n_monomials, spec, rho)
        if dims is None:
            raise ValueError("no valid dims")
        n_rows, n_per_row, n_cols = dims
        if (n_rows & (n_rows - 1) or n_per_row & (n_per_row - 1)
                or n_rows * n_per_row != n_monomials):
            raise ValueError("multilinear dims must be powers of two")
        return cls(spec, n_per_row, n_cols, rho, ntt)

    @classmethod
    def new_from_dims(cls, n_per_row: int, n_cols: int, spec: FieldSpec,
                      rho: tuple[int, int] = (1, 2), ntt: str = "stages"):
        return cls(spec, n_per_row, n_cols, rho, ntt)

    # -- soundness math ------------------------------------------------------
    @classmethod
    def _n_col_opens(cls, rho: tuple[int, int]) -> int:
        r = rho[0] / rho[1]
        return math.ceil(-LAMBDA / math.log2((1.0 + r) / 2.0))

    @classmethod
    def _n_degree_tests(cls, n_cols: int, spec: FieldSpec) -> int:
        return n_degree_tests(LAMBDA, n_cols, spec.num_bits - 1)

    @classmethod
    def _get_dims(cls, length: int, spec: FieldSpec,
                  rho: tuple[int, int]) -> tuple[int, int, int] | None:
        """Proof-size-optimizing dims solver (lcpc-ligero-pc lib.rs:70-112)."""
        n_col_opens = cls._n_col_opens(rho)
        r = rho[0] / rho[1]
        lncf = float(n_col_opens * length)
        ndt = float(cls._n_degree_tests(math.ceil(math.sqrt(lncf) / r), spec))
        nc1 = next_power_of_two(math.ceil(math.sqrt(lncf / ndt) / r))
        if nc1 > (1 << spec.two_adicity):
            return None

        np1 = nc1 * rho[0] // rho[1]
        nr1 = (length + np1 - 1) // np1
        nd1 = cls._n_degree_tests(nc1, spec)

        nc2 = nc1 // 2
        np2 = np1 // 2
        if np2 == 0:
            return (nr1, np1, nc1)
        nr2 = (length + np2 - 1) // np2
        nd2 = cls._n_degree_tests(nc2, spec)

        sz1 = n_col_opens * nr1 + (1 + nd1) * np1
        sz2 = n_col_opens * nr2 + (1 + nd2) * np2
        return (nr1, np1, nc1) if sz1 < sz2 else (nr2, np2, nc2)

    @staticmethod
    def _dims_ok(n_per_row: int, n_cols: int) -> bool:
        return 0 < n_per_row < n_cols and n_cols & (n_cols - 1) == 0

    # -- LcEncoding ----------------------------------------------------------
    def tables(self, device: torch.device) -> NttTables:
        """The NTT tables on `device` (an indexed device, as a tensor's)."""
        if device not in self._tables_on:
            self._tables_on[device] = copy.deepcopy(self.ntt_tables).to(device)
        return self._tables_on[device]

    def encode(self, rows: torch.Tensor, out16: torch.Tensor | None = None) -> torch.Tensor:
        """NTT of (batch, width, L) coefficient rows zero-padded to n_cols, on
        the rows' device (under a mesh: sharded, :meth:`encode_wide`, and
        gathered back).  Every one of the `width` coefficients enters the
        codeword, so an over-long proof row fails the degree check.  Rows of
        16-bit limbs stored as int16 go to K1 as they are on the ``stages``
        route with no mesh (:func:`ops.ntt.ntt_rows`: no widened copy, no
        pad), and are widened first elsewhere.  Given ``out16``, a (batch,
        n_cols, L) int16 tensor, the codewords are also written there as
        16-bit limbs (by K1 itself on that route)."""
        batch, width, L = rows.shape
        if width > self.n_cols:
            raise ValueError(f"encode: rows of {width} coefficients, code has {self.n_cols}")
        if rows.dtype == torch.int16:
            if self.mesh is None and self.ntt == "stages":
                return ntt_rows(rows, self.spec, self.n_cols, tables=self.tables(rows.device),
                                out16=out16)
            rows = widen_limbs(rows)
        if self.mesh is not None:
            out = gather(self.encode_wide(scatter(rows, self.mesh, 1, self.n_cols)),
                         rows.device, 1)
        else:
            padded = rows.new_zeros((batch, self.n_cols, L))
            padded[:, :width] = rows
            route = {"four_step": ntt_four_step, "fused_small": ntt_fused_small}.get(self.ntt, ntt)
            out = route(padded, self.spec, width, self.tables(rows.device))
        if out16 is not None:
            out16.copy_(narrow_limbs(out))
        return out

    def encode_stored(self, rows: torch.Tensor,
                      out16: torch.Tensor | None = None) -> torch.Tensor:
        """``LcEncoding.encode_stored`` is :meth:`encode` here, which takes
        16-bit rows as stored and writes out16 itself."""
        return self.encode(rows, out16)

    def encode_wide(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """The cross-device NTT of the column blocks (``LcEncoding``)."""
        return cross_chip_ntt(blocks, self.spec, self.mesh)

    def decode(self, rows: torch.Tensor) -> torch.Tensor:
        """Inverse NTT of (batch, n_cols, L) codewords on the rows' device:
        all n_cols coefficients (the PoS read path truncates them).  Under a
        mesh, the cross-device inverse."""
        if self.mesh is not None:
            return gather(cross_chip_ntt(scatter(rows, self.mesh, 1), self.spec, self.mesh,
                                         inverse=True), rows.device, 1)
        if self.ntt == "fused_small":
            return ntt_fused_small(rows, self.spec, tables=self.tables(rows.device),
                                   inverse=True)
        return intt(rows, self.spec, self.tables(rows.device))

    def get_dims(self, length: int) -> tuple[int, int, int]:
        n_rows = (length + self.n_per_row - 1) // self.n_per_row
        return (n_rows, self.n_per_row, self.n_cols)

    def dims_ok(self, n_per_row: int, n_cols: int) -> bool:
        return (self._dims_ok(n_per_row, n_cols)
                and n_per_row == self.n_per_row and n_cols == self.n_cols)

    def get_n_col_opens(self) -> int:
        return self._n_col_opens((self.rho_num, self.rho_den))

    def get_n_degree_tests(self) -> int:
        return self._n_degree_tests(self.n_cols, self.spec)

    @property
    def rho(self) -> Fraction:
        return Fraction(self.rho_num, self.rho_den)

    def __repr__(self):
        return (f"LigeroEncoding({self.spec.name}, n_per_row={self.n_per_row}, "
                f"n_cols={self.n_cols}, rho={self.rho_num}/{self.rho_den}, ntt={self.ntt})")
