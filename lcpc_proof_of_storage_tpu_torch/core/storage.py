"""Where a commitment keeps its limb matrices, and the work done over them.

A commitment holds its coefficients, (n_rows, n_per_row, L) limbs, and its
encoded matrix, (n_rows, n_cols, L).  The one-shot commit keeps both on the
device as int32 limbs.  A streamed commitment (core/streamed.py) keeps
16-bit limbs: on the device as int16 bit patterns, or in host memory as a
uint16 array that moves one row batch at a time through pinned staging; it
may keep no encoded matrix at all.  A commitment made over a mesh
(``parallel/``) keeps a matrix column-sharded: one tensor a mesh position,
each holding a block of neighbouring columns of all rows on its device.
This module is the one place that knows those forms: :func:`as_rows` wraps
a tensor in :class:`DeviceRows`, a host array in :class:`HostRows` and a
list of column blocks in :class:`ShardedRows`; they serve row batches,
column gathers, the collapse and the re-encode of opened columns.

The batched collapse and re-encode are the reference's
``collapse_streamed`` and ``open_columns_streamed``
(``lcpc_proof_of_storage_tpu/core/streamed.py:350-423``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.field import FieldSpec
from ..fields.limb import limb_field, narrow_limbs, widen_limbs
from ..ops.collapse import collapse
from .encoding import LcEncoding

BATCH_BYTES = 1 << 30     # one batch: 16-bit coefficients to collapse, int32 rows re-encoded


def even_row_batches(n_rows: int, bytes_per_row: int,
                     target_batch_rows: int | None) -> list[tuple[int, int]]:
    """Plain even splits (nothing is hashed, so no chunk alignment), of about
    BATCH_BYTES unless target_batch_rows is given."""
    if target_batch_rows is None:
        target_batch_rows = max(1, BATCH_BYTES // max(bytes_per_row, 1))
    step = max(1, min(n_rows, target_batch_rows))
    return [(s, min(s + step, n_rows)) for s in range(0, n_rows, step)]


# --------------------------------------------------------------------------
# coefficient input -> matrix
# --------------------------------------------------------------------------

def _limb_tensor(coeffs, spec: FieldSpec) -> torch.Tensor:
    """Python ints, or an (n, L) limb array or tensor -> (n, L) limbs: int32,
    or int16 where the input holds 16-bit limbs (uint16 or int16)."""
    lf = limb_field(spec)
    if isinstance(coeffs, (list, tuple)):
        arr = lf.array(coeffs)
    elif isinstance(coeffs, np.ndarray):
        if coeffs.dtype in (np.uint16, np.int16):
            arr = torch.from_numpy(np.ascontiguousarray(coeffs).view(np.int16))
        else:
            arr = torch.from_numpy(coeffs.astype(np.int32))
    elif coeffs.dtype in (torch.uint16, torch.int16):
        arr = coeffs.view(torch.int16)
    else:
        arr = coeffs.to(torch.int32)
    if arr.dim() != 2 or arr.shape[1] != lf.L:
        raise ValueError(f"coefficients must be (n, {lf.L}) limbs, got {tuple(arr.shape)}")
    return arr


def _dims(enc: LcEncoding, length: int) -> tuple[int, int, int]:
    n_rows, n_per_row, n_cols = enc.get_dims(length)
    if not enc.dims_ok(n_per_row, n_cols):
        raise ValueError("encoding rejects its own dims")
    return n_rows, n_per_row, n_cols


def limb_matrix(coeffs, enc: LcEncoding, device: torch.device, keep16: bool = False):
    """Pad a coefficient vector (python ints, or an (n, L) limb array or
    tensor) to the (n_rows, n_per_row, L) matrix on `device`: int32, or int16
    16-bit limbs where the input holds 16-bit limbs and `keep16` asks for it.
    Returns (matrix, dims)."""
    arr = _limb_tensor(coeffs, enc.spec).to(device)
    if not keep16:
        arr = widen_limbs(arr)
    n_rows, n_per_row, n_cols = dims = _dims(enc, arr.shape[0])
    pad = n_rows * n_per_row - arr.shape[0]
    if pad:
        arr = torch.cat([arr, arr.new_zeros((pad, arr.shape[1]))])
    return arr.reshape(n_rows, n_per_row, -1), dims


def host_limb_matrix(coeffs, enc: LcEncoding):
    """The same matrix in host memory as uint16 (no copy where the input is a
    C-contiguous uint16 array that needs no padding).  Returns (matrix,
    dims)."""
    arr = _limb_tensor(coeffs, enc.spec)
    if arr.dtype != torch.int16:
        arr = narrow_limbs(arr)
    arr = arr.cpu().numpy().view(np.uint16)
    n_rows, n_per_row, n_cols = dims = _dims(enc, arr.shape[0])
    pad = n_rows * n_per_row - arr.shape[0]
    if pad:
        arr = np.concatenate([arr, np.zeros((pad, arr.shape[1]), np.uint16)])
    return arr.reshape(n_rows, n_per_row, -1), dims


# --------------------------------------------------------------------------
# row stores
# --------------------------------------------------------------------------

class _Rows:
    """What the stores share: the shape and the batched re-encode of opened
    columns.  The stores on devices gather columns in two steps, ``take``
    (on the devices) and ``readback`` (to the host), which prove times
    apart."""

    data: torch.Tensor | np.ndarray
    device: torch.device

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return (self.device,)

    def gather(self, cols: list[int]) -> np.ndarray:
        """(n_rows, k, L) uint32 limbs of the given columns."""
        return self.readback(self.take(cols))

    def rows(self, r0: int, r1: int) -> torch.Tensor:
        raise NotImplementedError

    def open_columns(self, enc: LcEncoding, n_cols: int, cols: list[int],
                     target_batch_rows: int | None = None) -> np.ndarray:
        """(n_rows, k, L) uint32 limbs of columns `cols` of the encoded matrix
        of these coefficients, re-encoded in row batches of about
        BATCH_BYTES of int32 encoded rows: each batch is encoded as the commit
        encoded it and only its k opened columns are kept, on the device,
        until one copy to the host at the end."""
        n_rows, _, L = self.shape
        idx = torch.tensor(cols, dtype=torch.int64, device=self.device)
        out = torch.empty((n_rows, len(cols), L), dtype=torch.int32, device=self.device)
        for r0, r1 in even_row_batches(n_rows, n_cols * L * 4, target_batch_rows):
            out[r0:r1] = enc.encode(widen_limbs(self.rows(r0, r1)))[:, idx]
        return out.cpu().numpy().astype(np.uint32)


class DeviceRows(_Rows):
    """A limb matrix on a device: int32 limbs, or 16-bit limbs as int16."""

    def __init__(self, data: torch.Tensor):
        self.data = data
        self.device = data.device

    def rows(self, r0: int, r1: int) -> torch.Tensor:
        return self.data[r0:r1]

    def take(self, cols: list[int]) -> torch.Tensor:
        """(n_rows, k, L) int32 limbs of the given columns, on the device."""
        cidx = torch.tensor(cols, dtype=torch.int64, device=self.device)
        return widen_limbs(self.data[:, cidx])

    @staticmethod
    def readback(taken: torch.Tensor) -> np.ndarray:
        return taken.cpu().numpy().astype(np.uint32)

    def collapse(self, t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
        """One K3 call over the whole matrix, with no batching."""
        return collapse(self.data, t, spec)


class HostRows(_Rows):
    """A limb matrix in host memory, 16-bit limbs as uint16, served to
    `device` one row batch at a time.  Batches move through two pinned
    staging buffers on the current stream, so that the host's copy into or
    out of one overlaps the device's work on the other.  The buffers are
    allocated at the first batch, grown for a larger one and kept for the
    store's life, so a prove reuses the commit's.  On the CPU the host rows
    are used as they are."""

    def __init__(self, data: np.ndarray, device):
        self.data = data
        self.device = torch.device(device)
        self._bufs: list[torch.Tensor] = []
        self._pending = [None, None]    # per buffer: its copy's event (+ download target)
        self._turn = 0

    def staging_bytes(self) -> int:
        return sum(b.numel() * 2 for b in self._bufs)

    def _buffer(self, shape) -> tuple[int, torch.Tensor]:
        n = int(np.prod(shape))
        if not self._bufs or self._bufs[0].numel() < n:
            self.flush()
            self._bufs = []                 # the old pair goes before the new one comes
            self._bufs = [torch.empty(n, dtype=torch.int16, pin_memory=True) for _ in range(2)]
        i = self._turn
        self._turn ^= 1
        self._settle(i)
        return i, self._bufs[i][:n].view(shape)

    def _settle(self, i: int) -> None:
        """Wait for buffer i's last copy; land a download in host memory."""
        done = self._pending[i]
        self._pending[i] = None
        if done is not None:
            done[0].synchronize()
            if len(done) > 1:
                staged, r0, r1 = done[1:]
                torch.from_numpy(self.data[r0:r1].view(np.int16)).copy_(staged)

    def _record(self, i: int, *download) -> None:
        with torch.cuda.device(self.device):
            event = torch.cuda.Event()
            event.record()
        self._pending[i] = (event, *download)

    def rows(self, r0: int, r1: int) -> torch.Tensor:
        """Host rows r0..r1-1 on the device, int16."""
        src = torch.from_numpy(self.data[r0:r1].view(np.int16))
        if self.device.type != "cuda":
            return src
        i, staged = self._buffer(src.shape)
        staged.copy_(src)
        out = torch.empty(src.shape, dtype=torch.int16, device=self.device)
        out.copy_(staged, non_blocking=True)
        self._record(i)
        return out

    def put(self, r0: int, r1: int, rows16: torch.Tensor) -> None:
        """Device rows (int16) into host rows r0..r1-1, landed by flush()."""
        if self.device.type != "cuda":
            self.data[r0:r1] = rows16.numpy().view(np.uint16)
            return
        i, staged = self._buffer(rows16.shape)
        staged.copy_(rows16, non_blocking=True)
        self._record(i, staged, r0, r1)

    def flush(self) -> None:
        for i in (self._turn, self._turn ^ 1):       # the older copy first
            self._settle(i)

    def gather(self, cols: list[int]) -> np.ndarray:
        """(n_rows, k, L) uint32 limbs of the given columns."""
        return self.data[:, np.asarray(cols, np.int64)].astype(np.uint32)

    def collapse(self, t: torch.Tensor, spec: FieldSpec,
                 target_batch_rows: int | None = None) -> torch.Tensor:
        """(T, n_per_row, L) int32 collapse of the (T, n_rows, L) tensors `t`
        against these coefficients, in one pass over row batches of about
        BATCH_BYTES of 16-bit coefficients: K3p adds each batch's collapse
        into the accumulator mod p."""
        n_rows, npr, L = self.shape
        acc = torch.zeros((t.shape[0], npr, L), dtype=torch.int32, device=t.device)
        for r0, r1 in even_row_batches(n_rows, npr * L * 2, target_batch_rows):
            acc = collapse(self.rows(r0, r1), t[:, r0:r1].contiguous(), spec, acc=acc)
        return acc


class ShardedRows(_Rows):
    """A limb matrix kept column-sharded over a mesh: ``data`` is the list of
    its column blocks, (n_rows, width_k, L) int32 tensors in column order,
    each on its own device (a device may hold several).  Each column is read
    from the block that holds it, and the collapse runs block by block."""

    def __init__(self, blocks: list[torch.Tensor]):
        if not blocks or len({(b.shape[0], b.shape[2]) for b in blocks}) != 1:
            raise ValueError("column blocks must share their row count and limb width")
        self.data = list(blocks)
        self.device = blocks[0].device
        self.starts = np.cumsum([0] + [b.shape[1] for b in blocks])

    @property
    def shape(self) -> tuple[int, ...]:
        n_rows, _, L = self.data[0].shape
        return (n_rows, int(self.starts[-1]), L)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(dict.fromkeys(b.device for b in self.data))

    def take(self, cols: list[int]) -> list[tuple[np.ndarray, torch.Tensor]]:
        """The given columns, each read from its block on its device: per
        block holding some, (their positions in `cols`, their (n_rows, k_b,
        L) limbs)."""
        cols = np.asarray(cols, np.int64)
        width = self.shape[1]
        if cols.size and not (0 <= cols.min() and cols.max() < width):
            raise IndexError(f"column outside [0, {width})")
        which = np.searchsorted(self.starts, cols, side="right") - 1
        taken = []
        for k in np.unique(which):
            sel = np.flatnonzero(which == k)
            block = self.data[k]
            idx = torch.from_numpy(cols[sel] - self.starts[k]).to(block.device)
            taken.append((sel, block[:, idx]))
        return taken

    def readback(self, taken: list[tuple[np.ndarray, torch.Tensor]]) -> np.ndarray:
        """(n_rows, k, L) uint32 limbs of what :meth:`take` returned."""
        n_rows, _, L = self.shape
        out = np.empty((n_rows, sum(len(sel) for sel, _ in taken), L), np.uint32)
        for sel, part in taken:
            out[:, sel] = part.cpu().numpy()
        return out

    def collapse(self, t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
        """(T, n_per_row, L) int32 collapse of the tensors `t` against these
        column-sharded coefficients, on t's device: K3 a block, on its
        device, the outputs concatenated."""
        return torch.cat([collapse(b, t.to(b.device), spec).to(t.device) for b in self.data],
                         dim=1)


def as_rows(x, device) -> DeviceRows | HostRows | ShardedRows | None:
    """A store for a matrix kept as a tensor (on its device), as a host
    uint16 array (served to `device`) or as a list of column blocks (on
    their devices); None and stores pass through."""
    if x is None or isinstance(x, _Rows):
        return x
    if isinstance(x, np.ndarray):
        return HostRows(x, device)
    if isinstance(x, (list, tuple)):
        return ShardedRows(x)
    return DeviceRows(x)
