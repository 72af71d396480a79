"""Blake3 column leaves, the Merkle tree and streamed chunk CVs over limb
tensors.

Counterparts of ``lcpc_proof_of_storage_tpu/ops/blake3_jax.py`` (the plain
versions here) and ``ops/blake3_pallas.py`` (kernel K2, ``csrc/blake3.cu``,
whose other entry points build the Merkle tree, the chunk chaining values
of one row batch of a streamed commit, and the leaves merged from them).
``hash_columns_chunked_plain`` and ``merkle_tree_tiles_plain`` follow the
leaves and tree kernels step by step (``leaf_plan``, ``tree_plan``, the
mirrors of ``csrc/blake3.cuh``) for the tests.

Digests are (n, 8) ``torch.int32`` tensors carrying the bit pattern of the
reference's uint32 words.  The plain versions compute the 32-bit adds and
rotates in int64, masked to 32 bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..crypto import blake3_ref as b3
from ..fields.field import FieldSpec

I64 = torch.int64
MASK32 = 0xFFFFFFFF
IV = tuple(b3.IV)
CHUNK_START = b3.CHUNK_START
CHUNK_END = b3.CHUNK_END
PARENT = b3.PARENT
ROOT = b3.ROOT
LEAF_THREADS = 256     # threads of a leaves block, at most (csrc/blake3.cuh kLeafThreads)
TREE_LEVELS = 10       # Merkle layers one tree launch builds (kTreeLevels)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _round_schedules() -> np.ndarray:
    """(7, 16) message word indices after r applications of the permutation."""
    idx = np.arange(16)
    out = []
    for _ in range(7):
        out.append(idx.copy())
        idx = idx[np.array(b3.MSG_PERMUTATION)]
    return np.stack(out)


_SCHED = _round_schedules()


def compress8(cv: torch.Tensor, m: torch.Tensor, counter, block_len, flags) -> torch.Tensor:
    """Batched Blake3 compression, first 8 output words.

    cv: (..., 8), m: (..., 16) int64 words below 2^32; counter (low word),
    block_len and flags: ints or tensors broadcastable to the batch."""
    shape = cv.shape[:-1]
    dev = cv.device

    def bc(v):
        return torch.as_tensor(v, dtype=I64, device=dev).expand(shape)

    v = [cv[..., i] for i in range(8)] + [bc(IV[i]) for i in range(4)]
    v += [bc(counter), bc(0), bc(block_len), bc(flags)]

    def g(a, b, c, d, mx, my):
        v[a] = (v[a] + v[b] + mx) & MASK32
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & MASK32
        v[b] = _rotr(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b] + my) & MASK32
        v[d] = _rotr(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & MASK32
        v[b] = _rotr(v[b] ^ v[c], 7)

    for rnd in range(7):
        s = _SCHED[rnd]
        ms = [m[..., int(s[i])] for i in range(16)]
        g(0, 4, 8, 12, ms[0], ms[1])
        g(1, 5, 9, 13, ms[2], ms[3])
        g(2, 6, 10, 14, ms[4], ms[5])
        g(3, 7, 11, 15, ms[6], ms[7])
        g(0, 5, 10, 15, ms[8], ms[9])
        g(1, 6, 11, 12, ms[10], ms[11])
        g(2, 7, 8, 13, ms[12], ms[13])
        g(3, 4, 9, 14, ms[14], ms[15])
    return torch.stack([v[i] ^ v[i + 8] for i in range(8)], dim=-1)


@functools.lru_cache(maxsize=None)
def _chunk_tables(msg_len_bytes: int) -> tuple:
    """Per-(block, chunk) block lengths, flags and active masks."""
    nchunks = max(1, (msg_len_bytes + b3.CHUNK_LEN - 1) // b3.CHUNK_LEN)
    lens = np.zeros((16, nchunks), np.int64)
    flags = np.zeros((16, nchunks), np.int64)
    active = np.zeros((16, nchunks), bool)
    for c in range(nchunks):
        clen = msg_len_bytes - c * b3.CHUNK_LEN if c == nchunks - 1 else b3.CHUNK_LEN
        nblocks = max(1, (clen + b3.BLOCK_LEN - 1) // b3.BLOCK_LEN)
        for bidx in range(nblocks):
            f = CHUNK_START if bidx == 0 else 0
            if bidx == nblocks - 1:
                f |= CHUNK_END | (ROOT if nchunks == 1 else 0)
            lens[bidx, c] = 0 if clen == 0 else min(b3.BLOCK_LEN, clen - bidx * b3.BLOCK_LEN)
            flags[bidx, c] = f
            active[bidx, c] = True
    return lens, flags, active


def _compress_chunks(msg_words: torch.Tensor, counters: torch.Tensor,
                     tables: tuple) -> torch.Tensor:
    """CVs of the k chunks of (batch, k*256) words, given each chunk's
    counter and the (block, chunk) lengths, flags and active masks ->
    (batch, k, 8) int64."""
    batch, nw = msg_words.shape
    k = nw // (b3.CHUNK_LEN // 4)
    dev = msg_words.device
    blocks = msg_words.to(I64).reshape(batch, k, 16, 16)
    lens, flags, active = (torch.from_numpy(a).to(dev) for a in tables)
    cv = torch.tensor(IV, dtype=I64, device=dev).expand(batch, k, 8)
    for b in range(16):
        new = compress8(cv, blocks[:, :, b], counters, lens[b], flags[b])
        cv = torch.where(active[b][None, :, None], new, cv)
    return cv


def blake3_batch_words(msg_words: torch.Tensor, msg_len_bytes: int) -> torch.Tensor:
    """Blake3 of equal-length messages given as LE 32-bit words:
    (batch, ceil(len/4)) -> (batch, 8) int64 words."""
    dev = msg_words.device
    nchunks = max(1, (msg_len_bytes + b3.CHUNK_LEN - 1) // b3.CHUNK_LEN)
    pad = nchunks * (b3.CHUNK_LEN // 4) - msg_words.shape[1]
    msg = torch.nn.functional.pad(msg_words.to(I64), (0, pad))
    cv = _compress_chunks(msg, torch.arange(nchunks, dtype=I64, device=dev),
                          _chunk_tables(msg_len_bytes))
    if nchunks == 1:
        return cv[:, 0]
    return merge_chunk_cvs(cv)


@functools.lru_cache(maxsize=None)
def _chunk_tables_slice(k: int, tail_len: int) -> tuple:
    """Per-(block, chunk) block lengths, flags and active masks of k
    consecutive whole chunks of a multi-chunk message, the last of them
    tail_len bytes long (1024 unless it is the message's partial last
    chunk).  Chunk flags are per chunk, so nothing depends on where the
    slice sits in the message."""
    if not 1 <= tail_len <= b3.CHUNK_LEN:
        raise ValueError(f"tail_len {tail_len} outside [1, {b3.CHUNK_LEN}]")
    lens = np.zeros((16, k), np.int64)
    flags = np.zeros((16, k), np.int64)
    active = np.zeros((16, k), bool)
    for j in range(k):
        clen = tail_len if j == k - 1 else b3.CHUNK_LEN
        nblocks = (clen + b3.BLOCK_LEN - 1) // b3.BLOCK_LEN
        for bidx in range(nblocks):
            lens[bidx, j] = min(b3.BLOCK_LEN, clen - bidx * b3.BLOCK_LEN)
            flags[bidx, j] = (CHUNK_START if bidx == 0 else 0) | (
                CHUNK_END if bidx == nblocks - 1 else 0)
            active[bidx, j] = True
    return lens, flags, active


def chunk_cvs_words(msg_words: torch.Tensor, counters: torch.Tensor,
                    tail_len: int = b3.CHUNK_LEN) -> torch.Tensor:
    """CVs of k consecutive chunks of equal-length multi-chunk messages:
    (batch, k*256) LE words (zero past the message end) and (k,) global
    chunk counters -> (batch, k, 8) int64 words."""
    nw = msg_words.shape[1]
    k = nw // (b3.CHUNK_LEN // 4)
    if nw != k * (b3.CHUNK_LEN // 4):
        raise ValueError(f"chunk_cvs_words: {nw} words is not whole chunks")
    counters = torch.as_tensor(counters, dtype=I64, device=msg_words.device)
    return _compress_chunks(msg_words, counters, _chunk_tables_slice(k, tail_len))


def merge_chunk_cvs(cvs: torch.Tensor, root: int = ROOT) -> torch.Tensor:
    """(batch, k >= 1, 8) chunk CVs -> (batch, 8) digests, merged pairwise
    level by level with the odd node carried up (Blake3's left-leaning
    tree); `root` flags the last parent (0 for a subtree's CV)."""
    batch, k, _ = cvs.shape
    nodes = cvs
    iv = torch.tensor(IV, dtype=I64, device=cvs.device)
    while k > 1:
        pairs = k // 2
        blocks = nodes[:, : 2 * pairs].reshape(batch, pairs, 16)
        f = PARENT | (root if k == 2 else 0)
        parents = compress8(iv.expand(batch, pairs, 8), blocks, 0, b3.BLOCK_LEN, f)
        if k % 2:
            parents = torch.cat([parents, nodes[:, -1:]], dim=1)
        nodes = parents
        k = parents.shape[1]
    return nodes[:, 0]


# --------------------------------------------------------------------------
# field-element column hashing
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _byte_gather_plan(spec: FieldSpec) -> tuple:
    """For each LE 32-bit word of one element's repr: its 4 (limb, shift)
    byte sources."""
    W = spec.repr_bytes
    plan = []
    for w in range(W // 4):
        srcs = []
        for b in range(4):
            k = 4 * w + b
            vb = k if spec.endianness == "little" else W - 1 - k
            srcs.append((vb // 2, 8 * (vb % 2)))
        plan.append(tuple(srcs))
    return tuple(plan)


def limbs_to_repr_words(elems: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(..., L) limbs -> (..., repr_bytes/4) int64 LE words of the repr."""
    e = elems.to(I64)
    words = []
    for srcs in _byte_gather_plan(spec):
        word = torch.zeros(e.shape[:-1], dtype=I64, device=e.device)
        for pos, (limb, shift) in enumerate(srcs):
            word = word | (((e[..., limb] >> shift) & 0xFF) << (8 * pos))
        words.append(word)
    return torch.stack(words, dim=-1)


def _to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words below 2^32 -> int32 with the same bit pattern."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def hash_columns_plain(comm: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Leaf digests blake3(32 zero bytes || column reprs) of every column
    of an (n_rows, n_cols, L) limb tensor -> (n_cols, 8) int32."""
    n_rows, n_cols, _ = comm.shape
    words = limbs_to_repr_words(comm, spec).permute(1, 0, 2).reshape(n_cols, -1)
    msg = torch.cat([torch.zeros((n_cols, 8), dtype=I64, device=comm.device), words], dim=1)
    return _to_i32(blake3_batch_words(msg, 32 + n_rows * spec.repr_bytes))


def batch_chunks(rows_b: int, spec: FieldSpec, first: bool) -> tuple[int, int]:
    """(k, byte span) of one row batch's part of every column message: the
    32 zero bytes before row 0 in the first batch only, then rows_b reprs,
    in k chunks."""
    span = (32 if first else 0) + rows_b * spec.repr_bytes
    return -(-span // b3.CHUNK_LEN), span


def batch_message_words(comm_b: torch.Tensor, spec: FieldSpec, first: bool) -> torch.Tensor:
    """One encoded row batch (rows_b, n_cols, L) -> each column's part of
    its leaf message as (n_cols, k*256) int64 words: repr words in row
    order, 8 zero words before row 0 in the first batch, zero pad to whole
    chunks."""
    rows_b, n_cols, _ = comm_b.shape
    k, span = batch_chunks(rows_b, spec, first)
    words = limbs_to_repr_words(comm_b, spec).permute(1, 0, 2).reshape(n_cols, -1)
    lead = 8 if first else 0
    return torch.nn.functional.pad(words, (lead, k * (b3.CHUNK_LEN // 4) - span // 4))


def _check_chunk_args(comm_b: torch.Tensor, spec: FieldSpec, cvs: torch.Tensor, chunk0: int,
                      first: bool) -> tuple[int, int]:
    """(k, tail_len): the batch's chunk count and its last chunk's bytes."""
    rows_b, n_cols, L = comm_b.shape
    k, span = batch_chunks(rows_b, spec, first)
    if L != spec.num_limbs16:
        raise ValueError(f"chunk_cvs: batch {tuple(comm_b.shape)} is not {spec.name} limbs")
    if cvs.dim() != 3 or cvs.shape[0] != n_cols or cvs.shape[2] != 8 or not (
            0 <= chunk0 and chunk0 + k <= cvs.shape[1]):
        raise ValueError(f"chunk_cvs: CV array {tuple(cvs.shape)} has no room for chunks "
                         f"{chunk0}..{chunk0 + k - 1} of {n_cols} columns")
    return k, span - (k - 1) * b3.CHUNK_LEN


def chunk_cvs_plain(comm_b: torch.Tensor, spec: FieldSpec, cvs: torch.Tensor, chunk0: int,
                    first: bool) -> None:
    """Write the CVs of the k chunks that one encoded row batch covers into
    cvs[:, chunk0:chunk0+k] ((n_cols, total_chunks, 8) int32), plain
    PyTorch.  The batch's last chunk is partial only where the message ends:
    the caller cuts every other batch on a chunk boundary."""
    k, tail_len = _check_chunk_args(comm_b, spec, cvs, chunk0, first)
    counters = torch.arange(chunk0, chunk0 + k, dtype=I64, device=comm_b.device)
    words = batch_message_words(comm_b, spec, first)
    cvs[:, chunk0:chunk0 + k] = _to_i32(chunk_cvs_words(words, counters, tail_len))


def chunk_cvs(comm_b: torch.Tensor, spec: FieldSpec, cvs: torch.Tensor, chunk0: int,
              first: bool) -> None:
    """:func:`chunk_cvs_plain` (CPU) or K2's chunk-CV entry (CUDA): the CVs of
    the chunks that one encoded row batch covers, with global counters from
    chunk0, into cvs[:, chunk0:chunk0+k]."""
    if comm_b.device.type == "cpu":
        return chunk_cvs_plain(comm_b, spec, cvs, chunk0, first)
    rows_b, n_cols, L = comm_b.shape
    kernels.check_cuda("chunk_cvs batch", comm_b, torch.int32)
    kernels.check_cuda("chunk_cvs cvs", cvs, torch.int32)
    if 2 * L != spec.repr_bytes or L // 2 not in (2, 4, 6, 8) or cvs.device != comm_b.device:
        raise ValueError(f"chunk_cvs kernel: unsupported field {spec.name} or devices")
    k, tail_len = _check_chunk_args(comm_b, spec, cvs, chunk0, first)
    with torch.cuda.device(comm_b.device):
        kernels.BLAKE3_CHUNK_CVS(kernels.ptr(comm_b), kernels.ptr(cvs), rows_b, n_cols, k,
                                 cvs.shape[1], chunk0, int(first), tail_len, L // 2,
                                 int(spec.endianness == "big"), kernels.stream_of(comm_b))


def merge_cvs_plain(cvs: torch.Tensor) -> torch.Tensor:
    """(n_cols, k >= 2, 8) int32 chunk CVs -> (n_cols, 8) int32 leaf digests."""
    return _to_i32(merge_chunk_cvs(cvs.to(I64) & MASK32))


def merge_cvs(cvs: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Leaf digests from all chunk CVs of every column (K2's merge entry on
    CUDA, :func:`merge_cvs_plain` on CPU) into `out` ((n_cols, 8) int32, e.g.
    the first rows of a Merkle array), or a new tensor."""
    if cvs.dim() != 3 or cvs.shape[1] < 2 or cvs.shape[2] != 8:
        raise ValueError(f"merge_cvs: expected (n_cols, k >= 2, 8), got {tuple(cvs.shape)}")
    n_cols, k, _ = cvs.shape
    out = _check_out("merge_cvs", out, n_cols, cvs.device)
    if cvs.device.type == "cpu":
        return out.copy_(merge_cvs_plain(cvs))
    kernels.check_cuda("merge_cvs", cvs, torch.int32)
    kernels.check_cuda("merge_cvs out", out, torch.int32)
    with torch.cuda.device(cvs.device):
        kernels.BLAKE3_MERGE_CVS(kernels.ptr(cvs), kernels.ptr(out), n_cols, k,
                                 kernels.stream_of(cvs))
    return out


def _check_out(name: str, out: torch.Tensor | None, n: int, device) -> torch.Tensor:
    """`out`, or a new (n, 8) int32 tensor on `device`."""
    if out is None:
        return torch.empty((n, 8), dtype=torch.int32, device=device)
    if out.shape != (n, 8) or out.dtype != torch.int32 or out.device != torch.device(device):
        raise ValueError(f"{name}: out is {tuple(out.shape)} {out.dtype} on {out.device}, "
                         f"expected ({n}, 8) int32 on {device}")
    return out


def _aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels'
    vector loads and stores)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: a tensor does not start on a 16-byte boundary")


def hash_columns(comm: torch.Tensor, spec: FieldSpec, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Column leaf digests (K2 on CUDA, :func:`hash_columns_plain` on CPU)
    into `out` ((n_cols, 8) int32, e.g. the first rows of a Merkle array),
    or a new tensor."""
    n_rows, n_cols, L = comm.shape
    out = _check_out("hash_columns", out, n_cols, comm.device)
    if comm.device.type == "cpu":
        return out.copy_(hash_columns_plain(comm, spec))
    kernels.check_cuda("hash_columns", comm, torch.int32)
    kernels.check_cuda("hash_columns out", out, torch.int32)
    if L != spec.num_limbs16 or 2 * L != spec.repr_bytes or L // 2 not in (2, 4, 6, 8):
        raise ValueError(f"hash_columns kernel: unsupported field {spec.name}")
    if n_cols == 0:
        return out
    _aligned("hash_columns", comm, out)
    with torch.cuda.device(comm.device):
        kernels.BLAKE3_LEAVES(kernels.ptr(comm), kernels.ptr(out), n_rows, n_cols, L // 2,
                              int(spec.endianness == "big"), kernels.stream_of(comm))
    return out


# --------------------------------------------------------------------------
# the leaves kernel's decomposition, in plain PyTorch
# --------------------------------------------------------------------------

class LeafPlan(NamedTuple):
    msg_len: int     # bytes of a column's leaf message
    nchunks: int
    group: int       # chunks a thread, a power of two
    slots: int       # threads a column
    cols: int        # columns a block, a power of two


def leaf_plan(n_rows: int, repr_bytes: int, threads: int = LEAF_THREADS) -> LeafPlan:
    """csrc/blake3.cuh leaf_plan: one thread per chunk of a column's leaf
    message, or per aligned group of chunks once a message has more chunks
    than a block has threads; as many neighbouring columns a block (a power
    of two) as fill at most `threads` threads."""
    msg_len = 32 + n_rows * repr_bytes
    nchunks = max(1, -(-msg_len // b3.CHUNK_LEN))
    group = 1
    while -(-nchunks // group) > threads:
        group *= 2
    slots = -(-nchunks // group)
    cols = 1
    while 2 * cols * slots <= threads:
        cols *= 2
    return LeafPlan(msg_len, nchunks, group, slots, cols)


def leaf_words_plain(comm: torch.Tensor, spec: FieldSpec, nwords: int) -> torch.Tensor:
    """Words 0 .. nwords - 1 of every column's leaf message -> (n_cols,
    nwords) int64, read as csrc/blake3.cuh leaf_block reads them: a 16-word
    block from its first word g0, the elements from e0 = floor((g0 - 8) / W)
    on, each whole, two limbs a word, a big-endian repr's bytes reversed;
    zero before row 0 and past the last row."""
    n_rows, n_cols, L = comm.shape
    dev = comm.device
    if n_rows == 0:
        return torch.zeros((n_cols, nwords), dtype=I64, device=dev)
    W = L // 2
    g = np.arange(nwords)
    r = g - g % 16 - 8
    e0 = np.floor_divide(r, W)
    idx = r - e0 * W + g % 16
    e, ww = e0 + idx // W, idx % W
    vw = W - 1 - ww if spec.endianness == "big" else ww
    valid = torch.from_numpy((e >= 0) & (e < n_rows)).to(dev)
    rows = torch.from_numpy(np.clip(e, 0, n_rows - 1)).to(dev)
    at = ((rows[:, None] * n_cols + torch.arange(n_cols, device=dev)[None, :]) * L
          + torch.from_numpy(2 * vw).to(dev)[:, None])              # (nwords, n_cols)
    flat = comm.reshape(-1).to(I64)
    word = (flat[at] & 0xFFFF) | ((flat[at + 1] & 0xFFFF) << 16)
    if spec.endianness == "big":
        word = (((word & 0xFF) << 24) | ((word & 0xFF00) << 8) | ((word >> 8) & 0xFF00)
                | (word >> 24))
    return torch.where(valid[:, None], word, 0).T


def hash_columns_chunked_plain(comm: torch.Tensor, spec: FieldSpec,
                               threads: int = LEAF_THREADS) -> torch.Tensor:
    """The leaves kernel's decomposition: column tile by column tile (the
    plan's `cols` columns a block), every slot's CV (its chunk, the one-chunk
    message's root, or its group's subtree), then the block's merge at
    strides 1, 2, 4, ... with ROOT on the last parent -> (n_cols, 8) int32.
    `threads` below the kernel's makes small messages take the grouped path."""
    n_rows, n_cols, _ = comm.shape
    p = leaf_plan(n_rows, spec.repr_bytes, threads)
    words = leaf_words_plain(comm, spec, p.nchunks * (b3.CHUNK_LEN // 4))
    counters = torch.arange(p.nchunks, dtype=I64, device=comm.device)
    tables = _chunk_tables(p.msg_len)
    iv = torch.tensor(IV, dtype=I64, device=comm.device)
    out = torch.empty((n_cols, 8), dtype=torch.int32, device=comm.device)
    for c0 in range(0, n_cols, p.cols):
        tile = words[c0:c0 + p.cols]
        cvs = _compress_chunks(tile, counters, tables)            # (cols, nchunks, 8)
        nodes = torch.stack([merge_chunk_cvs(cvs[:, s * p.group:(s + 1) * p.group], root=0)
                             for s in range(p.slots)], dim=1)    # (cols, slots, 8)
        s = 1
        while s < p.slots:
            left = torch.arange(0, p.slots - s, 2 * s, device=comm.device)
            blocks = torch.cat([nodes[:, left], nodes[:, left + s]], dim=2)
            nodes[:, left] = compress8(iv.expand(*blocks.shape[:2], 8), blocks, 0, b3.BLOCK_LEN,
                                       PARENT | (ROOT if 2 * s >= p.slots else 0))
            s *= 2
        out[c0:c0 + p.cols] = _to_i32(nodes[:, 0])
    return out


# --------------------------------------------------------------------------
# the Merkle tree
# --------------------------------------------------------------------------

def merkle_parents_plain(nodes: torch.Tensor) -> torch.Tensor:
    """One Merkle layer: (2k, 8) digests -> (k, 8) parents, each a
    single-chunk blake3(left || right), not Blake3's PARENT mode
    (lcpc-2d/src/lib.rs:800-806)."""
    pairs = (nodes.to(I64) & MASK32).reshape(-1, 16)
    iv = torch.tensor(IV, dtype=I64, device=nodes.device).expand(pairs.shape[0], 8)
    return _to_i32(compress8(iv, pairs, 0, 64, CHUNK_START | CHUNK_END | ROOT))


def tree_layer_row(np2: int, k: int) -> int:
    """First row of layer k of a Merkle array over np2 leaves
    (lcpc-2d/src/lib.rs:685-694): the leaves at row 0, then each layer."""
    return 2 * np2 - 2 * (np2 >> k)


def tree_plan(np2: int, levels: int = TREE_LEVELS) -> list[tuple[int, int]]:
    """(level0, levels) of each tree launch: up to `levels` layers above
    layer level0, a block a subtree of 2^levels nodes; one launch below
    2^10 leaves, two up to 2^20."""
    depth = np2.bit_length() - 1
    return [(k, min(levels, depth - k)) for k in range(0, depth, levels)]


def merkle_array(n_cols: int, device) -> torch.Tensor:
    """A (2 np2 - 1, 8) int32 Merkle array for n_cols leaves, np2 the next
    power of two: rows [n_cols, np2) zero, the rest for the leaves (rows
    [0, n_cols)) and for :func:`merkle_tree` to fill."""
    np2 = 1 << max(n_cols - 1, 0).bit_length()
    hashes = torch.empty((2 * np2 - 1, 8), dtype=torch.int32, device=device)
    hashes[n_cols:np2].zero_()
    return hashes


def _merkle_np2(hashes: torch.Tensor) -> int:
    """np2 of a (2 np2 - 1, 8) Merkle array, np2 a power of two."""
    np2 = (hashes.shape[0] + 1) // 2 if hashes.dim() == 2 else 0
    if np2 == 0 or hashes.shape != (2 * np2 - 1, 8) or np2 & (np2 - 1):
        raise ValueError(f"a Merkle array is (2 np2 - 1, 8), got {tuple(hashes.shape)}")
    return np2


def merkle_tree_plain(hashes: torch.Tensor) -> torch.Tensor:
    """Fill every layer of a Merkle array from its leaves, layer by layer
    with :func:`merkle_parents_plain`; returns `hashes`."""
    np2 = _merkle_np2(hashes)
    for k in range(np2.bit_length() - 1):
        lo, mid, hi = tree_layer_row(np2, k), tree_layer_row(np2, k + 1), \
            tree_layer_row(np2, k + 2)
        hashes[mid:hi] = merkle_parents_plain(hashes[lo:mid])
    return hashes


def merkle_tree_tiles_plain(hashes: torch.Tensor, levels: int = TREE_LEVELS) -> torch.Tensor:
    """The tree kernel's decomposition: launch by launch of
    :func:`tree_plan`, each block's 2^n nodes of layer level0 and the n
    layers of their subtree, each layer's slice written at its row; returns
    `hashes`."""
    np2 = _merkle_np2(hashes)
    for level0, n in tree_plan(np2, levels):
        row0 = tree_layer_row(np2, level0)
        blocks = (np2 >> level0) >> n
        cur = hashes[row0:row0 + (np2 >> level0)].reshape(blocks, 1 << n, 8)
        for l in range(1, n + 1):
            cur = merkle_parents_plain(cur.reshape(-1, 8)).reshape(blocks, 1 << (n - l), 8)
            # block b's slice starts at row + b 2^(n - l): the slices tile the layer
            row = tree_layer_row(np2, level0 + l)
            hashes[row:row + (blocks << (n - l))] = cur.reshape(-1, 8)
    return hashes


def merkle_tree(hashes: torch.Tensor) -> torch.Tensor:
    """Fill every layer of a Merkle array (rows [0, np2) hold the leaves):
    K2's tree entry on CUDA, one launch a :func:`tree_plan` step (one below
    2^10 leaves, two up to 2^20); :func:`merkle_tree_plain` on CPU.  Returns
    `hashes`."""
    np2 = _merkle_np2(hashes)
    if hashes.device.type == "cpu":
        return merkle_tree_plain(hashes)
    kernels.check_cuda("merkle_tree", hashes, torch.int32)
    _aligned("merkle_tree", hashes)
    with torch.cuda.device(hashes.device):
        at, stream = kernels.ptr(hashes), kernels.stream_of(hashes)
        for level0, n in tree_plan(np2):
            kernels.BLAKE3_TREE(at, np2, level0, n, stream)
    return hashes


def digests_to_bytes(digests) -> list[bytes]:
    """(n, 8) words -> list of 32-byte digests (LE words)."""
    arr = _words_np(digests)
    return [arr[i].tobytes() for i in range(arr.shape[0])]


def digest_to_bytes(digest) -> bytes:
    return _words_np(digest).tobytes()


def bytes_to_digest(data: bytes) -> torch.Tensor:
    if len(data) != 32:
        raise ValueError("a digest is 32 bytes")
    return torch.from_numpy(np.frombuffer(data, dtype="<u4").view(np.int32).copy())


def _words_np(words) -> np.ndarray:
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    arr = np.asarray(words)
    return arr.view("<u4") if arr.dtype == np.int32 else arr.astype("<u4")
