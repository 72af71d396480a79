"""Blake3 column leaves, Merkle parents and streamed chunk CVs over limb
tensors.

Counterparts of ``lcpc_proof_of_storage_tpu/ops/blake3_jax.py`` (the plain
versions here) and ``ops/blake3_pallas.py`` (kernel K2, ``csrc/blake3.cu``,
whose other entry points build the Merkle layers, the chunk chaining values
of one row batch of a streamed commit, and the leaves merged from them).

Digests are (n, 8) ``torch.int32`` tensors carrying the bit pattern of the
reference's uint32 words.  The plain versions compute the 32-bit adds and
rotates in int64, masked to 32 bits.
"""

from __future__ import annotations

import functools

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


def merge_chunk_cvs(cvs: torch.Tensor) -> torch.Tensor:
    """(batch, k >= 2, 8) chunk CVs -> (batch, 8) digests, merged pairwise
    level by level with the odd node carried up (Blake3's left-leaning
    tree)."""
    batch, k, _ = cvs.shape
    nodes = cvs
    iv = torch.tensor(IV, dtype=I64, device=cvs.device)
    while k > 1:
        pairs = k // 2
        blocks = nodes[:, : 2 * pairs].reshape(batch, pairs, 16)
        f = PARENT | (ROOT if k == 2 else 0)
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


def merge_cvs(cvs: torch.Tensor) -> torch.Tensor:
    """Leaf digests from all chunk CVs of every column (K2's merge entry on
    CUDA, :func:`merge_cvs_plain` on CPU)."""
    if cvs.dim() != 3 or cvs.shape[1] < 2 or cvs.shape[2] != 8:
        raise ValueError(f"merge_cvs: expected (n_cols, k >= 2, 8), got {tuple(cvs.shape)}")
    if cvs.device.type == "cpu":
        return merge_cvs_plain(cvs)
    kernels.check_cuda("merge_cvs", cvs, torch.int32)
    n_cols, k, _ = cvs.shape
    out = torch.empty((n_cols, 8), dtype=torch.int32, device=cvs.device)
    with torch.cuda.device(cvs.device):
        kernels.BLAKE3_MERGE_CVS(kernels.ptr(cvs), kernels.ptr(out), n_cols, k,
                                 kernels.stream_of(cvs))
    return out


def merkle_parents_plain(nodes: torch.Tensor) -> torch.Tensor:
    """One Merkle layer: (2k, 8) digests -> (k, 8) parents, each a
    single-chunk blake3(left || right), not Blake3's PARENT mode
    (lcpc-2d/src/lib.rs:800-806)."""
    pairs = (nodes.to(I64) & MASK32).reshape(-1, 16)
    iv = torch.tensor(IV, dtype=I64, device=nodes.device).expand(pairs.shape[0], 8)
    return _to_i32(compress8(iv, pairs, 0, 64, CHUNK_START | CHUNK_END | ROOT))


def hash_columns(comm: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Column leaf digests (K2 on CUDA, :func:`hash_columns_plain` on CPU)."""
    if comm.device.type == "cpu":
        return hash_columns_plain(comm, spec)
    n_rows, n_cols, L = comm.shape
    kernels.check_cuda("hash_columns", comm, torch.int32)
    if L != spec.num_limbs16 or 2 * L != spec.repr_bytes or L // 2 not in (2, 4, 6, 8):
        raise ValueError(f"hash_columns kernel: unsupported field {spec.name}")
    out = torch.empty((n_cols, 8), dtype=torch.int32, device=comm.device)
    if n_cols == 0:
        return out
    with torch.cuda.device(comm.device):
        kernels.BLAKE3_LEAVES(kernels.ptr(comm), kernels.ptr(out), n_rows, n_cols, L // 2,
                              int(spec.endianness == "big"), kernels.stream_of(comm))
    return out


def merkle_parents(nodes: torch.Tensor) -> torch.Tensor:
    """One Merkle layer (K2's parent entry on CUDA, plain on CPU)."""
    if nodes.device.type == "cpu":
        return merkle_parents_plain(nodes)
    kernels.check_cuda("merkle_parents", nodes, torch.int32)
    if nodes.dim() != 2 or nodes.shape[1] != 8 or nodes.shape[0] % 2:
        raise ValueError(f"merkle_parents: expected (2k, 8), got {tuple(nodes.shape)}")
    k = nodes.shape[0] // 2
    out = torch.empty((k, 8), dtype=torch.int32, device=nodes.device)
    with torch.cuda.device(nodes.device):
        kernels.BLAKE3_PARENTS(kernels.ptr(nodes), kernels.ptr(out), k,
                               kernels.stream_of(nodes))
    return out


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
