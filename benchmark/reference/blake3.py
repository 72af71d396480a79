"""BLAKE3 column leaves and the lcpc Merkle tree, in plain PyTorch.

Each leaf is BLAKE3(32 zero bytes || the column's canonical reprs), as
lcpc-2d hashes a column; the tree pads the leaves with zero digests to a
power of two and hashes each pair as BLAKE3(left || right).  The compression
runs on int64 tensors holding 32-bit words, over many columns and chunks at
once: every chunk of every column in a block of columns is one lane.
"""

from __future__ import annotations

import torch

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB,
      0x5BE0CD19)
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def _g(a, b, c, d, mx, my):
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def compress(cv: torch.Tensor, m: torch.Tensor, counter: torch.Tensor | int, block_len,
             flags) -> torch.Tensor:
    """BLAKE3's compression over lanes: cv (n, 8) and m (n, 16) int64 words,
    counter, block_len and flags scalars or (n,) tensors; returns the (n, 8)
    chaining values."""
    n = cv.shape[0]
    dev = cv.device

    def col(v):
        return torch.as_tensor(v, dtype=torch.int64, device=dev).expand(n)

    a, b = cv[:, 0:4], cv[:, 4:8]
    c = torch.tensor(IV[:4], dtype=torch.int64, device=dev).expand(n, 4)
    ctr = col(counter)
    d = torch.stack([ctr & M32, ctr >> 32, col(block_len), col(flags)], dim=1)
    perm = torch.tensor(PERM, device=dev)
    for r in range(7):
        a, b, c, d = _g(a, b, c, d, m[:, 0:8:2], m[:, 1:8:2])
        b, c, d = b.roll(-1, 1), c.roll(-2, 1), d.roll(-3, 1)
        a, b, c, d = _g(a, b, c, d, m[:, 8:16:2], m[:, 9:16:2])
        b, c, d = b.roll(1, 1), c.roll(2, 1), d.roll(3, 1)
        if r < 6:
            m = m[:, perm]
    return torch.cat([a ^ c, b ^ d], dim=1)


def _words(mat_cols: torch.Tensor, repr_bytes: int) -> torch.Tensor:
    """(n_cols, n_rows, L) limbs -> (n_cols, W) int64 message words of
    32 zero bytes || reprs, W a multiple of 256 (whole chunks, zero-padded)."""
    n_cols, n_rows, L = mat_cols.shape
    if repr_bytes != 2 * L or repr_bytes % 4:
        raise ValueError("reprs must be whole 32-bit words of 16-bit limbs")
    limbs = mat_cols.to(torch.int32) & 0xFFFF
    words = (limbs[..., 0::2].to(torch.int64)
             | (limbs[..., 1::2].to(torch.int64) << 16)).reshape(n_cols, -1)
    del limbs
    total = 8 + words.shape[1]
    padded = -(-total // 256) * 256
    out = torch.zeros((n_cols, padded), dtype=torch.int64, device=mat_cols.device)
    out[:, 8:total] = words
    return out


def _chunk_cvs(words: torch.Tensor, msg_bytes: int, root: bool) -> torch.Tensor:
    """(n, C*256) words of messages of msg_bytes each -> (n, C, 8) chunk CVs
    (with the ROOT flag on a message of one chunk)."""
    n, W = words.shape
    C = W // 256
    blocks = words.reshape(n * C, 16, 16)
    lanes = n * C
    dev = words.device
    chunk = torch.arange(C, dtype=torch.int64, device=dev).repeat(n)
    chunk_bytes = torch.clamp(msg_bytes - chunk * 1024, max=1024)           # >= 1
    nblocks = torch.div(chunk_bytes + 63, 64, rounding_mode="floor")
    cv = torch.tensor(IV, dtype=torch.int64, device=dev).repeat(lanes, 1)
    for j in range(16):
        live = nblocks > j
        if not bool(live.any()):
            break
        last = nblocks == j + 1
        blen = torch.where(last, chunk_bytes - 64 * j, 64)
        flags = ((CHUNK_START if j == 0 else 0) + torch.where(last, CHUNK_END, 0)
                 + torch.where(last & root, ROOT, 0))
        out = compress(cv, blocks[:, j], chunk, blen, flags)
        cv = torch.where(live[:, None], out, cv)
    return cv.reshape(n, C, 8)


def _parents(left: torch.Tensor, right: torch.Tensor, flags: int) -> torch.Tensor:
    m = torch.cat([left, right], dim=-1)
    shape = m.shape[:-1]
    m = m.reshape(-1, 16)
    iv = torch.tensor(IV, dtype=torch.int64, device=m.device).expand(m.shape[0], 8)
    return compress(iv, m, 0, 64, flags).reshape(*shape, 8)


def _subtree(cvs: torch.Tensor, root: bool) -> torch.Tensor:
    """BLAKE3's tree over (n, C, 8) chunk CVs: the left subtree holds the
    largest power of two of chunks below C."""
    C = cvs.shape[1]
    if C == 1:
        return cvs[:, 0]
    left_n = 1 << ((C - 1).bit_length() - 1)
    left = cvs[:, :left_n]
    while left.shape[1] > 1:                       # a perfect subtree, level by level
        left = _parents(left[:, 0::2], left[:, 1::2], PARENT)
    right = _subtree(cvs[:, left_n:], False)
    return _parents(left[:, 0], right, PARENT | (ROOT if root else 0))


def column_leaves(mat: torch.Tensor, repr_bytes: int, lanes: int = 1 << 20) -> torch.Tensor:
    """(n_cols, 8) int64 leaf words of a (n_rows, n_cols, L) limb matrix,
    about `lanes` chunks at a time."""
    n_rows, n_cols, L = mat.shape
    msg_bytes = 32 + n_rows * repr_bytes
    block = max(1, lanes // -(-msg_bytes // 1024))
    out = []
    for c0 in range(0, n_cols, block):
        cols = mat[:, c0:c0 + block].transpose(0, 1)
        words = _words(cols, repr_bytes)
        del cols
        cvs = _chunk_cvs(words, msg_bytes, root=msg_bytes <= 1024)
        del words
        out.append(_subtree(cvs, root=True))
    return torch.cat(out)


def hash_bytes(data: bytes) -> bytes:
    """BLAKE3 of one message (for tests and the tree's parents)."""
    n = len(data)
    padded = data + bytes(-(-max(n, 1) // 1024) * 1024 - n)
    words = torch.frombuffer(bytearray(padded), dtype=torch.int32).to(torch.int64) & M32
    cvs = _chunk_cvs(words[None], max(n, 0), root=n <= 1024) if n else _empty_cv()
    return digest_bytes(_subtree(cvs, root=True)[0])


def _empty_cv() -> torch.Tensor:
    z = torch.zeros((1, 16), dtype=torch.int64)
    iv = torch.tensor(IV, dtype=torch.int64)[None]
    return compress(iv, z, 0, 0, CHUNK_START | CHUNK_END | ROOT)[:, None]


def digest_bytes(words: torch.Tensor) -> bytes:
    return b"".join(int(w).to_bytes(4, "little") for w in words.tolist())


def merkle_levels(leaves: torch.Tensor) -> list[torch.Tensor]:
    """The lcpc Merkle tree over (n, 8) leaf words: the leaves padded with
    zero digests to a power of two, then each level up to the root."""
    n = leaves.shape[0]
    np2 = 1 << (n - 1).bit_length()
    level = torch.zeros((np2, 8), dtype=torch.int64, device=leaves.device)
    level[:n] = leaves
    levels = [level]
    while level.shape[0] > 1:
        level = _parents(level[0::2], level[1::2], CHUNK_START | CHUNK_END | ROOT)
        levels.append(level)
    return levels


def merkle_path(levels: list[torch.Tensor], column: int) -> list[bytes]:
    """Sibling digests from the leaf level up."""
    out = []
    for level in levels[:-1]:
        out.append(digest_bytes(level[column ^ 1]))
        column >>= 1
    return out
