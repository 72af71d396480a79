"""ChaCha20 as rand_chacha 0.3 streams it, and rand 0.8's samplers.

The benchmark's own copy for the reference: a 64-bit block counter in words
12..13, a 64-bit stream id in words 14..15, the keystream read as one run of
little-endian 32-bit words (next_u64 = low word | high word << 32), and
rand's PCG32 seed expansion for ``seed_from_u64``.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
_CONST = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def chacha_blocks(key: np.ndarray, stream: int, counter: int, nblocks: int,
                  rounds: int = 20) -> np.ndarray:
    """(nblocks * 16,) uint32 keystream words from block `counter` on."""
    ctr = counter + np.arange(nblocks, dtype=np.uint64)
    s = np.empty((16, nblocks), np.uint32)
    s[0:4] = np.array(_CONST, np.uint32)[:, None]
    s[4:12] = key[:, None]
    s[12] = (ctr & np.uint64(M32)).astype(np.uint32)
    s[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    s[14] = stream & M32
    s[15] = (stream >> 32) & M32
    x = s.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return (x + s).T.reshape(-1)


def seed_from_u64(state: int) -> bytes:
    """rand 0.8 SeedableRng::seed_from_u64 (PCG32 expansion), 32 bytes."""
    mul, inc = 6364136223846793005, 11634580027462260723
    out = bytearray()
    s = state & M64
    while len(out) < 32:
        s = (s * mul + inc) & M64
        xs = (((s >> 18) ^ s) >> 27) & M32
        rot = s >> 59
        out += (((xs >> rot) | (xs << ((32 - rot) & 31))) & M32).to_bytes(4, "little")
    return bytes(out)


class ChaCha:
    """A rand_chacha ChaCha20Rng: the keystream as one run of u32 words."""

    def __init__(self, seed: bytes, stream: int = 0, rounds: int = 20):
        self.key = np.frombuffer(seed, "<u4").astype(np.uint32)
        self.stream = stream
        self.rounds = rounds
        self.counter = 0
        self.words = np.empty(0, np.uint32)
        self.pos = 0

    def _need(self, n: int) -> None:
        if len(self.words) - self.pos >= n:
            return
        nblocks = max(64, -(-(n - (len(self.words) - self.pos)) // 16))
        fresh = chacha_blocks(self.key, self.stream, self.counter, nblocks, self.rounds)
        self.counter += nblocks
        self.words = np.concatenate([self.words[self.pos:], fresh])
        self.pos = 0

    def u64s(self, n: int) -> np.ndarray:
        """The next n u64 draws (consumed)."""
        w = self.peek_u64s(n)
        self.pos += 2 * n
        return w

    def peek_u64s(self, n: int) -> np.ndarray:
        self._need(2 * n)
        w = self.words[self.pos:self.pos + 2 * n].astype(np.uint64)
        return w[0::2] | (w[1::2] << np.uint64(32))

    def skip_u64s(self, n: int) -> None:
        self._need(2 * n)
        self.pos += 2 * n

    def next_u64(self) -> int:
        return int(self.u64s(1)[0])


def uniform_zone(n: int) -> int:
    """rand 0.8 Uniform::new(0, n) over usize: the widening-multiply zone."""
    return M64 - ((M64 - n + 1) % n)


def uniform_below(rng: ChaCha, n: int, count: int) -> list[int]:
    """`count` draws of Uniform::new(0, n), one u64 a try (rejection)."""
    zone = uniform_zone(n)
    out = []
    while len(out) < count:
        v = rng.next_u64()
        m = v * n
        if m & M64 <= zone:
            out.append(m >> 64)
    return out


def field_random(rng: ChaCha, p: int, n: int) -> list[int]:
    """n draws of ff_derive's Field::random: limbs-many u64s, the top bits
    shaved to the modulus' width, rejected unless below p, and read as a
    Montgomery form (value = drawn * R^-1 mod p, R = 2^(64 limbs))."""
    limbs = (p.bit_length() + 63) // 64
    mask = (1 << p.bit_length()) - 1
    r_inv = pow(pow(2, 64 * limbs, p), -1, p)
    out = []
    while len(out) < n:
        w = rng.u64s(limbs)
        v = 0
        for i in range(limbs):
            v |= int(w[i]) << (64 * i)
        v &= mask
        if v < p:
            out.append(v * r_inv % p)
    return out
