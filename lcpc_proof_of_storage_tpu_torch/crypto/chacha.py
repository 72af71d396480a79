"""ChaCha20 / ChaCha8 deterministic RNG, behavior-compatible with rand_chacha 0.3.

The reference derives all protocol randomness from ChaCha streams seeded by
the transcript (lcpc-2d/src/lib.rs:1056-1062, 1102-1110) or fixed seeds
(proof-of-storage/src/networking/client.rs challenge columns, brakedown
matgen per-level streams: lcpc-brakedown-pc/src/matgen.rs:43-44).

Semantics reproduced here:
  * 64-bit block counter in words 12..13, 64-bit stream id in words 14..15
    (rand_chacha's layout; `set_stream` writes the stream id).
  * keystream emitted as consecutive little-endian u32 words;
    next_u64 = lo word | hi word << 32; fill_bytes = LE byte stream.
  * `seed_from_u64` uses rand 0.8's default PCG32-based seed expansion.

Keystream blocks for distinct counters are independent, so bulk generation is
vectorized with numpy over the counter axis.
"""

from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"


def _np_rotl(x: np.ndarray, n: int) -> np.ndarray:
    return ((x << np.uint32(n)) | (x >> np.uint32(32 - n))).astype(np.uint32)


def _chacha_blocks(key_words: np.ndarray, stream_words: np.ndarray,
                   counter_start: int, nblocks: int, rounds: int) -> np.ndarray:
    """Return (nblocks, 16) uint32 keystream words."""
    try:
        from ..native import chacha_blocks_native
        key = key_words.astype("<u4").tobytes()
        stream = int(stream_words[0]) | (int(stream_words[1]) << 32)
        out = chacha_blocks_native(key, stream, counter_start, nblocks, rounds)
        if out is not None:
            return np.frombuffer(out, dtype="<u4").astype(np.uint32).reshape(nblocks, 16)
    except ImportError:
        pass
    ctr = counter_start + np.arange(nblocks, dtype=np.uint64)
    state = np.empty((16, nblocks), dtype=np.uint32)
    for i, c in enumerate(_CONSTANTS):
        state[i] = c
    for i in range(8):
        state[4 + i] = key_words[i]
    state[12] = (ctr & 0xFFFFFFFF).astype(np.uint32)
    state[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    state[14] = stream_words[0]
    state[15] = stream_words[1]

    x = state.copy()

    def quarter(a, b, c, d):
        x[a] = (x[a] + x[b]).astype(np.uint32)
        x[d] = _np_rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]).astype(np.uint32)
        x[b] = _np_rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]).astype(np.uint32)
        x[d] = _np_rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]).astype(np.uint32)
        x[b] = _np_rotl(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)

    out = (x + state).astype(np.uint32)
    return out.T.copy()  # (nblocks, 16)


def seed_from_u64(state: int, seed_len: int = 32) -> bytes:
    """rand 0.8 SeedableRng::seed_from_u64 default impl (PCG32 expansion)."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray()
    s = state & ((1 << 64) - 1)
    while len(out) < seed_len:
        s = (s * MUL + INC) & ((1 << 64) - 1)
        xorshifted = (((s >> 18) ^ s) >> 27) & MASK32
        rot = s >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32
        out += x.to_bytes(4, "little")[: min(4, seed_len - len(out))]
    return bytes(out)


class ChaChaRng:
    """rand_chacha-compatible RNG core (rounds=20 for ChaCha20, 8 for ChaCha8)."""

    BUF_BLOCKS = 64  # generate this many blocks at a time via numpy

    def __init__(self, seed: bytes, rounds: int):
        assert len(seed) == 32
        self.key = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
        self.stream = np.zeros(2, dtype=np.uint32)
        self.rounds = rounds
        self.counter = 0          # next block counter to generate
        self._buf = np.empty(0, dtype=np.uint32)   # leftover keystream words
        self._buf_pos = 0

    @classmethod
    def from_seed(cls, seed: bytes, rounds: int = 20) -> "ChaChaRng":
        return cls(seed, rounds)

    @classmethod
    def seed_from_u64(cls, x: int, rounds: int = 20) -> "ChaChaRng":
        return cls(seed_from_u64(x), rounds)

    def set_stream(self, stream: int) -> None:
        if self._buf_pos != len(self._buf):
            # rand_chacha preserves the word position within the current
            # 4-block buffer when the stream changes; our callers only call
            # set_stream immediately after construction, matching matgen.rs:44.
            raise RuntimeError("set_stream with buffered keystream unsupported")
        self.stream = np.array([stream & 0xFFFFFFFF, (stream >> 32) & 0xFFFFFFFF],
                               dtype=np.uint32)

    def _refill(self, min_words: int) -> None:
        nblocks = max(self.BUF_BLOCKS, (min_words + 15) // 16)
        leftover = self._buf[self._buf_pos:]
        buf = np.empty(len(leftover) + nblocks * 16, np.uint32)
        buf[: len(leftover)] = leftover
        self._keystream_into(buf[len(leftover):], nblocks)
        self.counter += nblocks
        self._buf = buf
        self._buf_pos = 0

    def _keystream_into(self, out: np.ndarray, nblocks: int) -> None:
        """Fill `out` (nblocks*16 u32 words) with keystream starting at
        self.counter (native C++ core when available — ~26x and zero-copy
        vs the numpy quarter-round path)."""
        from ..native import chacha_blocks_into
        stream = int(self.stream[0]) | (int(self.stream[1]) << 32)
        if chacha_blocks_into(self.key.astype("<u4").tobytes(), stream,
                              self.counter, nblocks, self.rounds, out):
            return
        out[:] = _chacha_blocks(self.key, self.stream, self.counter, nblocks,
                                self.rounds).reshape(-1)

    def next_u32_array(self, n: int) -> np.ndarray:
        if len(self._buf) - self._buf_pos < n:
            self._refill(n)
        out = self._buf[self._buf_pos : self._buf_pos + n]
        self._buf_pos += n
        return out

    def next_u32(self) -> int:
        return int(self.next_u32_array(1)[0])

    def next_u64(self) -> int:
        w = self.next_u32_array(2)
        return int(w[0]) | (int(w[1]) << 32)

    def next_u64_array(self, n: int) -> np.ndarray:
        w = self.next_u32_array(2 * n).astype(np.uint64)
        return w[0::2] | (w[1::2] << np.uint64(32))

    # -- batched peek/consume (vectorized rejection sampling) ---------------
    def peek_u64_array(self, n: int) -> np.ndarray:
        """Next n u64 draws WITHOUT consuming them (matgen's numpy-batched
        rejection sampling peeks a window, then advances by the exact draw
        count the reference's sequential sampler would have consumed)."""
        if len(self._buf) - self._buf_pos < 2 * n:
            self._refill(2 * n)
        w = self._buf[self._buf_pos : self._buf_pos + 2 * n]
        if self._buf_pos % 2 == 0:
            # contiguous u32 pairs little-endian == u64 (zero-copy view)
            return w.view(np.uint64)
        w = w.astype(np.uint64)
        return w[0::2] | (w[1::2] << np.uint64(32))

    def advance_u64(self, n: int) -> None:
        assert len(self._buf) - self._buf_pos >= 2 * n
        self._buf_pos += 2 * n

    def fill_bytes(self, n: int) -> bytes:
        nwords = (n + 3) // 4
        words = self.next_u32_array(nwords)
        return words.astype("<u4").tobytes()[:n]


def chacha20_rng(seed: bytes) -> ChaChaRng:
    return ChaChaRng(seed, 20)


def chacha8_rng_from_u64(x: int) -> ChaChaRng:
    return ChaChaRng(seed_from_u64(x), 8)


# --------------------------------------------------------------------------
# rand 0.8 distribution semantics
# --------------------------------------------------------------------------

class UniformUsize:
    """rand 0.8 `Uniform::new(low, high)` over usize (64-bit), widening-multiply
    rejection sampling (lcpc-2d column challenges, lib.rs:1102-1110)."""

    def __init__(self, low: int, high: int):
        assert 0 <= low < high
        self.low = low
        self.range = high - low
        unsigned_max = (1 << 64) - 1
        ints_to_reject = (unsigned_max - self.range + 1) % self.range
        self.zone = unsigned_max - ints_to_reject

    def sample(self, rng: ChaChaRng) -> int:
        while True:
            v = rng.next_u64()
            m = v * self.range
            hi, lo = m >> 64, m & ((1 << 64) - 1)
            if lo <= self.zone:
                return self.low + hi

    def candidates(self, words: np.ndarray):
        """Vectorized accept mask + candidate values for a window of u64
        draws (same widening-multiply math as sample(), one word each).
        Requires range < 2^32 (all matgen row counts qualify)."""
        assert self.range < (1 << 32)
        r = np.uint64(self.range)
        lo64 = words * r                              # mod 2^64
        vhi = words >> np.uint64(32)
        vlo = words & np.uint64(0xFFFFFFFF)
        hi = (vhi * r + ((vlo * r) >> np.uint64(32))) >> np.uint64(32)
        ok = lo64 <= np.uint64(self.zone)
        return ok, hi + np.uint64(self.low)


def gen_range_u64(rng: ChaChaRng, low: int, high: int) -> int:
    """rand 0.8 `Rng::gen_range(low..high)` single-sample path (sample_single):
    zone = (range << range.leading_zeros()).wrapping_sub(1)."""
    rng_range = high - low
    assert rng_range > 0
    lz = 64 - rng_range.bit_length()
    zone = ((rng_range << lz) - 1) & ((1 << 64) - 1)
    while True:
        v = rng.next_u64()
        m = v * rng_range
        hi, lo = m >> 64, m & ((1 << 64) - 1)
        if lo <= zone:
            return low + hi


def choose_multiple(rng: ChaChaRng, n: int, amount: int) -> list[int]:
    """rand 0.8 IteratorRandom::choose_multiple over 0..n (reservoir sampling),
    as used for PoS challenge columns (client.rs:443-456)."""
    amount = min(amount, n)
    reservoir = list(range(amount))
    for i in range(n - amount):
        k = gen_range_u64(rng, 0, i + 1 + amount)
        if k < amount:
            reservoir[k] = amount + i
    return reservoir
