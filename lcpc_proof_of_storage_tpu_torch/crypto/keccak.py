"""Keccak-f[1600] permutation (host-side, pure Python).

Used by the STROBE-128 sponge underlying the merlin Fiat-Shamir transcript
(reference: merlin 2.0 crate, used by lcpc-2d/src/lib.rs prove/verify
transcripts).  The round constants and rho offsets are generated from the
Keccak specification's LFSR rather than hard-coded tables.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1


def _rc_bit(t: int) -> int:
    # LFSR over GF(2): x^8 + x^6 + x^5 + x^4 + 1
    r = 1
    for _ in range(t % 255):
        r <<= 1
        if r & 0x100:
            r ^= 0x171
    return r & 1


def _round_constants() -> list[int]:
    rcs = []
    for ir in range(24):
        rc = 0
        for j in range(7):
            if _rc_bit(7 * ir + j):
                rc |= 1 << ((1 << j) - 1)
        rcs.append(rc)
    return rcs


def _rho_offsets() -> list[int]:
    # offsets[x + 5*y]
    offs = [0] * 25
    x, y = 1, 0
    for t in range(24):
        offs[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return offs


RC = _round_constants()
RHO = _rho_offsets()


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & MASK64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Apply Keccak-f[1600] to 25 64-bit lanes (index = x + 5*y)."""
    a = list(lanes)
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], RHO[x + 5 * y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & MASK64)
        # iota
        a[0] ^= RC[rnd]
    return a


def _get_native():
    """The native permutation, or None where the library is not built."""
    from ..native import native
    lib = native()
    return None if lib is None else lib.pos_keccak_f1600


def keccak_f1600_bytes(state: bytearray) -> None:
    """Apply Keccak-f[1600] in place to a 200-byte state (little-endian lanes).

    Uses the C++ kernel when available (transcript appends hash the whole
    p_random/p_eval rows — thousands of permutations per proof)."""
    fn = _get_native()
    if fn is not None:
        import ctypes
        buf = (ctypes.c_uint64 * 25).from_buffer(state)
        fn(buf)
        return
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 (FIPS 202).  Only used as a self-test vector for the permutation."""
    rate = 136
    state = bytearray(200)
    # absorb with pad10*1 (domain 0x06 for SHA3)
    padded = bytearray(data)
    padded.append(0x06)
    while len(padded) % rate != 0:
        padded.append(0x00)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            state[i] ^= padded[off + i]
        keccak_f1600_bytes(state)
    return bytes(state[:32])
