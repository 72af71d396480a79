"""Merlin transcript over STROBE-128 over Keccak-f[1600], in plain Python.

The benchmark's own copy of the protocol's Fiat-Shamir transcript (the merlin
crate, as lcpc-2d uses it), written for this reference alone: it imports
nothing of the program under test.  STROBE-128 is a Keccak sponge at rate 168
whose blocks end as cSHAKE128's do, so the duplex is kept as the stream of
blocks it absorbs and the permutation runs in the standard library's OpenSSL
Keccak (its KECCAK-KMAC-128 digest), or, where that is missing, in an
unrolled Keccak-f[1600] on 25 Python ints (about 0.4 ms a block).
"""

from __future__ import annotations

import hashlib
import struct

STROBE_R = 166
FLAG_I, FLAG_A, FLAG_C, FLAG_T, FLAG_M, FLAG_K = 1, 2, 4, 8, 16, 32
M64 = (1 << 64) - 1


def _round_constants() -> list[int]:
    out = []
    r = 1
    bits = []
    for _ in range(255):
        bits.append(r & 1)
        r <<= 1
        if r & 0x100:
            r ^= 0x171
    for ir in range(24):
        rc = 0
        for j in range(7):
            if bits[(7 * ir + j) % 255]:
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return out


def _rho_offsets() -> list[int]:
    offs = [0] * 25
    x, y = 1, 0
    for t in range(24):
        offs[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return offs


def _rot(expr: str, n: int) -> str:
    n %= 64
    if n == 0:
        return expr
    return f"((({expr}) << {n}) | (({expr}) >> {64 - n})) & {M64}"


def _build_permutation():
    """keccak_f(lanes) -> lanes, unrolled over one round, looped 24 times."""
    rho = _rho_offsets()
    lines = ["def keccak_f(s):",
             "    (" + ", ".join(f"a{i}" for i in range(25)) + ") = s"]
    lines.append("    for rc in RC:")
    body = []
    for x in range(5):
        body.append(f"c{x} = a{x} ^ a{x + 5} ^ a{x + 10} ^ a{x + 15} ^ a{x + 20}")
    for x in range(5):
        body.append(f"d{x} = c{(x - 1) % 5} ^ ({_rot(f'c{(x + 1) % 5}', 1)})")
    # theta then rho and pi: b[y, 2x+3y] = rot(a[x, y] ^ d[x], rho[x, y])
    for x in range(5):
        for y in range(5):
            src = f"(a{x + 5 * y} ^ d{x})"
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            body.append(f"b{dst} = {_rot(src, rho[x + 5 * y])}")
    for y in range(5):
        for x in range(5):
            i = x + 5 * y
            body.append(f"a{i} = b{i} ^ ((~b{(x + 1) % 5 + 5 * y}) & b{(x + 2) % 5 + 5 * y})")
    body.append("a0 ^= rc")
    lines += ["        " + b for b in body]
    lines.append("    return [" + ", ".join(f"a{i}" for i in range(25)) + "]")
    ns = {"RC": _round_constants()}
    exec("\n".join(lines), ns)
    return ns["keccak_f"]


keccak_f = _build_permutation()
_LANES = struct.Struct("<25Q")


RATE = STROBE_R + 2          # 168 bytes: Keccak-f[1600] at capacity 256


class PySponge:
    """Keccak-f[1600] at rate 168 on 25 Python ints."""

    def __init__(self):
        self.lanes = [0] * 25

    def absorb(self, block: bytes) -> None:
        """XOR one 168-byte block into the rate and permute."""
        words = _LANES.unpack(bytes(block) + bytes(200 - RATE))
        self.lanes = keccak_f([a ^ b for a, b in zip(self.lanes, words)])

    def squeeze(self, tail: bytes, n: int) -> bytes:
        """The first n rate bytes after absorbing `tail` with the padding
        0x04 ... 0x80 (the state itself is left as it was)."""
        block = bytearray(RATE)
        block[:len(tail)] = tail
        block[len(tail)] ^= 0x04
        block[RATE - 1] ^= 0x80
        words = _LANES.unpack(bytes(block) + bytes(200 - RATE))
        return _LANES.pack(*keccak_f([a ^ b for a, b in zip(self.lanes, words)]))[:n]

    def peek(self, n: int) -> bytes:
        """The first n rate bytes of the state as it is."""
        return _LANES.pack(*self.lanes)[:n]


class HashlibSponge:
    """The same sponge through the standard library's OpenSSL Keccak at
    rate 168 with the padding 0x04 ... 0x80 (its KECCAK-KMAC-128 digest,
    the sponge under cSHAKE128), which STROBE-128's block end is."""

    def __init__(self):
        self.h = hashlib.new("KECCAK-KMAC-128")

    def absorb(self, block: bytes) -> None:
        self.h.update(block)

    def squeeze(self, tail: bytes, n: int) -> bytes:
        h = self.h.copy()
        h.update(tail)
        return h.digest(n)

    def peek(self, n: int) -> bytes:
        raise NotImplementedError("OpenSSL's sponge pads every read")


def _sponge():
    try:
        return HashlibSponge()
    except ValueError:
        return PySponge()


class Strobe128:
    """The STROBE-128 operations merlin uses (meta-AD, AD and PRF), kept as
    the stream of blocks its duplex absorbs: a block that fills is the 166
    bytes, the pos_begin byte and 0x84; a PRF ends its block with pos_begin
    and the padding 0x04 ... 0x80, reads the output, and the next block
    starts with that output (the squeezed bytes are zeroed)."""

    def __init__(self, protocol_label: bytes, sponge=None):
        self.sponge = sponge if sponge is not None else _sponge()
        init = bytearray(RATE)
        init[0:6] = bytes([1, RATE, 1, 0, 1, 96])
        init[6:18] = b"STROBEv1.0.2"
        self.sponge.absorb(bytes(init))
        self.pending = bytearray()        # bytes absorbed since the block began
        self.pos_begin = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        """A block filled: its 166 bytes, pos_begin, 0x04 ^ 0x80."""
        self.sponge.absorb(bytes(self.pending) + bytes((self.pos_begin, 0x84)))
        self.pending = bytearray()
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        pending = self.pending
        if len(data) < STROBE_R - len(pending):
            pending += data
            return
        i, n = 0, len(data)
        while i < n:
            room = STROBE_R - len(self.pending)
            self.pending += data[i:i + room]
            i += room
            if len(self.pending) == STROBE_R:
                self._run_f()

    def _begin_op(self, flags: int) -> None:
        old_begin = self.pos_begin
        self.pos_begin = len(self.pending) + 1
        self._absorb(bytes((old_begin, flags)))

    def meta_ad(self, data: bytes, more: bool) -> None:
        if not more:
            self._begin_op(FLAG_M | FLAG_A)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        if not more:
            self._begin_op(FLAG_A)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C)
        if n > STROBE_R:
            raise ValueError("a PRF of more than one block is not needed here")
        if not self.pending:
            # the op's two bytes filled the block, so no F is forced: the
            # output is the state's rate as it is
            out = self.sponge.peek(n)
            self.pending = bytearray(out)
            return out
        tail = bytes(self.pending) + bytes((self.pos_begin,))
        out = self.sponge.squeeze(tail, n)
        block = bytearray(RATE)
        block[:len(tail)] = tail
        block[len(tail)] ^= 0x04
        block[RATE - 1] ^= 0x80
        self.sponge.absorb(bytes(block))
        self.pending = bytearray(out)
        self.pos_begin = 0
        return out


class Transcript:
    """merlin::Transcript: append_message and challenge_bytes."""

    def __init__(self, label: bytes, sponge=None):
        self.strobe = Strobe128(b"Merlin v1.0", sponge)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        s = self.strobe
        s.meta_ad(label, False)
        s.meta_ad(len(message).to_bytes(4, "little"), True)
        s.ad(message, False)

    def append_messages(self, label: bytes, msgs: bytes, width: int) -> None:
        """append_message(label, m) for each `width`-byte m packed in msgs."""
        for i in range(0, len(msgs), width):
            self.append_message(label, msgs[i:i + width])

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        s = self.strobe
        s.meta_ad(label, False)
        s.meta_ad(n.to_bytes(4, "little"), True)
        return s.prf(n)
