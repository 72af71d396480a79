"""STROBE-128 duplex construction over Keccak-f[1600].

Re-creates the tiny STROBE subset used by the merlin transcript crate
(reference: merlin-2.0/src/strobe.rs as used by lcpc-2d/src/lib.rs).
Only the operations merlin needs are provided: meta-AD, AD, PRF, KEY.
"""

from __future__ import annotations

from .keccak import keccak_f1600_bytes

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internal sponge plumbing ------------------------------------------
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        i, n = 0, len(data)
        while i < n:
            take = min(STROBE_R - self.pos, n - i)
            seg = (int.from_bytes(self.state[self.pos : self.pos + take], "little")
                   ^ int.from_bytes(data[i : i + take], "little"))
            self.state[self.pos : self.pos + take] = seg.to_bytes(take, "little")
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        i, n = 0, len(data)
        while i < n:
            take = min(STROBE_R - self.pos, n - i)
            self.state[self.pos : self.pos + take] = data[i : i + take]
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            take = min(STROBE_R - self.pos, n - len(out))
            out += self.state[self.pos : self.pos + take]
            self.state[self.pos : self.pos + take] = bytes(take)
            self.pos += take
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("flag mismatch on continued operation")
            return
        if flags & FLAG_T:
            raise ValueError("transport operations not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public operations --------------------------------------------------
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        new = object.__new__(Strobe128)
        new.state = bytearray(self.state)
        new.pos = self.pos
        new.pos_begin = self.pos_begin
        new.cur_flags = self.cur_flags
        return new

    def state_bytes(self) -> bytes:
        """Snapshot for transcript-equality oracles (tests only)."""
        return bytes(self.state) + bytes([self.pos, self.pos_begin, self.cur_flags])
