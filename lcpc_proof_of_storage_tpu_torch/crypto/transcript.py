"""Fiat-Shamir transcript, wire-compatible with the merlin crate.

The lcpc-2d engine (reference: lcpc-2d/src/lib.rs:1034-1123, 862-982) drives
a merlin `Transcript` for domain-separated challenge derivation.  Prover and
verifier must evolve bit-identical transcript state; `state_bytes()` exposes a
snapshot used by the transcript-equality test oracle (reference test:
lcpc-2d/src/tests.rs end_to_end_two_proofs).

The STROBE duplex runs in the native C++ runtime when available (appending a
collapsed row's coefficients is thousands of sequential STROBE ops — pure
python framing overhead dominates keccak itself); the pure-python Strobe128
is the fallback and the equality oracle.
"""

from __future__ import annotations

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _new_strobe(label: bytes):
    try:
        from ..native import NativeStrobe
        return NativeStrobe(label)
    except Exception:
        return Strobe128(label)


class Transcript:
    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = _new_strobe(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        data_len = len(message).to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def append_messages_batch(self, label: bytes, msgs: bytes,
                              msg_len: int, count: int) -> None:
        """append_message(label, m) for `count` equal-length messages packed
        contiguously in `msgs` — one native call when available."""
        if hasattr(self.strobe, "append_batch"):
            self.strobe.append_batch(label, msgs, msg_len, count)
        else:
            for i in range(count):
                self.append_message(label, msgs[i * msg_len:(i + 1) * msg_len])

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, x.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        data_len = n.to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n, False)

    def clone(self) -> "Transcript":
        new = object.__new__(Transcript)
        new.strobe = self.strobe.clone()
        return new

    def state_bytes(self) -> bytes:
        return self.strobe.state_bytes()
