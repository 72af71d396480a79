"""The port's C++ host library (``posnative.cc``), built with g++ and loaded
with ctypes at first use.

The library goes to ``build/native/<hash of the source>/`` at the root of
the checkout (listed in ``.gitignore``).  Where it cannot be built (no C++
compiler), :func:`native` returns None and every caller runs its
pure-Python or numpy fallback, which gives the same bytes.  This is host
code: no device work depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "posnative.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native: a build directory may be copied to another machine
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_lib = None
_tried = False

u8p = ctypes.POINTER(ctypes.c_uint8)
u32p = ctypes.POINTER(ctypes.c_uint32)
u64p = ctypes.POINTER(ctypes.c_uint64)
i64p = ctypes.POINTER(ctypes.c_int64)


def build() -> Path | None:
    """Compile posnative.cc unless the library for this source is there;
    returns its path, or None when the compiler is missing or fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_ROOT / h / "libposnative.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, so)
    return so


def native():
    """ctypes handle to the library, or None where it cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.pos_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p]
    lib.pos_fold_paths.argtypes = [u8p, u8p, i64p, ctypes.c_int64, ctypes.c_int64, u8p]
    lib.pos_chacha_blocks.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                                      ctypes.c_size_t, ctypes.c_int, u8p]
    lib.pos_keccak_f1600.argtypes = [u64p]
    lib.pos_strobe_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.pos_strobe_new.restype = ctypes.c_void_p
    for name in ("pos_strobe_meta_ad", "pos_strobe_ad"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_int]
    lib.pos_strobe_prf.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t, ctypes.c_int]
    lib.pos_strobe_append_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t]
    lib.pos_strobe_clone.argtypes = [ctypes.c_void_p]
    lib.pos_strobe_clone.restype = ctypes.c_void_p
    lib.pos_strobe_state.argtypes = [ctypes.c_void_p, u8p]
    lib.pos_strobe_free.argtypes = [ctypes.c_void_p]
    lib.pos_matgen_walk.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                                    ctypes.c_int32, ctypes.c_uint64, u64p, i64p, u64p]
    lib.pos_matgen_walk.restype = ctypes.c_int64
    lib.pos_mont_redc_limbs.argtypes = [u64p, ctypes.c_int64, ctypes.c_int32, u64p,
                                        ctypes.c_uint64, ctypes.c_int32, u32p]
    lib.pos_blake2b_many.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t, u8p]
    lib.pos_merkle_layers.argtypes = [u8p, ctypes.c_int64]
    _lib = lib
    return _lib


class NativeStrobe:
    """STROBE-128 duplex in C++ (the API of crypto.strobe.Strobe128 that the
    transcript uses)."""

    __slots__ = ("_lib", "_h")

    def __init__(self, protocol_label: bytes, _handle=None):
        self._lib = native()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = (_handle if _handle is not None
                   else self._lib.pos_strobe_new(protocol_label, len(protocol_label)))

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._lib.pos_strobe_meta_ad(self._h, data, len(data), int(more))

    def ad(self, data: bytes, more: bool) -> None:
        self._lib.pos_strobe_ad(self._h, data, len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        out = (ctypes.c_uint8 * n)()
        self._lib.pos_strobe_prf(self._h, out, n, int(more))
        return bytes(out)

    def append_batch(self, label: bytes, msgs: bytes, msg_len: int, count: int) -> None:
        """merlin append_message(label, m) for `count` contiguous equal-length
        messages, in one call."""
        self._lib.pos_strobe_append_batch(self._h, label, len(label), msgs, msg_len, count)

    def clone(self) -> "NativeStrobe":
        return NativeStrobe(b"", _handle=self._lib.pos_strobe_clone(self._h))

    def state_bytes(self) -> bytes:
        out = (ctypes.c_uint8 * 203)()
        self._lib.pos_strobe_state(self._h, out)
        return bytes(out)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pos_strobe_free(self._h)


def blake3_native(data: bytes) -> bytes | None:
    lib = native()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * 32)()
    lib.pos_blake3(data, len(data), out)
    return bytes(out)


def blake2b_many_native(msgs) -> np.ndarray | None:
    """BLAKE2b-256 (``hashlib.blake2b(digest_size=32)``) of n equal-length
    messages, (n, msg_len) uint8 -> (n, 32) uint8 digests in one call,
    OpenMP across the messages; None without the library."""
    lib = native()
    if lib is None:
        return None
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, msg_len = msgs.shape
    out = np.empty((n, 32), np.uint8)
    lib.pos_blake2b_many(msgs.ctypes.data_as(u8p), n, msg_len, out.ctypes.data_as(u8p))
    return out


def blake2b_merkle_layers_native(nodes: np.ndarray) -> bool:
    """Fill the BLAKE2b-256 layers of a (2 np2 - 1, 32) uint8 Merkle array in
    place from its np2 leaves; False without the library."""
    lib = native()
    if lib is None:
        return False
    np2 = (nodes.shape[0] + 1) // 2
    if (nodes.dtype != np.uint8 or not nodes.flags.c_contiguous
            or nodes.shape != (2 * np2 - 1, 32) or np2 & (np2 - 1)):
        raise ValueError(f"blake2b_merkle_layers_native: not a Merkle array: "
                         f"{nodes.shape} {nodes.dtype}")
    lib.pos_merkle_layers(nodes.ctypes.data_as(u8p), np2)
    return True


def fold_paths_native(leaves, sibs, cols) -> np.ndarray | None:
    """Merkle path folds leaf -> root in C: leaves (k, 32) uint8, sibs
    (k, depth, 32) uint8, cols (k,) int64 -> (k, 32) uint8 roots, or None
    without the library."""
    lib = native()
    if lib is None:
        return None
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    sibs = np.ascontiguousarray(sibs, dtype=np.uint8)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    k, depth = sibs.shape[0], sibs.shape[1]
    out = np.empty((k, 32), np.uint8)
    lib.pos_fold_paths(leaves.ctypes.data_as(u8p), sibs.ctypes.data_as(u8p),
                       cols.ctypes.data_as(i64p), k, depth, out.ctypes.data_as(u8p))
    return out


def chacha_blocks_native(key: bytes, stream: int, counter0: int, nblocks: int,
                         rounds: int) -> bytes | None:
    lib = native()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * (64 * nblocks))()
    lib.pos_chacha_blocks(key, stream, counter0, nblocks, rounds, out)
    return bytes(out)


def chacha_blocks_into(key: bytes, stream: int, counter0: int, nblocks: int, rounds: int,
                       out) -> bool:
    """Write nblocks*16 keystream u32 words into `out`, a C-contiguous uint32
    array; False without the library."""
    lib = native()
    if lib is None:
        return False
    lib.pos_chacha_blocks(key, stream, counter0, nblocks, rounds, out.ctypes.data_as(u8p))
    return True


def matgen_walk(W: np.ndarray, n: int, d: int, rng_range: int, zone: int, low: int, k: int,
                top_mask: int, p_words: np.ndarray):
    """The draw-by-draw matgen walk over a peeked u64 window: n columns of d
    distinct sorted rows, then d accepted k-word field reprs each.  Returns
    (rows (n, d) int64, reprs (n*d, k) uint64, words consumed), None when the
    window ran out, or False without the library."""
    lib = native()
    if lib is None:
        return False
    rows = np.empty((n, d), np.int64)
    reprs = np.empty((n * d, k), np.uint64)
    Wc = np.ascontiguousarray(W, dtype=np.uint64)
    consumed = lib.pos_matgen_walk(Wc.ctypes.data_as(u64p), len(Wc), n, d, rng_range, zone,
                                   low, k, top_mask, p_words.ctypes.data_as(u64p),
                                   rows.ctypes.data_as(i64p), reprs.ctypes.data_as(u64p))
    if consumed < 0:
        return None
    return rows, reprs, int(consumed)


def mont_redc_limbs(reprs: np.ndarray, p_words: np.ndarray, pinv: int, L: int) -> np.ndarray:
    """(M, k) Montgomery reprs below p -> (M, L) uint32 16-bit limbs of
    repr * 2^(-64k) mod p.  Requires the library."""
    M, k = reprs.shape
    out = np.empty((M, L), np.uint32)
    native().pos_mont_redc_limbs(np.ascontiguousarray(reprs).ctypes.data_as(u64p), M, k,
                                 p_words.ctypes.data_as(u64p), pinv, L,
                                 out.ctypes.data_as(u32p))
    return out
