"""Prime field specifications and exact host-side arithmetic.

A copy of the JAX package's ``fields/field.py`` (which imports no JAX), so
the port depends on nothing of that package.  It mirrors the capability of the reference's ff_derive-generated fields
(lcpc-test-fields/src/lib.rs: Ft63/Ft127/Ft191/Ft255;
proof-of-storage/src/fields/{writable_ft63,ft253_192}.rs) without Montgomery
form: the host representation is the canonical integer value.  Tensors carry
the 16-bit limb decomposition (fields/limb.py).

Reference-semantics notes:
  * ``to_repr`` bytes are the canonical value in the field's declared
    endianness (ff's PrimeFieldReprEndianness), used for hashing
    (FieldHash::to_hash_repr, lcpc-2d/src/lib.rs:35-59) and on-disk raw
    storage (WRITTEN_BYTES_WIDTH).
  * ``random`` reproduces ff_derive's rejection sampling: draw limbs-many
    u64s, mask the top REPR_SHAVE_BITS, reject if >= p.  ff_derive treats
    the accepted integer as the *Montgomery* representation, so the field
    value is ``drawn * R^{-1} mod p`` with R = 2^(64*limbs) mod p; we apply
    that factor to keep RNG stream consumption and sampled values
    bit-identical to the reference.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


def _two_adicity(p: int) -> int:
    s, v = 0, p - 1
    while v % 2 == 0:
        s += 1
        v //= 2
    return s


@dataclass(frozen=True)
class FieldSpec:
    """All static data for one prime field."""

    name: str
    modulus: int
    generator: int
    endianness: str = "little"       # repr byte order ("little" | "big")

    # ---- derived ----------------------------------------------------------
    @property
    def num_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def capacity(self) -> int:
        return self.num_bits - 1

    @property
    def u64_limbs(self) -> int:
        return (self.num_bits + 63) // 64

    @property
    def repr_bytes(self) -> int:
        """WRITTEN_BYTES_WIDTH: canonical repr width (= sizeof([u64; limbs]))."""
        return 8 * self.u64_limbs

    @property
    def data_byte_capacity(self) -> int:
        """DATA_BYTE_CAPACITY = CAPACITY / 8 (reference data_field.rs:22)."""
        return self.capacity // 8

    @property
    def num_limbs16(self) -> int:
        """Number of 16-bit limbs in the device representation."""
        return (self.repr_bytes + 1) // 2

    @property
    def two_adicity(self) -> int:
        return _two_adicity(self.modulus)

    @functools.cached_property
    def root_of_unity(self) -> int:
        """g^((p-1)/2^S): generator of the maximal power-of-two subgroup."""
        return pow(self.generator, (self.modulus - 1) >> self.two_adicity, self.modulus)

    @functools.cached_property
    def montgomery_r(self) -> int:
        return pow(2, 64 * self.u64_limbs, self.modulus)

    @functools.cached_property
    def montgomery_r_inv(self) -> int:
        return pow(self.montgomery_r, self.modulus - 2, self.modulus)

    # ---- host scalar arithmetic ------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def neg(self, a: int) -> int:
        return (-a) % self.modulus

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, self.modulus - 2, self.modulus)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def nth_root_of_unity(self, n: int) -> int:
        assert n & (n - 1) == 0, "n must be a power of two"
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, f"no order-{n} subgroup in {self.name}"
        return pow(self.root_of_unity, 1 << (self.two_adicity - log_n), self.modulus)

    # ---- canonical representation ----------------------------------------
    def to_repr(self, a: int) -> bytes:
        assert 0 <= a < self.modulus
        if self.endianness == "little":
            return a.to_bytes(self.repr_bytes, "little")
        # big endianness (ft253_192): big-endian bytes of the whole value
        return a.to_bytes(self.repr_bytes, "big")

    def from_repr(self, data: bytes) -> int:
        assert len(data) == self.repr_bytes
        v = int.from_bytes(data, self.endianness)
        if v >= self.modulus:
            raise ValueError("non-canonical field repr")
        return v

    # ---- data packing (DataField semantics) ------------------------------
    def from_data_bytes(self, chunk: bytes) -> int:
        """Map <= DATA_BYTE_CAPACITY data bytes to a field element.

        The reference writes the data bytes directly into the internal
        (Montgomery) u64 repr (writable_ft63.rs:36-41, ft253_192.rs:20-31).
        For ft253_192 that can produce reprs >= p (arithmetic-unsafe; data
        would corrupt through encode/decode).  We use the canonical-value
        interpretation instead: an equivalent lossless bijection with
        value < 2^(8*cap) < p, so data survives arithmetic round trips.
        """
        assert len(chunk) <= self.data_byte_capacity
        padded = chunk.ljust(self.data_byte_capacity, b"\x00")
        return int.from_bytes(padded, self.endianness)

    def to_data_bytes(self, a: int) -> bytes:
        cap = self.data_byte_capacity
        if self.endianness == "little":
            return a.to_bytes(self.repr_bytes, "little")[:cap]
        return a.to_bytes(self.repr_bytes, "big")[self.repr_bytes - cap:]

    # ---- ff_derive-compatible random sampling ----------------------------
    def random(self, rng) -> int:
        """One field element; consumes u64 draws exactly like ff_derive."""
        limbs = self.u64_limbs
        shave = 64 * limbs - self.num_bits
        mask = (1 << (64 * limbs)) - 1 if shave == 0 else (1 << (64 * limbs - shave)) - 1
        while True:
            v = 0
            for i in range(limbs):
                v |= rng.next_u64() << (64 * i)
            v &= mask
            if v < self.modulus:
                # drawn integer is the Montgomery repr; value = v * R^-1
                return (v * self.montgomery_r_inv) % self.modulus

    def random_vec(self, rng, n: int) -> list[int]:
        return [self.random(rng) for _ in range(n)]

    def random_nonzero(self, rng) -> int:
        while True:
            v = self.random(rng)
            if v != 0:
                return v


# --------------------------------------------------------------------------
# Field presets (moduli/generators from the reference crates)
# --------------------------------------------------------------------------

FT63 = FieldSpec("ft63", 5102708120182849537, 10)
FT127 = FieldSpec("ft127", 146823888364060453008360742206866194433, 3)
FT191 = FieldSpec(
    "ft191", 1697146272512170708389931801544665676545308500647389167617, 5)
FT255 = FieldSpec(
    "ft255",
    46242760681095663677370860714659204618859642560429202607213929836750194081793,
    5,
)
# proof-of-storage fields
WRITEABLE_FT63 = FieldSpec("writeable_ft63", 5102708120182849537, 10)
FT253_192 = FieldSpec(
    "ft253_192",
    14474011154664524421669271390699307717822958659997404088829842556525106692097,
    3,
    endianness="big",
)

FIELDS = {f.name: f for f in [FT63, FT127, FT191, FT255, WRITEABLE_FT63, FT253_192]}


# --------------------------------------------------------------------------
# numpy batch conversions between python ints and 16-bit limb arrays
# --------------------------------------------------------------------------

def ints_to_limbs(values, spec: FieldSpec) -> np.ndarray:
    """list[int] -> (n, L) uint32 array of 16-bit limbs (little-endian limbs).

    Serializes via int.to_bytes + one numpy unpack (~20x faster than
    per-limb shifting for L=16)."""
    L = spec.num_limbs16
    w = 2 * L
    buf = b"".join(v.to_bytes(w, "little") for v in values)
    if not values:
        return np.empty((0, L), dtype=np.uint32)
    le = np.frombuffer(buf, np.uint8).reshape(len(values), w)
    return (le[:, 0::2].astype(np.uint32)
            | (le[:, 1::2].astype(np.uint32) << 8))


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    """(..., L) limb array -> flat list of python ints (C-order).

    Packs limbs to little-endian bytes once and uses int.from_bytes per
    element (~20x faster than per-limb shifting for L=16)."""
    a = np.asarray(arr, dtype=np.uint32).reshape(-1, arr.shape[-1])
    n, L = a.shape
    le = np.empty((n, 2 * L), dtype=np.uint8)
    le[:, 0::2] = a & 0xFF
    le[:, 1::2] = (a >> 8) & 0xFF
    buf = le.tobytes()
    w = 2 * L
    return [int.from_bytes(buf[i * w : (i + 1) * w], "little") for i in range(n)]
