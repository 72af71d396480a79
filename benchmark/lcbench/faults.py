"""Broken versions of the timed path, for the control and the fault tests.

Each fault wraps an entry point of the program set up by the harness, in
the process that runs the cell, so that everything else of a run (the
window, the reference, the comparison) is the same as in a sound run:

- ``lazy_reduction`` (the control): the encoding's codewords left
  unreduced where a kernel that skips its last conditional subtraction of p
  would leave them, so some values are v + p, the same residue with another
  repr (the configuration guarantees canonical reprs);
- ``half_rows``: each encode leaves out the second half of its rows (they
  come back as zeros);
- ``altered_value``: one limb of one value of each encode altered where it
  is produced;
- ``altered_proof``: the first value of each proof's p_eval altered;
- ``altered_eval``: each verify's returned evaluation altered.
"""

from __future__ import annotations

import torch


def _lazy(out: torch.Tensor, modulus: int) -> torch.Tensor:
    """v + p where that stays below 2^(16 L) and v's lowest bit is set."""
    L = out.shape[-1]
    x = out.to(torch.int64) & 0xFFFF
    p = [(modulus >> (16 * j)) & 0xFFFF for j in range(L)]
    s = torch.empty_like(x)
    carry = torch.zeros_like(x[..., 0])
    for j in range(L):
        t = x[..., j] + p[j] + carry
        s[..., j] = t & 0xFFFF
        carry = t >> 16
    pick = (carry == 0) & ((x[..., 0] & 1) == 1)
    y = torch.where(pick[..., None], s, x)
    return y.to(out.dtype) if out.dtype == torch.int32 else (y - ((y >> 15) << 16)).to(out.dtype)


def apply(name: str, program) -> None:
    enc = program.enc
    encode = enc.encode
    modulus = program.spec.modulus
    if name == "lazy_reduction":
        enc.encode = lambda rows, *a, **k: _lazy(encode(rows, *a, **k), modulus)
    elif name == "half_rows":
        def half(rows, *a, **k):
            out = encode(rows, *a, **k)
            out[out.shape[0] // 2 + out.shape[0] % 2:] = 0
            return out
        enc.encode = half
    elif name == "altered_value":
        def altered(rows, *a, **k):
            out = encode(rows, *a, **k)
            out[0, 0, 0] ^= 1
            return out
        enc.encode = altered
    elif name == "altered_proof":
        prove = program.prove

        def bad_prove(root, outer):
            proof = prove(root, outer)
            limbs = proof.p_eval._limbs
            limbs[0, 0] ^= 1
            proof.p_eval[0] ^= 1
            return proof
        program.prove = bad_prove
    elif name == "altered_eval":
        verify = program.verify
        program.verify = lambda *a: (verify(*a) + 1) % modulus
    else:
        raise ValueError(f"no fault {name!r}")


FAULTS = ("lazy_reduction", "half_rows", "altered_value", "altered_proof", "altered_eval")
