"""Whether a run's outputs are right: the program's answers against the
plain reference (``reference/``), after the window has closed.

Numbers compared, each against its limit (every comparison is exact, so
every limit is 0):

- ``noncanonical``: values of the last commitment's encoded matrix that are
  not canonical (>= p): its reprs are what the root binds;
- ``codeword_cols_wrong``: columns c where sum_i r_i M[i, c] of that matrix
  differs from the reference's encoding of sum_i r_i C[i] (r drawn from the
  seed, C the benchmark's coefficients): zero for every r only if every row
  of M is the codeword of its row of C (a wrong matrix passes with
  probability about 1/p);
- ``roots_wrong``: roots of the windows, and of a commitment the traffic's
  set-up made, that differ from the reference's Merkle root over that matrix
  (every commit of a run commits the same coefficients, so every root is
  compared);
- ``proof_bytes_wrong``: bytes of one proof of the window, the cycle drawn
  from the seed before the window, that differ from the reference's proof
  (the collapsed rows, the opened columns and their paths, from the
  reference's root), the length difference included.  The reference replays
  the prover's transcript over the proof's own rows and writes its own rows
  into the bytes it compares, so a row that differs shows there and every
  challenge after it is the one the reference's rows give;
- ``evals_wrong``: evaluations returned by the window's verify calls, four
  drawn from the seed after the window, that differ from the coefficient
  polynomial at their points.
"""

from __future__ import annotations

import random
import sys
import time

from reference import blake3, proof as proof_ref
from reference.field import combine_rows, noncanonical, row_dots


EVALS_CHECKED = 4


def judge(program, ref, cycles: list[dict], seed: int) -> list[tuple[str, int, int]]:
    """`cycles`: what the traffic's set-up made, then the windows' cycles."""
    clock = _Clock()
    field = program.field
    rng = random.Random(seed * 3 + 7)
    kept = program.kept_matrix()
    coeffs = program.coeff_matrix()
    n_rows, n_per_row, _ = coeffs.shape
    out = [("noncanonical", noncanonical(kept, field), 0)]
    clock.lap("noncanonical")
    weights = [rng.randrange(field.modulus) for _ in range(n_rows)]
    lhs = combine_rows(weights, kept, field)
    clock.lap("combination of the encoded rows")
    rhs = ref.encode_row(combine_rows(weights, coeffs, field))
    clock.lap("reference encoding of the combined row")
    out.append(("codeword_cols_wrong",
                sum(a != b for a, b in zip(lhs, rhs)) + abs(len(lhs) - len(rhs)), 0))
    levels = blake3.merkle_levels(blake3.column_leaves(kept, field.repr_bytes))
    root = blake3.digest_bytes(levels[-1][0])
    clock.lap("leaves and Merkle tree")
    roots = [c["root"] for c in cycles if "root" in c]
    out.append(("roots_wrong", sum(r != root for r in roots), 0))

    checked = [c for c in cycles if c.get("proof") is not None]
    if checked:
        pick = checked[0]
        got = program.proof_bytes(pick["proof"])
        # the transcript over the proof's own rows; the bytes compared hold
        # the reference's rows, so a row that differs shows there
        rows, p_eval = proof_ref.proof_rows(got, field.repr_bytes)
        seeds, cols = proof_ref.replay(program.transcript_label, root, rows, p_eval,
                                       kept.shape[1], ref.n_col_opens, field.repr_bytes)
        outer, _ = proof_ref.point_tensors(pick["x"], n_rows, n_per_row, field)
        want = proof_ref.prove_bytes(coeffs, kept, levels, outer, seeds, cols, field)[0]
        out.append(("proof_bytes_wrong",
                    sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want)), 0))
        clock.lap("transcript replay and reference proof")
    verified = [c for c in cycles if "value" in c]
    if verified:
        verified = rng.sample(verified, min(EVALS_CHECKED, len(verified)))
        inners, outers = [], []
        for c in verified:
            o, i = proof_ref.point_tensors(c["x"], n_rows, n_per_row, field)
            outers.append(o)
            inners.append(i)
        dots = row_dots(coeffs, inners, field)
        wrong = 0
        for c, o, z in zip(verified, outers, dots):
            wrong += c["value"] != sum(a * b for a, b in zip(o, z)) % field.modulus
        out.append(("evals_wrong", wrong, 0))
        clock.lap(f"{len(verified)} evaluations")
    clock.report()
    return out


class _Clock:
    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.laps = []

    def lap(self, what: str) -> None:
        now = time.perf_counter()
        self.laps.append(f"{what} {now - self.t:.1f}")
        self.t = now

    def report(self) -> None:
        print(f"reference check: {time.perf_counter() - self.t0:.1f} s ("
              + ", ".join(self.laps) + ")", file=sys.stderr)
