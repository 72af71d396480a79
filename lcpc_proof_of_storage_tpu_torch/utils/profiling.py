"""Phase spans: wall time per (actor, bottleneck) phase.

Counterpart of the phase spans of ``lcpc_proof_of_storage_tpu/utils/
profiling.py`` (the reference client's ``benchmark{bottleneck=disk|cpu|
network}`` spans, networking/client.rs:61-81).  The server wraps each
handler in one, the client its disk, cpu and network legs, and the CLI
prints the report with ``-vv``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class PhaseRecorder:
    """Accumulates wall time per (actor, bottleneck) phase."""

    def __init__(self):
        self.totals: dict[tuple[str, str], float] = defaultdict(float)
        self.counts: dict[tuple[str, str], int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, bottleneck: str, actor: str = "client"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[(actor, bottleneck)] += dt
            self.counts[(actor, bottleneck)] += 1

    def report(self) -> dict:
        return {
            f"{actor}/{bottleneck}": {
                "seconds": round(t, 4),
                "count": self.counts[(actor, bottleneck)],
            }
            for (actor, bottleneck), t in sorted(self.totals.items())
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


GLOBAL_PHASES = PhaseRecorder()
phase = GLOBAL_PHASES.phase
