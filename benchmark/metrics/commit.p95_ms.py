"""The 95th percentile of the window's commit latencies, from the call until
the root is in host memory, in ms.  Its source is the host's clock, so the
traced run reads it from its untraced window; a per-layer reading, as the
runs' tail spreads too far between runs to bound it (PERF.md)."""

import statistics


def read(run):
    lat = run.durations("commit")
    if len(lat) < 200:          # fewer than ten samples above the percentile
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
