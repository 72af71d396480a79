"""What several metrics' readers compute alike: a metric that two cells
report under two names (one a cell family's end-to-end metric moves) reads
through one function here."""

from __future__ import annotations

from . import costs


def commit_rate(run) -> float | None:
    """Coefficients committed per second: every commit of the window (a
    commit counts once its root is in host memory), over the window's whole
    length."""
    n = len(run.durations("commit"))
    return n * run.coeffs_per_commit / run.window_s if n else None


def blake3_share(run) -> float | None:
    """The BLAKE3 kernels' share of their bound, in %: every commit's column
    hash (the streamed commit's chunk CVs and merge, or the one-shot leaves)
    and Merkle tree at the frozen cost functions' least time, over the
    profiler's device time of the ``blake3_*`` kernels."""
    if run.trace is None:
        return None
    t, _ = run.trace.kernel_seconds("blake3_leaves", "blake3_chunk_cvs", "blake3_merge_cvs",
                                    "blake3_tree")
    commits = len(run.durations("commit"))
    if not t or not commits:
        return None
    n_rows, _, n_cols = run.dims
    W = run.repr_bytes
    np2 = 1 << (n_cols - 1).bit_length()
    chunks = -(-(32 + n_rows * W) // 1024)
    if run.config.get("commit_entry") == "commit_streamed" and chunks > 1:
        parts = [costs.chunk_cvs_cost(n_rows, n_cols, W), costs.merge_cvs_cost(n_cols, chunks)]
    else:
        parts = [costs.hash_columns_cost(n_rows, n_cols, W)]
    bound, _ = costs.sum_bounds(parts + [costs.merkle_tree_cost(np2)])
    return 100.0 * bound * commits / t


def kernels_per_commit(run) -> float | None:
    """Device kernels the profiler recorded in the window, over the window's
    commits (copies and memsets not counted)."""
    commits = len(run.durations("commit"))
    if run.trace is None or not commits or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / commits


def idle_pct(run) -> float | None:
    """Share of the traced window in which no kernel, copy or memset ran, in %."""
    if run.trace is None or not run.trace.window_s or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
