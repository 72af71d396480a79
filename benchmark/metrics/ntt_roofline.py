"""K1's share of its bound in the window: the least time of the forward
NTTs of every commit's rows (the frozen ``ntt_cost``: n_rows rows of n_cols
values, the stages a zero tail of n_cols - n_per_row values leaves) over
the profiler's device time of the ``ntt_pass`` kernels."""

from lcbench import costs


def read(run):
    if run.trace is None or run.config["system"] != "ligero":
        return None
    t, launches = run.trace.kernel_seconds("ntt_pass")
    commits = len(run.durations("commit"))
    if not t or not commits:
        return None
    n_rows, n_per_row, n_cols = run.dims
    stages = (n_per_row - 1).bit_length()
    bound, _ = costs.ntt_cost(n_rows, n_cols, run.limbs, stages).bound_s()
    return 100.0 * bound * commits / t
