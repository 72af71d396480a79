"""K3's share of its bound in the window: each proof's collapse of the
degree-test rows and the evaluation row together (the frozen
``collapse_cost``, T = n_degree_tests + 1, the coefficients as the commitment
keeps them) over the profiler's device time of the ``collapse`` kernels."""

from lcbench import costs


def read(run):
    if run.trace is None:
        return None
    t, _ = run.trace.kernel_seconds("collapse")
    proofs = len(run.durations("prove"))
    if not t or not proofs:
        return None
    n_rows, n_per_row, _ = run.dims
    T = run.ref.n_degree_tests + 1
    bound, _ = costs.collapse_cost(n_rows, n_per_row, run.limbs, T, run.coeff_bits).bound_s()
    return 100.0 * bound * proofs / t
