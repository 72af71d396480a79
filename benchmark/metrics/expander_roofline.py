"""K5's share of its bound in the window: the least time of every commit's
expander levels (the frozen ``expander_cost`` over the code's levels: each
level's rows, columns and nonzeros from the reference's dimensions) over
the profiler's device time of the ``expander_matvec`` kernels."""

from lcbench import costs


def read(run):
    if run.trace is None or run.config["system"] != "brakedown":
        return None
    t, _ = run.trace.kernel_seconds("expander_matvec")
    commits = len(run.durations("commit"))
    if not t or not commits:
        return None
    pre, post = run.ref.levels
    levels = [(m, n, n * d) for n, m, d in pre + post]
    bound, _ = costs.expander_cost(run.dims[0], levels, run.limbs).bound_s()
    return 100.0 * bound * commits / t
