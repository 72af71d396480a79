"""Share of the time inside the window's prove calls in which no kernel,
copy or memset ran, in %."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    idle = run.trace.idle_share_in("bench.prove")
    return None if idle is None else 100.0 * idle
