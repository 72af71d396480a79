"""All time spent in verify over all verifications of the window, in ms a
verification."""


def read(run):
    d = run.durations("verify")
    return sum(d) / len(d) * 1e3 if d else None
