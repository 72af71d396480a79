"""All time spent in prove over all proofs of the window, in ms a proof."""


def read(run):
    d = run.durations("prove")
    return sum(d) / len(d) * 1e3 if d else None
