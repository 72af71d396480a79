"""A test fixture: proofs of the window over its commits."""


def read(run):
    commits = len(run.durations("commit"))
    return len(run.durations("prove")) / commits if commits else None
