"""The program's ``prove/collapse`` phase span (core/commit.py prove: the
challenge rows' and the evaluation's collapse, K3, read back and turned
into Python integers), its seconds over its count in the window, in ms."""


def read(run):
    t, n = run.phases.get("prove/collapse", (0.0, 0))
    return t / n * 1e3 if n else None
