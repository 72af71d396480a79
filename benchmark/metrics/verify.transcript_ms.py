"""The program's ``verify/transcript`` phase span (core/commit.py verify:
the challenges drawn and both rows appended to the transcript), its seconds
over its count in the window, in ms."""


def read(run):
    t, n = run.phases.get("verify/transcript", (0.0, 0))
    return t / n * 1e3 if n else None
