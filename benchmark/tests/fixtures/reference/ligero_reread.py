"""A test fixture: the plain reference of ``systems/ligero_reread.py``,
which encodes and commits as Ligero does, and a judge of its own that also
compares each reread root with the root its cycle's commit returned."""

from lcbench import checks

from .ligero import Code  # noqa: F401


def judge(program, ref, cycles, seed):
    differ = sum(c["reread"] != c["root"] for c in cycles if "reread" in c)
    return checks.judge(program, ref, cycles, seed) + [("rereads_differ", differ, 0)]
