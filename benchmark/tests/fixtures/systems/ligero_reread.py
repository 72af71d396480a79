"""A test fixture: a system file that brings a call of its own.  Ligero is
called as ``systems/ligero.py`` calls it, and ``reread`` reads the standing
commitment's root again."""

from lcbench.harness import Program as _Program
from systems.ligero import COEFF_DTYPE, commit, encoding  # noqa: F401


class Program(_Program):
    NEEDS = dict(_Program.NEEDS, reread="commit")

    def call_reread(self, loop, rec):
        rec["reread"] = loop.timed("reread", lambda: self.comm.get_root().root)
