"""Device kernels a commit in the Ligero commit cell (lcbench/readers.py
kernels_per_commit)."""

from lcbench.readers import kernels_per_commit as read  # noqa: F401
