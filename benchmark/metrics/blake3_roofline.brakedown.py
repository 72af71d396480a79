"""The BLAKE3 kernels' share of their bound in the Brakedown commit cell
(lcbench/readers.py blake3_share)."""

from lcbench.readers import blake3_share as read  # noqa: F401
