"""The device's idle share of the window in the Brakedown commit cell
(lcbench/readers.py idle_pct)."""

from lcbench.readers import idle_pct as read  # noqa: F401
