"""Coefficients committed per second in the Ligero commit cell
(lcbench/readers.py commit_rate)."""

from lcbench.readers import commit_rate as read  # noqa: F401
