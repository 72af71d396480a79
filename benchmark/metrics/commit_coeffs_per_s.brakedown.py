"""Coefficients committed per second in the Brakedown commit cell, a host-paced
commit (lcbench/readers.py commit_rate)."""

from lcbench.readers import commit_rate as read  # noqa: F401
