"""Percent of the traced calls' window in which no operation ran on the
device, the stretches in which the device idled for the profiler's own
host work left out."""

from portbench.devtrace import idle_share as read  # noqa: F401
