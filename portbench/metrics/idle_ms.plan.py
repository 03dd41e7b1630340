"""Milliseconds a panorama in which the device idled while the host's
innermost span was ``plan``, the host's stretches in the profiler's own
work left out (``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "plan")
