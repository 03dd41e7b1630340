"""Milliseconds a panorama in which the device idled while the host's
innermost span was ``program.replay`` (copy-in, the graph's launch,
copy-out), the host's stretches in the profiler's own work left out
(``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(run):
    return idle_ms(run, "program.replay")
