"""The 95th percentile of every stitch's latency in the window, each
from its call to its device sync."""

from portbench.window import percentile


def read(run):
    return percentile(run.window.latencies, 95)
