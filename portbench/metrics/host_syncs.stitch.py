"""The points a panorama at which the port's host waited for the device
(the tracer's ``host_syncs``; ``portbench/spans.py``)."""

from portbench.spans import host_syncs as read  # noqa: F401
