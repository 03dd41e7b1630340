"""Device milliseconds (the sum over all device operations) a panorama in
the traced calls."""

from portbench.devtrace import device_ms_per_panorama as read  # noqa: F401
