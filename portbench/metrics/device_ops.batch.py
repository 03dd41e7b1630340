"""Device operations (kernels, copies, fills) a panorama in the traced
calls."""

from portbench.devtrace import ops_per_panorama as read  # noqa: F401
