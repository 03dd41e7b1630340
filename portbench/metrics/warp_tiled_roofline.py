"""The port's warp_tiled kernel at the cell's finest kernel level (the
configuration's roofline_planes), timed from the profiler's trace: its
share of the roofline, in percent."""

from portbench.roofline import cell_share


def read(run):
    return cell_share(run, "warp_tiled")
