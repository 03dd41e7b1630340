"""
One reader a metric, named as the metric is in BENCHMARK.json: a module
with read(run) that returns the metric's value, or None where the run
has nothing for it to read (the metric is then left out of the result).
run is portbench.harness.Run: the window, set-up seconds, the traced
segment (None without --trace 1), the cell's traffic and configuration
files, the seed and the device.
"""
