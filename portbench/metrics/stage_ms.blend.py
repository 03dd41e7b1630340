"""Device milliseconds a panorama of the stage ``pair.blend``: its
boundaries in the replayed program, summed over its stretches and the
pairs of a panorama (``portbench/spans.py``)."""

from portbench.spans import stage_ms


def read(run):
    return stage_ms(run, "blend")
