"""Device milliseconds a panorama of the stage ``pair.flow_search_init``
(the ``pixflow_search_*`` presets' search init): its boundaries in the
replayed program, summed over its stretches and the pairs of a panorama
(``portbench/spans.py``).

As ``stage_ms.flow_floor_twin`` reads its stage, a replay without the
stage reads None, not 0.0: the line of a port that searches inside
``pair.flow_coarsest``, or does not search, leaves the metric out."""

from portbench.spans import measured

STAGE = "flow_search_init"


def read(run):
    s = measured(run)
    if s is None or s.stage_ms is None or STAGE not in s.stage_ms:
        return None
    return s.stage_ms[STAGE]
