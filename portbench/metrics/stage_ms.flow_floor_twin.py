"""Device milliseconds a panorama of the stage ``pair.flow_floor_twin``
(the ``_fast`` presets' init-floor twin solve): its boundaries in the
replayed program, summed over the pairs of a panorama
(``portbench/spans.py``).

It departs from ``spans.stage_ms``, which reads a stage missing from the
replay as 0.0, in one point: here a missing stage reads None, so the line
of a port that solves the twin inside ``pair.flow_coarsest`` leaves the
metric out instead of reporting a twin that took no time.  A shared rule
would be an optional default of ``spans.stage_ms``."""

from portbench.spans import measured

STAGE = "flow_floor_twin"


def read(run):
    s = measured(run)
    if s is None or s.stage_ms is None or STAGE not in s.stage_ms:
        return None
    return s.stage_ms[STAGE]
