"""The benchmark's reduction of the port's spans (``portbench/spans.py``)
on synthetic profiler events and a synthetic recording: a replay's
stages anchored to the first device operation of its graph launch (not
to the copy-in before it), each device operation put down to the range
where the host launched it, idle device time put down to the innermost
``panostitch.`` range with the profiler's own host work left out, the
per-panorama stage, plan and sync readings, and the readers by name."""

import pytest

from panorama_opticalflow_tpu_torch.utils import trace
from portbench import harness, spans


class Ev:
    def __init__(self, name, start_ns, end_ns, device=False, corr=0):
        self._name, self._s, self._e = name, start_ns, end_ns
        self._dev, self._corr = device, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._name.startswith("panostitch.")


def _dev(name, s, e, corr):
    return Ev(name, s, e, device=True, corr=corr)


def _events():
    return [
        Ev("panostitch.stitch.four", 0, 1000),
        Ev("panostitch.plan", 50, 150),
        Ev("cudaLaunchKernel", 90, 95, corr=3),
        _dev("any", 100, 120, 3),
        # the profiler's own work inside the plan: 20 of its 30 idle
        Ev("Buffer Flush", 80, 110),
        Ev("panostitch.program.replay", 200, 400),
        Ev("cudaMemcpyAsync", 205, 208, corr=5),
        Ev("cudaMemcpyAsync", 390, 395, corr=8),
        _dev("Memcpy DtoD", 210, 260, 5),                 # the copy-in
        Ev("panostitch.inner", 260, 300),                 # 40 idle
        Ev("cudaGraphLaunch", 300, 380, corr=7),
        _dev("add", 300, 350, 7), _dev("mul", 360, 500, 7),
        _dev("relax", 520, 700, 7),
        _dev("Memcpy DtoD", 700, 720, 8),                 # the copy-out
        # the device's side of a range is no device work
        _dev("panostitch.program.replay", 200, 720, 0),
    ]


def test_stages_are_anchored_to_the_graph_launchs_first_operation():
    assert spans.anchors(_events()) == [300]
    rec = trace.Recording(replays=[trace.Replay(
        "_stitch_pair_windowed_body", 0,
        [("pair.blend", 0.0, 1e-4), ("pair.composite", 1e-4, 4e-4)])])
    got = spans.reduce(_events(), rec, rec, panoramas=1)
    # blend [300, 400): add and mul; composite [400, 700): relax
    assert got.top_ops["blend"] == [["mul", pytest.approx(140e-6)],
                                    ["add", pytest.approx(50e-6)]]
    assert got.top_ops["composite"] == [["relax", pytest.approx(180e-6)]]
    assert got.stage_ms == pytest.approx({"blend": 1e-4,
                                          "composite": 3e-4})
    assert got.coverage == pytest.approx(1.0)
    # each operation by the range where the host launched it
    assert got.launched == pytest.approx({
        "plan": 20e-6, "program.replay": 70e-6, "graph": 370e-6})
    # a launch the profile links to no device operation
    events = [e for e in _events() if e.correlation_id() != 7]
    assert spans.anchors(events) == [None]


def test_idle_goes_to_the_innermost_range_less_the_profilers_work():
    got = spans.idle_ns(_events(), ("plan", "program.replay", "inner",
                                    "stitch.four"))
    # plan: 100 long, 20 busy, 20 of its idle in the flush
    assert got["plan"] == 60
    # replay: 200 long, 140 busy (copy-in 50, add 50, mul 40), the inner
    # range's 40 idle its own
    assert got["program.replay"] == 20
    assert got["inner"] == 40
    # the root: its idle outside its children, 0-50, 150-200 and the
    # 300 of 400-1000 that no operation covers
    assert got["stitch.four"] == 50 + 50 + 300
    assert spans.idle_ns([Ev("panostitch.plan", 0, 10)], ("plan",)) is None


def test_per_panorama_readings_and_the_readers():
    rec = trace.Recording(
        spans=[trace.Span("stitch.six", 0, 9_000_000),
               trace.Span("plan", 1_000_000, 3_000_000, parent=0),
               trace.Span("stitch.six", 9_000_000, 20_000_000, call=1),
               trace.Span("plan", 9_000_000, 13_000_000, parent=2, call=1)],
        replays=[trace.Replay("_chain_body", c,
                              [("pair.blend", 0.0, 2.0),
                               ("pair.flow_prep", 2.0, 3.0),
                               ("pair.blend", 3.0, 5.0),
                               ("pair.flow_prep", 5.5, 6.0)])
                 for c in (0, 1)],
        host_syncs=2)
    got = spans.reduce(_events(), rec, trace.Recording(), panoramas=2)
    assert got.plan_ms == pytest.approx(3.0)
    assert got.host_syncs == 1.0
    assert got.stage_ms == pytest.approx({"blend": 4.0, "flow_prep": 1.5})
    assert got.coverage == pytest.approx(5.5 / 6.0)
    assert got.idle_ms["plan"] == pytest.approx(30e-6)
    run = harness.Run(None, 0.0, None, {}, {}, 0, None)
    run.port_spans = got
    read = {name: harness.load_reader(name)(run) for name in (
        "stage_ms.blend", "stage_ms.flow_prep", "stage_ms.flow_coarsest",
        "stage_ms.flow_plain_levels", "stage_ms.flow_kernel_levels",
        "stage_ms.novel_view", "stage_ms.composite", "plan_ms",
        "idle_ms.plan", "idle_ms.replay", "host_syncs.stitch")}
    assert read == pytest.approx({
        "stage_ms.blend": 4.0, "stage_ms.flow_prep": 1.5,
        "stage_ms.flow_coarsest": 0.0, "stage_ms.flow_plain_levels": 0.0,
        "stage_ms.flow_kernel_levels": 0.0, "stage_ms.novel_view": 0.0,
        "stage_ms.composite": 0.0, "plan_ms": 3.0, "idle_ms.plan": 30e-6,
        "idle_ms.replay": 10e-6, "host_syncs.stitch": 1.0})
    # a checkout whose port has no tracer, or a run without replays
    run.port_spans = None
    assert harness.load_reader("stage_ms.blend")(run) is None
    assert harness.load_reader("plan_ms")(run) is None
    run.port_spans = spans.Spans(1, None, 1.0, None, 1.0)
    assert harness.load_reader("stage_ms.blend")(run) is None
    assert harness.load_reader("idle_ms.plan")(run) is None


def test_the_floor_twin_reader_reads_its_stage_or_none():
    """``stage_ms.flow_floor_twin`` reads the twin's stage where the
    replays have it, and None where they do not (a port that solves the
    twin inside ``pair.flow_coarsest``, or a preset without a twin), so
    that the result line leaves it out there."""
    def replays(stages):
        return [trace.Replay("_chain_body", 0, stages)]

    read = harness.load_reader("stage_ms.flow_floor_twin")
    run = harness.Run(None, 0.0, None, {}, {}, 0, None)
    rec = trace.Recording(replays=replays([
        ("pair.flow_prep", 0.0, 1.0), ("pair.flow_floor_twin", 1.0, 1.25),
        ("pair.flow_coarsest", 1.25, 2.0), ("pair.flow_prep", 2.0, 2.5),
        ("pair.flow_floor_twin", 2.5, 2.75),
        ("pair.flow_coarsest", 2.75, 3.0)]))
    run.port_spans = spans.reduce([], rec, trace.Recording(), panoramas=1)
    assert read(run) == pytest.approx(0.5)
    assert harness.load_reader("stage_ms.flow_coarsest")(run) == \
        pytest.approx(1.0)
    rec = trace.Recording(replays=replays([
        ("pair.flow_prep", 0.0, 1.0), ("pair.flow_coarsest", 1.0, 2.0)]))
    run.port_spans = spans.reduce([], rec, trace.Recording(), panoramas=1)
    assert read(run) is None
    run.port_spans = None
    assert read(run) is None


def test_the_search_init_reader_reads_its_stage_or_none():
    """``stage_ms.flow_search_init`` reads the search's stage, summed over
    its stretches (a twin split by it, or a chain's pairs), and None where
    no replay has it (a port that searches inside ``pair.flow_coarsest``,
    or a preset without the search)."""
    read = harness.load_reader("stage_ms.flow_search_init")
    run = harness.Run(None, 0.0, None, {}, {}, 0, None)
    rec = trace.Recording(replays=[trace.Replay("_chain_body", 0, [
        ("pair.flow_prep", 0.0, 1.0), ("pair.flow_search_init", 1.0, 1.25),
        ("pair.flow_coarsest", 1.25, 2.0),
        ("pair.flow_search_init", 2.0, 2.5)])])
    run.port_spans = spans.reduce([], rec, trace.Recording(), panoramas=1)
    assert read(run) == pytest.approx(0.75)
    rec = trace.Recording(replays=[trace.Replay("_chain_body", 0, [
        ("pair.flow_prep", 0.0, 1.0), ("pair.flow_coarsest", 1.0, 2.0)])])
    run.port_spans = spans.reduce([], rec, trace.Recording(), panoramas=1)
    assert read(run) is None
    run.port_spans = None
    assert read(run) is None


@pytest.mark.parametrize("cell,maps", [("six_search20.repeat", 190.0),
                                       ("six_low.repeat", 0.0)])
def test_the_search_maps_reader_counts_one_recorded_call(cell, maps,
                                                         monkeypatch):
    """``search_maps.stitch`` makes one call of the cell's driver on the
    run's first input set under a recording (on the CPU at a small canvas):
    19 maps a direction of the chain's 5 pairs under the search preset,
    none without it, and None on a port whose tracer has no such
    counter."""
    import dataclasses

    import torch

    c = harness.load_cell(cell)
    c.config["canvas"] = [128, 448]
    run = harness.Run(None, 0.0, None, c.traffic, c.config, 2**40 + 5,
                      torch.device("cpu"))
    read = harness.load_reader("search_maps.stitch")
    assert read(run) == maps

    @dataclasses.dataclass
    class Older:
        host_syncs: int = 0

    monkeypatch.setattr(trace, "Recording", Older)
    assert read(run) is None
