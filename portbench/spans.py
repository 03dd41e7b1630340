"""The port's own spans in a traced run (its tracer,
``panorama_opticalflow_tpu_torch.utils.trace``).

Once a run, the first reader makes the cell's input pool again from the
seed and runs the cell's ``traced_calls`` calls twice, each call ended by
a device sync, with the tracer recording: first as the window runs them,
then under ``torch.profiler``.  The calls replay the programs the window
used: nothing is captured again.  The reduction gives, a panorama:

* from the first pass, each stage's device milliseconds: the boundaries
  of the ``pair.*`` stage spans that a captured program replays, summed
  over the stretches of a stage and the pairs of a panorama; the plan's
  host milliseconds (the span ``plan``); the host's waits on the device
  (the tracer's ``host_syncs``);
* from the profiled pass, the device's idle milliseconds while the host's
  innermost span is ``plan`` or ``program.replay``, the stretches in
  which the host was in the profiler's own work left out, as
  ``devtrace`` leaves them out.

The stages are timed without the profiler because its buffer flushes
stall a replay part way through its graph, and a stage's boundaries
would count the stall; the profiled pass profiles each call on its own,
so that no call waits while the profiler drains the records of the call
before it (on an H100 a 2-3 ms plan of the six-photo chain took 52.6 ms
so).  It places each replay's
boundaries on the profile's clock by anchoring its first boundary to the
first device operation of the replay's graph launch (the launch's
correlation id); each stage's top device operations, so placed, go to
standard error with the stages' share of the replays' device spans.  On
a checkout whose port has no tracer every reader reads None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
from collections import defaultdict

import numpy as np

from portbench.devtrace import PROFILER_HOST, _busy_before, _span, _union

PREFIX = "panostitch."
STAGE = "pair."
TOP = 5


@dataclasses.dataclass
class Spans:
    panoramas: int
    # stage (without "pair.") -> device ms a panorama; None: no replay
    stage_ms: dict | None
    plan_ms: float
    # span name -> idle device ms a panorama; None: no device operation
    idle_ms: dict | None
    host_syncs: float
    # the stages' device ms over the replays' device spans (first
    # boundary to last)
    coverage: float | None = None
    # stage -> [[operation, device ms a panorama], ...] by anchored time
    top_ops: dict = dataclasses.field(default_factory=dict)
    # device ms a panorama by the span that launched each operation
    launched: dict = dataclasses.field(default_factory=dict)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _is_annotation(e) -> bool:
    name = e.name()
    return name.startswith((PREFIX, "portbench.")) or (
        hasattr(e, "is_user_annotation") and e.is_user_annotation())


def _idle(bs, be, s: int, e: int) -> int:
    """Idle nanoseconds in [s, e] beside the merged busy (bs, be)."""
    if bs is None:
        return e - s
    busy = _busy_before(bs, be, np.asarray([s, e]))
    return int((e - s) - (busy[1] - busy[0]))


def idle_ns(events, names) -> dict[str, int] | None:
    """Nanoseconds the device idled while the host's innermost
    ``panostitch.`` range was one of ``names``, leaving out the stretches
    in which the host was in the profiler's own work; None where no
    device operation ran."""
    ranges, own, dev = [], [], []
    for e in events:
        if _is_device(e):
            if not _is_annotation(e):
                dev.append(_span(e))
        elif e.name().startswith(PREFIX):
            ranges.append((e.name()[len(PREFIX):], *_span(e)))
        elif e.name() in PROFILER_HOST:
            own.append(_span(e))
    if not dev:
        return None
    d = np.asarray(dev, dtype=np.int64)
    bs, be = _union(d[:, 0], d[:, 1])
    out = {name: 0 for name in names}
    for name, s, e in ranges:
        if name not in out:
            continue
        inner = [(cs, ce) for n, cs, ce in ranges
                 if s <= cs and ce <= e and (cs, ce) != (s, e)]
        inner += [(max(os_, s), min(oe, e)) for os_, oe in own
                  if os_ < e and oe > s]
        idle = _idle(bs, be, s, e)
        if inner:
            c = np.asarray(inner, dtype=np.int64)
            for cs, ce in zip(*_union(c[:, 0], c[:, 1])):
                idle -= _idle(bs, be, int(cs), int(ce))
        out[name] += idle
    return out


def anchors(events) -> list[int | None]:
    """For each ``panostitch.program.replay`` range, in order, the start
    of the first device operation of the graph launched inside it (None
    where the profile links none to the launch)."""
    replays, launches = [], []
    first = {}
    for e in events:
        if _is_device(e):
            if not _is_annotation(e):
                c, s = e.correlation_id(), _span(e)[0]
                first[c] = min(first.get(c, s), s)
        elif e.name() == PREFIX + "program.replay":
            replays.append(_span(e))
        elif e.name().startswith("cudaGraphLaunch"):
            launches.append((_span(e)[0], e.correlation_id()))
    out = []
    for s, e in sorted(replays):
        starts = [first[c] for t, c in launches
                  if s <= t <= e and c in first]
        out.append(min(starts) if starts else None)
    return out


def launched_ms(events, panoramas: int) -> dict[str, float]:
    """Device milliseconds a panorama by the innermost ``panostitch.``
    range open where the host launched each operation (its runtime call's
    correlation id); a graph's operations under ``graph``."""
    ranges, dev, launch = [], [], {}
    for e in events:
        if _is_device(e):
            if not _is_annotation(e):
                dev.append((e.correlation_id(), *_span(e)))
        elif e.name().startswith(PREFIX):
            ranges.append((e.name()[len(PREFIX):], *_span(e)))
        elif e.name().startswith("cuda"):
            launch[e.correlation_id()] = (
                _span(e)[0], e.name().startswith("cudaGraphLaunch"))
    out = defaultdict(int)
    for c, s, t in dev:
        if c not in launch:
            out["not linked"] += t - s
            continue
        at, graph = launch[c]
        inside = [(re - rs, n) for n, rs, re in ranges if rs <= at <= re]
        name = "graph" if graph else min(inside)[1] if inside else "no span"
        out[name] += t - s
    return {k: v / 1e6 / panoramas for k, v in out.items()}


def _top_ops(events, replays, starts, panoramas: int) -> dict:
    """Each stage's top device operations by the time of those that
    start inside its anchored stretches."""
    dev = sorted((_span(e)[0], _span(e)[1], e.name()) for e in events
                 if _is_device(e) and not _is_annotation(e))
    if not dev:
        return {}
    t0 = np.asarray([s for s, _, _ in dev], dtype=np.int64)
    by = defaultdict(lambda: defaultdict(int))
    for replay, anchor in zip(replays, starts):
        if anchor is None:
            continue
        for name, a, b in replay.stages:
            lo = np.searchsorted(t0, anchor + int(a * 1e6))
            hi = np.searchsorted(t0, anchor + int(b * 1e6))
            for s, e, op in dev[lo:hi]:
                by[name[len(STAGE):]][op[:80]] += e - s
    return {stage: [[op, ns / 1e6 / panoramas] for op, ns in
                    sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]]
            for stage, ops in by.items()}


def reduce(events, rec, traced, panoramas: int) -> Spans:
    """The metrics of the tracer's ``Recording`` ``rec`` of calls that
    complete ``panoramas``, and of a profile's ``events`` of the same
    calls with the tracer's ``Recording`` ``traced``."""
    plan = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "plan")
    idle = idle_ns(events, ("plan", "program.replay"))
    out = Spans(panoramas, None, plan / 1e6 / panoramas,
                None if idle is None else
                {k: v / 1e6 / panoramas for k, v in idle.items()},
                rec.host_syncs / panoramas)
    if rec.replays:
        total, spanned, covered = defaultdict(float), 0.0, 0.0
        for r in rec.replays:
            for name, a, b in r.stages:
                total[name[len(STAGE):]] += b - a
                covered += b - a
            spanned += max(b for _, _, b in r.stages)
        out.stage_ms = {k: v / panoramas for k, v in total.items()}
        out.coverage = covered / spanned if spanned > 0 else None
    starts = anchors(events)
    if traced.replays and len(starts) == len(traced.replays):
        out.top_ops = _top_ops(events, traced.replays, starts, panoramas)
    out.launched = launched_ms(events, panoramas)
    return out


def _measure(run) -> Spans | None:
    try:
        from panorama_opticalflow_tpu_torch.utils import trace
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    from panorama_opticalflow_tpu_torch import StitchConfig

    driver = importlib.import_module(
        f"portbench.drivers.{run.traffic['driver']}")
    on_card = run.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(run.device)

    pool = driver.make_pool(run.config, run.traffic, run.seed, run.device)
    items = [pool[k % len(pool)] for k in range(run.traffic["traced_calls"])]
    cfg = StitchConfig(flow_alg=run.config["flow_alg"])
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)

    # a profile a call: a call's profile does not drain the activity
    # records of the call before it
    profiles = []

    def recorded(profiled):
        with trace.recording() as rec:
            for item in items:
                sync()
                with (profile(activities=acts) if profiled
                      else contextlib.nullcontext()) as prof:
                    driver.stitch(item, cfg, run.device)
                    sync()
                profiles.append(prof)
        return rec

    rec = recorded(False)
    traced = recorded(True)
    events = []
    for prof in profiles:
        results = getattr(getattr(prof, "profiler", None), "kineto_results",
                          None)
        if results is not None:
            events.extend(results.events())
    spans = reduce(events, rec, traced,
                   sum(driver.panoramas(item) for item in items))
    plans = [(s.end_ns - s.start_ns) / 1e6 for r in (rec, traced)
             for s in r.spans if s.name == "plan"]
    print(f"port spans: stages {spans.stage_ms} ms a panorama, "
          f"{spans.coverage} of the replays' device spans; plan "
          f"{spans.plan_ms} ms; idle {spans.idle_ms} ms; host syncs "
          f"{spans.host_syncs}; each plan's ms, then profiled {plans}; "
          f"profiled stages {traced.stage_ms() if traced.replays else None}; "
          f"device ms by the span that launched it {spans.launched}; "
          f"top operations by stage {spans.top_ops}",
          file=sys.stderr, flush=True)
    return spans


def measured(run) -> Spans | None:
    """The run's spans, measured by its first reader."""
    if not hasattr(run, "port_spans"):
        run.port_spans = _measure(run)
    return run.port_spans


def stage_ms(run, stage: str) -> float | None:
    s = measured(run)
    if s is None or s.stage_ms is None:
        return None
    return s.stage_ms.get(stage, 0.0)


def plan_ms(run) -> float | None:
    s = measured(run)
    return None if s is None else s.plan_ms


def idle_ms(run, name: str) -> float | None:
    s = measured(run)
    return None if s is None or s.idle_ms is None else s.idle_ms[name]


def host_syncs(run) -> float | None:
    s = measured(run)
    return None if s is None else s.host_syncs
