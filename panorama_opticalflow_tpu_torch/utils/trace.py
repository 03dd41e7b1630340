"""The port's tracer: named spans of its work on the host and, for the
stages of a captured body, on the card.

``span(name)`` marks a stretch of the port's work.  While ``recording()``
is open, a span is kept in memory (its name, start and end on
``time.perf_counter_ns``, its parent, and the sequence number of the call
it belongs to: that of the outermost span open) and opens a
``torch.profiler`` range ``panostitch.<name>``, so that a profile puts it
on the clock of the device's operations.  While no recording is open a
span costs a test.

A stage span (``stage=True``) has a device side too.  While a program is
captured (``capturing()``, which ``utils.programs`` opens), it records a
timing event on the capturing stream at its enter and at its exit; the
capture makes each an event-record node of the graph, and the program
keeps them in capture order.  They are captured whether or not a
recording is open, so the graph a traced pass reads is the one every
replay runs.  While a recording is open, a replay's boundary times are
read once the replay has completed: when the next outermost span opens,
before the same program's next replay, or when the recording is read or
closed.  An eager run has no device side: a profile shows its operations
under each stage's range.

The counter ``Recording.host_syncs`` counts, while a recording is open,
the points at which the port's host waits for the device
(``host_sync()``).  The counter ``Recording.search_maps`` counts the SAD
maps the flow's search init scores (``count_search_maps()``); Python
does not run on a replay, so what a capture counts is kept with its
boundaries (``Captured``), and each replay counts it again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

PREFIX = "panostitch."

_recording: Recording | None = None
# the boundaries of the body being captured (None: no capture)
_capture: _Capture | None = None
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int | None = None
    # index of the parent in Recording.spans (None: an outermost span)
    parent: int | None = None
    call: int = 0
    args: str | None = None


@dataclasses.dataclass
class Replay:
    """One replay of a program: its stages in capture order, each (name,
    start ms, end ms) from the replay's first boundary."""
    program: str
    call: int
    stages: list


@dataclasses.dataclass
class Recording:
    """What a ``recording()`` kept: every span in the order it opened,
    every replay's stage times, and the host's waits on the device."""
    spans: list = dataclasses.field(default_factory=list)
    replays: list = dataclasses.field(default_factory=list)
    host_syncs: int = 0
    search_maps: int = 0
    calls: int = 0
    # indices of the open spans, outermost first
    open: list = dataclasses.field(default_factory=list)
    # (program, call, boundaries) of replays not read yet
    pending: list = dataclasses.field(default_factory=list)

    def settle(self, boundaries: list | None = None) -> None:
        """Read the pending replays (of the program that keeps
        ``boundaries`` only, where given), waiting for each to complete."""
        keep = []
        for program, call, b in self.pending:
            if boundaries is None or b is boundaries:
                self.replays.append(_read(program, call, b))
            else:
                keep.append((program, call, b))
        self.pending = keep

    def stage_ms(self) -> dict[str, float]:
        """Each stage's mean device milliseconds a replay, over the
        replays recorded."""
        self.settle()
        total = defaultdict(float)
        for r in self.replays:
            for name, t0, t1 in r.stages:
                total[name] += t1 - t0
        return {name: ms / len(self.replays) for name, ms in total.items()}


class Captured(list):
    """What a program's capture recorded: [name, enter event, exit event]
    a stage span, in capture order, and the counts made while it ran."""

    def __init__(self):
        super().__init__()
        self.search_maps = 0


class _Capture:
    def __init__(self, mark):
        self.mark = mark
        self.boundaries = Captured()


class _Span:
    __slots__ = ("name", "args", "stage", "rec", "index", "profiled",
                 "boundary")

    def __init__(self, name: str, args: str | None, stage: bool):
        self.name, self.args, self.stage = name, args, stage
        self.rec = self.index = self.profiled = self.boundary = None

    def __enter__(self):
        rec = self.rec = _recording
        if rec is not None:
            if rec.open:
                parent = rec.open[-1]
                call = rec.spans[parent].call
            else:
                rec.settle()
                parent, call = None, rec.calls
                rec.calls += 1
            self.index = len(rec.spans)
            rec.spans.append(Span(self.name, time.perf_counter_ns(),
                                  parent=parent, call=call, args=self.args))
            rec.open.append(self.index)
            self.profiled = torch.profiler.record_function(
                PREFIX + self.name, self.args)
            self.profiled.__enter__()
        if self.stage and _capture is not None:
            self.boundary = [self.name, _capture.mark(), None]
            _capture.boundaries.append(self.boundary)
        return self

    def __exit__(self, *exc):
        if self.boundary is not None:
            self.boundary[2] = _capture.mark()
        if self.index is not None:
            self.profiled.__exit__(*exc)
            self.rec.spans[self.index].end_ns = time.perf_counter_ns()
            self.rec.open.pop()
        return False


def span(name: str, args: str | None = None, stage: bool = False):
    """A context that marks ``name``'s stretch of work (``args``, a
    string, goes into the profiler's range); a ``stage`` span also marks
    its boundaries in a captured program."""
    if _recording is None and (_capture is None or not stage):
        return _NULL
    return _Span(name, args, stage)


@contextlib.contextmanager
def recording():
    """Keep every span, replay and host wait while the context is open;
    yields the ``Recording``."""
    global _recording
    outer, _recording = _recording, Recording()
    try:
        yield _recording
        _recording.settle()
    finally:
        _recording = outer


def _event():
    e = torch.cuda.Event(enable_timing=True, external=True)
    e.record()
    return e


@contextlib.contextmanager
def capturing(mark=_event):
    """While a program's body is captured: the stage spans' boundaries,
    each made by ``mark()`` (a timing event recorded on the current
    stream), in capture order, and the counts; yields their
    ``Captured``."""
    global _capture
    outer, _capture = _capture, _Capture(mark)
    try:
        yield _capture.boundaries
    finally:
        _capture = outer


def replayed(program: str, boundaries: Captured) -> None:
    """After a replay of ``program``, whose capture kept ``boundaries``:
    while recording, the capture's counts are counted again and its times
    are read once it has completed."""
    rec = _recording
    if rec is None:
        return
    rec.search_maps += boundaries.search_maps
    if boundaries:
        call = rec.spans[rec.open[0]].call if rec.open else rec.calls
        rec.pending.append((program, call, boundaries))


def settle(boundaries: list) -> None:
    """Before a replay of the program that keeps ``boundaries``: read its
    last replay's times while they are there."""
    if _recording is not None:
        _recording.settle(boundaries)


def host_sync() -> None:
    """Count a point where the host waits for the device."""
    if _recording is not None:
        _recording.host_syncs += 1


def count_search_maps(n: int) -> None:
    """Count ``n`` SAD maps scored by the search init: into the capture
    open, whose every replay counts them, else into the recording."""
    if _capture is not None:
        _capture.boundaries.search_maps += n
    elif _recording is not None:
        _recording.search_maps += n


def _read(program: str, call: int, boundaries: list) -> Replay:
    boundaries[-1][2].synchronize()
    first = boundaries[0][1]
    return Replay(program, call, [(name, first.elapsed_time(a),
                                   first.elapsed_time(b))
                                  for name, a, b in boundaries])
