"""The traced segment of a run and its reduction: ``torch.profiler``
over a fixed number of calls, kept in memory (no trace file), reduced to
device operations, device time, the union of the device's busy
intervals, the top device operations and the longest idle gaps named by
what the host was doing meanwhile.  Also the device time of single
calls timed under the profiler (the kernel rooflines)."""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

WINDOW = "portbench.traced_window"
CALL = "portbench.timed_call"
TOP = 10
# the profiler's own host work (CUPTI's activity buffers): while the host
# is in it the device idles for the instrumentation, not for the program
PROFILER_HOST = ("Buffer Flush", "Activity Buffer Request")


@dataclasses.dataclass
class Trace:
    window_s: float
    panoramas: int
    device_ops: int = 0
    device_s: float = 0.0
    busy_s: float = 0.0
    # idle seconds while the host was in the profiler's own work
    profiler_idle_s: float = 0.0
    top_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)


def _span(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return int(e.start_us() * 1000), int((e.start_us() + e.duration_us())
                                         * 1000)


def _is_annotation(e) -> bool:
    name = e.name()
    return name.startswith("portbench.") or (
        hasattr(e, "is_user_annotation") and e.is_user_annotation())


def profile_calls(call, n: int, panoramas: int, device, sync) -> Trace | None:
    """``call(k)`` for k < n under the profiler, each ended by
    ``sync()``; ``panoramas`` is what the n calls complete.  None where
    the profiler gives no events to read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for k in range(n):
                call(k)
                sync()
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        return None
    return reduce(results.events(), panoramas)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged (starts, ends) of the intervals, in order."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = s[1:] > run_end[:-1]
    return (np.concatenate([s[:1], s[1:][new]]),
            np.concatenate([run_end[:-1][new], run_end[-1:]]))


def reduce(events, panoramas: int) -> Trace | None:
    window = None
    dev, dev_names = [], []
    host, host_names = [], []
    for e in events:
        if e.name() == WINDOW and not _is_device(e):
            window = _span(e)
            continue
        if _is_annotation(e):
            continue
        if _is_device(e):
            dev.append(_span(e))
            dev_names.append(e.name())
        else:
            host.append(_span(e))
            host_names.append(e.name())
    if window is None:
        return None
    w0, w1 = window
    trace = Trace(window_s=(w1 - w0) / 1e9, panoramas=panoramas)
    if not dev:
        return trace
    d = np.asarray(dev, dtype=np.int64)
    trace.device_ops = len(dev)
    trace.device_s = float((d[:, 1] - d[:, 0]).sum()) / 1e9
    by_name = defaultdict(int)
    for (s, t), name in zip(dev, dev_names):
        by_name[name] += t - s
    trace.top_ops = [[name[:160], ns / 1e9] for name, ns in
                     sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    bs, be = _union(np.clip(d[:, 0], w0, w1), np.clip(d[:, 1], w0, w1))
    trace.busy_s = float((be - bs).sum()) / 1e9
    own = [t for t, name in zip(host, host_names) if name in PROFILER_HOST]
    if own:
        o = np.clip(np.asarray(own, dtype=np.int64), w0, w1)
        os_, oe = _union(o[:, 0], o[:, 1])
        busy_in = _busy_before(bs, be, oe) - _busy_before(bs, be, os_)
        trace.profiler_idle_s = float(((oe - os_) - busy_in).sum()) / 1e9
    gap_s = np.concatenate([[w0], be])
    gap_e = np.concatenate([bs, [w1]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    longest = np.argsort(gap_s - gap_e, kind="stable")[:TOP]
    hs = np.asarray([s for s, _ in host] or [0], dtype=np.int64)
    he = np.asarray([t for _, t in host] or [0], dtype=np.int64)
    for g in longest:
        mid = (gap_s[g] + gap_e[g]) // 2
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        # the innermost host event open at the gap's middle
        name = (host_names[inside[np.argmin(he[inside] - hs[inside])]]
                if host and inside.size else "host idle")
        trace.idle_gaps.append([name[:160],
                                float(gap_e[g] - gap_s[g]) / 1e9])
    return trace


def _busy_before(bs: np.ndarray, be: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Busy nanoseconds of the merged intervals (bs, be) before each t."""
    done = np.concatenate([[0], np.cumsum(be - bs)])
    # the last interval that starts at or before t
    k = np.searchsorted(bs, t, side="right") - 1
    kk = np.maximum(k, 0)
    inside = np.clip(t - bs[kk], 0, be[kk] - bs[kk])
    return np.where(k >= 0, done[kk] + inside, 0)


def call_seconds(fn, reps: int, before, sync) -> float | None:
    """Median device seconds of ``fn()`` under the profiler: from the
    start of the first device operation a call launches to the end of its
    last.  ``before()`` (an L2 flush) runs ahead of each call and is
    synchronized before the call starts, so every device operation that
    starts inside the call's host span is the call's.  None where the
    profiler shows no device operation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            before()
            sync()
            with record_function(CALL):
                fn()
                sync()
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        return None
    seconds = per_call_seconds(results.events())
    return float(np.median(seconds)) if seconds else None


def per_call_seconds(events) -> list[float]:
    """For each ``CALL`` range on the host, the seconds from the start of
    the first device operation that starts inside it to the end of the
    last."""
    calls, dev = [], []
    for e in events:
        if _is_device(e):
            if not _is_annotation(e):
                dev.append(_span(e))
        elif e.name() == CALL:
            calls.append(_span(e))
    if not dev:
        return []
    d = np.asarray(dev, dtype=np.int64)
    seconds = []
    for c0, c1 in calls:
        inside = d[(d[:, 0] >= c0) & (d[:, 0] <= c1)]
        if inside.size:
            seconds.append(float(inside[:, 1].max() - inside[:, 0].min())
                           / 1e9)
    return seconds


def _traced(run) -> Trace | None:
    """The run's trace where it saw device operations."""
    t = run.trace
    return t if t is not None and t.device_ops else None


def ops_per_panorama(run) -> float | None:
    t = _traced(run)
    return None if t is None else t.device_ops / t.panoramas


def device_ms_per_panorama(run) -> float | None:
    t = _traced(run)
    return None if t is None else t.device_s * 1e3 / t.panoramas


def idle_share(run) -> float | None:
    """Percent of the traced window in which the device idled, leaving
    out the stretches in which it idled for the profiler's own host work
    (``PROFILER_HOST``)."""
    t = _traced(run)
    if t is None:
        return None
    own = t.profiler_idle_s
    return 100.0 * (1.0 - t.busy_s / (t.window_s - own))
