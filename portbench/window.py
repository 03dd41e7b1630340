"""The measured window of a closed loop, and its arithmetic.

One caller, one call in flight: a call starts when the previous one has
ended on the device.  The window runs from the first call's start to the
end of the call that crosses ``seconds``; every call in it counts, and a
rate or a time per panorama is taken over all of the window's work and
all of its time."""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    calls: int = 0
    panoramas: int = 0
    # host seconds of each call, from its start to its device sync
    latencies: list = dataclasses.field(default_factory=list)

    def seconds_per_call(self) -> float:
        return self.seconds / self.calls

    def panoramas_per_second(self) -> float:
        return self.panoramas / self.seconds


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def run(call, keep, seconds: float, sync) -> Window:
    """``call(k)`` for k = 0, 1, ... back to back until ``seconds`` have
    passed, each timed to the return of ``sync()``; then ``keep(k, out)``
    takes its output (outside the call's latency, inside the window) and
    returns the panoramas it holds."""
    win = Window()
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        out = call(win.calls)
        sync()
        te = time.perf_counter()
        win.latencies.append(te - ts)
        win.panoramas += keep(win.calls, out)
        win.calls += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            win.seconds = elapsed
            return win
