"""The reduction of a profile: device operations and time, the busy
union, idle left out where the host was in the profiler's own work, and
the device time of single timed calls."""

import pytest

from portbench import devtrace


class Ev:
    def __init__(self, name, start_ns, end_ns, device=False):
        self._name, self._s, self._e = name, start_ns, end_ns
        self._dev = device

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._name.startswith("portbench.")


def _dev(name, s, e):
    return Ev(name, s, e, device=True)


def test_reduce_counts_ops_time_and_the_busy_union():
    events = [Ev(devtrace.WINDOW, 0, 1000),
              _dev("add", 100, 300), _dev("mul", 200, 400),   # overlap
              _dev("add", 600, 700),
              Ev("cudaGraphLaunch", 400, 600)]
    t = devtrace.reduce(events, panoramas=2)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.device_ops == 3
    assert t.device_s == pytest.approx(500e-9)
    assert t.busy_s == pytest.approx(400e-9)          # 100-400, 600-700
    assert t.profiler_idle_s == 0.0
    assert dict(t.top_ops)["add"] == pytest.approx(300e-9)
    gaps = dict((n, s) for n, s in t.idle_gaps)
    assert gaps["cudaGraphLaunch"] == pytest.approx(200e-9)


def test_idle_in_the_profilers_own_work_is_left_out():
    events = [Ev(devtrace.WINDOW, 0, 1000),
              _dev("add", 0, 400), _dev("add", 500, 600),
              _dev("add", 900, 1000),
              # a flush over 350-550: 100 of it busy, 100 idle
              Ev("Buffer Flush", 350, 550),
              Ev("Activity Buffer Request", 650, 750)]
    t = devtrace.reduce(events, panoramas=1)
    assert t.busy_s == pytest.approx(600e-9)
    assert t.profiler_idle_s == pytest.approx(200e-9)

    class R:
        trace = t

    # idle 400 of 1000, 200 of it the profiler's: 200 of 800
    assert devtrace.idle_share(R) == pytest.approx(100 * 200 / 800)


def test_busy_before():
    import numpy as np

    bs, be = np.array([10, 50]), np.array([20, 80])
    got = devtrace._busy_before(bs, be, np.array([0, 15, 30, 60, 100]))
    assert got.tolist() == [0, 5, 10, 20, 40]


def test_per_call_seconds_take_the_ops_that_start_inside_each_call():
    events = [_dev("fill", 0, 50),                       # the flush
              Ev(devtrace.CALL, 60, 400),
              _dev("offsets", 100, 120), _dev("warp", 130, 330),
              _dev("fill", 410, 460),
              Ev(devtrace.CALL, 470, 900),
              _dev("offsets", 500, 520), _dev("warp", 520, 700)]
    assert devtrace.per_call_seconds(events) == pytest.approx(
        [230e-9, 200e-9])
    assert devtrace.per_call_seconds([Ev(devtrace.CALL, 0, 10)]) == []
