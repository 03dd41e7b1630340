"""The window's arithmetic: a rate over all its work and all its time,
a tail over all its requests."""

import pytest

from portbench import window


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_window_counts_all_work_and_all_time(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(window.time, "perf_counter", clock)
    durations = [0.2, 0.3, 0.1, 0.4, 0.5, 0.2]

    def call(k):
        clock.now += durations[k]
        return k

    # each call completes 2 panoramas; keep's own time counts in the
    # window but not in the call's latency
    def keep(k, out):
        clock.now += 0.01
        return 2

    win = window.run(call, keep, 1.0, lambda: None)
    # 0.21 + 0.31 + 0.11 + 0.41 = 1.04 >= 1.0 after the fourth call
    assert win.calls == 4
    assert win.panoramas == 8
    assert win.seconds == pytest.approx(1.04)
    assert win.latencies == pytest.approx([0.2, 0.3, 0.1, 0.4])
    assert win.seconds_per_call() == pytest.approx(1.04 / 4)
    assert win.panoramas_per_second() == pytest.approx(8 / 1.04)


def test_window_runs_one_call_at_least(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(window.time, "perf_counter", clock)

    def call(k):
        clock.now += 3.0

    win = window.run(call, lambda k, out: 1, 0.5, lambda: None)
    assert (win.calls, win.panoramas) == (1, 1)
    assert win.seconds == pytest.approx(3.0)


def test_p95_is_nearest_rank_over_all_values():
    values = list(range(1, 201))          # 200 requests
    assert window.percentile(values, 95) == 190
    assert window.percentile(list(reversed(values)), 95) == 190
    assert window.percentile([5.0], 95) == 5.0
    # 10 beyond the 95th percentile of 200
    assert sum(v > window.percentile(values, 95) for v in values) == 10
    assert window.percentile(range(1, 21), 95) == 19
