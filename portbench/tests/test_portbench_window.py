"""The window's arithmetic: a rate over all the window's work and time,
what a stall moves, and which calls are kept."""

from __future__ import annotations

import pytest

from portbench.window import Reservoir, rate_MBps, run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def drive(step_of, seconds, n_batches=4, on_wrap=None, sample=2, seed=1, min_calls=1):
    clock = Clock()
    calls = []

    def encode(batch):
        calls.append(batch)
        clock.t += step_of(len(calls) - 1)
        return [f"out{len(calls) - 1}"]

    batches = [[f"b{i}"] for i in range(n_batches)]
    w = run_window(encode, batches, [1_000_000] * n_batches, seconds, on_wrap=on_wrap,
                   sample=sample, seed=seed, min_calls=min_calls, clock=clock)
    return w, calls


def test_rate_over_every_call():
    w, calls = drive(lambda n: 0.010, 1.0)
    assert w.calls == 100 == len(calls)
    assert w.seconds == pytest.approx(1.0)
    assert rate_MBps(w.nbytes, w.seconds) == pytest.approx(100.0)
    assert w.latencies == pytest.approx([0.010] * 100)


def test_a_stall_moves_the_rate():
    steady, _ = drive(lambda n: 0.010, 1.0)
    # every tenth call stalls for 50 ms
    stalled, _ = drive(lambda n: 0.060 if n % 10 == 9 else 0.010, 1.0)
    assert rate_MBps(stalled.nbytes, stalled.seconds) < 0.7 * rate_MBps(steady.nbytes, steady.seconds)
    assert max(stalled.latencies) == pytest.approx(0.060)


def test_time_between_calls_counts_in_the_rate_only():
    clock_box = []

    def wrap():
        clock_box[0].t += 0.5

    clock = Clock()
    clock_box.append(clock)

    def encode(batch):
        clock.t += 0.01
        return [batch]

    w = run_window(encode, [["a"], ["b"]], [10**6, 10**6], 1.0, on_wrap=wrap, clock=clock)
    assert max(w.latencies) == pytest.approx(0.010)
    assert w.seconds > 1.0 and rate_MBps(w.nbytes, w.seconds) < 10.0


def test_wraps_and_kept_calls():
    wraps = []
    w, calls = drive(lambda n: 0.010, 0.5, n_batches=4, on_wrap=lambda: wraps.append(1),
                     sample=3, seed=7)
    assert w.calls == 50 and len(wraps) == (50 - 1) // 4
    assert calls[:5] == [["b0"], ["b1"], ["b2"], ["b3"], ["b0"]]
    assert 0 in w.kept and 49 in w.kept and len(w.kept) == 5
    for ordinal, (k, out) in w.kept.items():
        assert k == ordinal % 4 and out == [f"out{ordinal}"]
    again, _ = drive(lambda n: 0.010, 0.5, n_batches=4, sample=3, seed=7)
    assert sorted(again.kept) == sorted(w.kept)


def test_min_calls_outlasts_the_deadline():
    w, _ = drive(lambda n: 1.0, 0.0, min_calls=6)
    assert w.calls == 6


def test_reservoir_is_uniform_and_seeded():
    hits = [0] * 10
    for seed in range(2000):
        r = Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        for i in r.slots:
            hits[i] += 1
    assert min(hits) > 0.8 * 400 and max(hits) < 1.2 * 400


def test_a_call_runs_with_only_the_kept_outputs_alive():
    import weakref

    class Out:
        pass

    clock = Clock()
    alive = weakref.WeakSet()
    during = []

    def encode(batch):
        during.append(len(alive))
        clock.t += 0.010
        out = Out()
        alive.add(out)
        return out

    w = run_window(encode, [["a"], ["b"]], [10**6] * 2, 1.0, sample=3, seed=5, clock=clock)
    assert w.calls == 100
    # the first call's outputs and the reservoir's 3; the call before is gone
    assert max(during) == 1 + 3 and during[:5] == [0, 1, 2, 3, 4]
    assert len(w.kept) == 5 and len(alive) == 5
