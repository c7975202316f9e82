"""Whole-window statistics, the device's idle share from intervals, and
the paced camera's schedule."""

import statistics

import pytest

from harness.sources import EndOfStream, PacedSource
from harness.stats import gaps_of, percentile, spread, union_length


def test_percentile_takes_every_sample_and_interpolates():
    values = list(range(1, 101))  # 1..100
    assert percentile(values, 50) == pytest.approx(50.5)
    assert percentile(values, 95) == pytest.approx(95.05)
    assert percentile(values, 0) == 1 and percentile(values, 100) == 100
    # One stalled sample moves the tail of the whole window.
    assert percentile([10.0] * 99 + [5000.0], 100) == 5000.0
    with pytest.raises(ValueError):
        percentile([], 50)


def test_spread_uses_the_standard_librarys_quartiles():
    values = [10.0, 11.0, 9.5, 10.2, 10.8, 9.9]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread(values) == pytest.approx((q3 - q1)
                                           / statistics.median(values))


@pytest.mark.parametrize("intervals, union, gaps", [
    ([], 0, [(0, 10)]),
    ([(1, 3)], 2, [(0, 1), (3, 10)]),
    # Kernels overlapping on two streams count once.
    ([(1, 5), (2, 4), (4, 6)], 5, [(0, 1), (6, 10)]),
    ([(0, 2), (2, 3), (8, 10)], 5, [(3, 8)]),
    ([(0, 10)], 10, []),
])
def test_union_and_gaps_of_device_intervals(intervals, union, gaps):
    assert union_length(intervals) == union
    assert gaps_of(intervals, 0, 10) == gaps
    assert union + sum(t - s for s, t in gaps) == 10


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_paced_source_yields_each_frame_when_due_and_records_lateness():
    clock = FakeClock()
    pool = ["a", "b", "c"]
    src = PacedSource(pool, rate=10.0, offset=0.025, clock=clock,
                      sleep=clock.sleep)
    src.schedule(start=101.0, end=101.3)
    assert src.framerate == 10.0
    assert src.read_frames() == "a"      # waits until 101.025
    assert clock.t == pytest.approx(101.025)
    clock.t = 101.3                      # the consumer falls behind
    assert src.read_frames() == "b"      # due 101.125: handed over at once
    assert src.read_frames() == "c"      # due 101.225: late as well
    with pytest.raises(EndOfStream):     # 101.325 is past the end
        src.read_frames()
    assert src.lateness() == pytest.approx([0.0, 0.175, 0.075])
    assert [src.due(i) for i in range(3)] == pytest.approx(
        [101.025, 101.125, 101.225])


def test_paced_source_cycles_its_pool():
    clock = FakeClock()
    src = PacedSource([1, 2], rate=1000.0, offset=0.0, clock=clock,
                      sleep=clock.sleep)
    src.schedule(clock(), clock() + 0.0045)
    assert [src.read_frames() for _ in range(5)] == [1, 2, 1, 2, 1]


def test_host_readings_leave_the_profiled_spans_out(monkeypatch):
    """A traced run's host-side totals are read outside the profiler's
    spans: from where a span starts to the first batch boundary after it
    stops, its batches and its time are left out."""
    import contextlib

    import torch

    from harness import trace

    class Profile:
        def __init__(self, **kwargs):
            pass

        start = stop = lambda self: None

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace, "WINDOWS", (0.5,))
    tracer = trace.Tracer(True, 10.0, 0.0)
    tracer.plan, tracer.done = [5.0], []
    monkeypatch.setattr(tracer, "_collect", lambda prof: None)
    frames = [0]
    tracer.watch(frames=lambda: frames[0])
    # One batch of 8 frames a second, except that the profiled span (from
    # the boundary at 5 s to the one after the stop) takes 3 s a batch.
    now = 0.0
    while now < 20.0:
        profiling = tracer.span is not None
        now += 3.0 if profiling else 1.0
        frames[0] += 8
        tracer.step(now)
    tracer.close()
    spans = 1 + trace.WINDOW_BATCHES + 1  # start-up, marked, after stop
    assert tracer.excluded_s == pytest.approx(3.0 * spans)
    assert tracer.outside("frames") == frames[0] - 8 * spans
    assert tracer.outside_s() == pytest.approx(now - 3.0 * spans)
    assert tracer.outside("frames") / tracer.outside_s() == pytest.approx(8)
    assert tracer.outside("missing") is None
    assert tracer.first_span == 5.0
