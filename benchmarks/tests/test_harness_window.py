"""The window's arithmetic on synthetic timings, and the trace reader on
synthetic profiler events."""

from __future__ import annotations

import statistics

import pytest

from benchmarks import harness
from benchmarks.harness import Event


class FakeDevice:
    """A card that runs jobs in order, each ``cost(index)`` seconds, on a
    clock that only moves when the host waits or enqueues."""

    def __init__(self, cost, enqueue_s: float = 0.001):
        self.now = 0.0
        self.free_at = 0.0
        self.cost = cost
        self.enqueue_s = enqueue_s

    def clock(self) -> float:
        return self.now

    def submit(self, index: int):
        self.now += self.enqueue_s
        self.free_at = max(self.free_at, self.now) + self.cost(index)
        return self.free_at

    def finish(self, index: int, done_at: float) -> dict:
        self.now = max(self.now, done_at)
        return {"overflowed": False}


def _run(cost, seconds: float = 2.0, in_flight: int = 2):
    dev = FakeDevice(cost)
    jobs, window = harness.closed_loop(dev.submit, dev.finish,
                                       seconds=seconds, in_flight=in_flight,
                                       clock=dev.clock)
    return harness.end_to_end(jobs, window, 10**9, 1.0, 0), jobs, window


def test_two_in_flight_keep_the_device_busy():
    metrics, jobs, window = _run(lambda i: 0.010)
    # a job waits behind the one before it: about two job times
    assert metrics["job_p95_ms"]["value"] == pytest.approx(20, rel=0.1)
    assert metrics["throughput_gb_per_s"]["value"] == pytest.approx(
        100, rel=0.02)
    assert all(j.record is not None for j in jobs)
    assert jobs[-1].done == pytest.approx(window)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    steady, _, _ = _run(lambda i: 0.010)
    stalled, jobs, _ = _run(lambda i: 0.010 if i % 20 else 0.200)
    assert (stalled["throughput_gb_per_s"]["value"]
            < 0.6 * steady["throughput_gb_per_s"]["value"])
    assert stalled["job_p95_ms"]["value"] > 5 * steady["job_p95_ms"]["value"]
    # every job of the window counts, the stalled ones too
    assert max(j.latency_s for j in jobs) >= 0.2


def test_the_window_drains_past_its_end():
    _, jobs, window = _run(lambda i: 0.3, seconds=1.0)
    assert window > 1.0
    assert all(j.submitted < 1.0 for j in jobs)


def test_percentile():
    values = list(range(1, 101))
    assert harness.percentile(values, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile(values, 50) == statistics.median(values)


def _events():
    # two jobs' spans on the host, their kernels and their device ranges
    return [
        Event("bench.window", 0, 100, "host", True),
        Event("bench.submit", 0, 10, "host", True),
        Event("q95.date", 1, 9, "host", True),
        Event("aten::sort", 2, 4, "host"),
        Event("q95.date", 10, 30, "range", True),
        Event("sort_kernel", 10, 20, "device"),
        Event("copy_kernel", 15, 25, "device"),   # overlaps: counted once
        Event("sort_kernel", 40, 50, "device"),
        Event("q95.date", 40, 50, "range", True),
        Event("Memset (Device)", 95, 110, "device"),  # clipped at 100
    ]


def test_busy_time_is_a_union():
    s = harness.summarize(_events(), (0, 100), jobs=2)
    assert s.busy_s == pytest.approx((15 + 10 + 5) / 1e6)
    assert s.window_s == pytest.approx(100 / 1e6)
    assert s.span_us["q95.date"] == pytest.approx(15 + 10)
    assert "bench.window" not in s.span_us  # a host span has no range
    ops = dict(s.device_ops)
    assert ops["sort_kernel"] == pytest.approx(20 / 1e6)


def test_idle_gaps_are_named_by_the_host():
    s = harness.summarize(_events(), (0, 100), jobs=2)
    gaps = {name: secs for name, secs in s.idle_gaps}
    assert s.idle_gaps[0][1] == pytest.approx(45 / 1e6)  # 50 .. 95
    # 0 .. 10: the host was enqueueing when the card went idle
    assert gaps["bench.window > bench.submit"] == pytest.approx(10 / 1e6)
    assert harness._host_at(_events(), 3) == (
        "bench.window > bench.submit > q95.date > aten::sort")
    assert sum(secs for _, secs in s.idle_gaps) == pytest.approx(70 / 1e6)


def test_readers_read_the_summary():
    readers = harness.load_readers()
    s = harness.summarize(_events(), (0, 100), jobs=2)
    ctx = harness.Context(s, [0.002, 0.003, 0.004], exchange_bytes=10**6)
    assert readers["q95.dim_joins_ms"].read(ctx) == pytest.approx(
        25 / 1e3 / 2)
    assert readers["device_plane.local_sort_ms"].read(ctx) is None
    assert readers["transport_roofline"].read(ctx) is None
    assert readers["driver.enqueue_ms"].read(ctx) == pytest.approx(3)
    assert readers["device.idle_pct"].read(ctx) == pytest.approx(70)
    spans = dict(s.span_us, **{"exchange.transport": 600.0})
    ctx.trace = harness.TraceSummary(2, s.window_s, s.busy_s, spans, [], [])
    # 1 MB at 3.35 TB/s is 0.2985 us; 0.3 ms a job
    assert readers["transport_roofline"].read(ctx) == pytest.approx(
        100 * 10**6 / 3.35e12 / 0.3e-3)
