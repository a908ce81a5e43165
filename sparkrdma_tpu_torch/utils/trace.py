"""Chrome-trace-format span tracer, the port's one span entry, and its
counters.

``Tracer``, ``_NullTracer``, ``NULL`` and ``get`` are a copy of those in
``sparkrdma_tpu/utils/trace.py``: host-side spans, instants and counters
that open in ``chrome://tracing`` or Perfetto, each a timed event with
thread identity. The port's Tracer stamps its events in Unix-epoch
microseconds (``time.time_ns``), the clock a ``torch.profiler`` trace is
converted to (a Chrome export's ``ts`` plus ``baseTimeNanoseconds /
1000``), so a Tracer dump lays over a ``device_profile`` export.

``span(name, tracer)`` is how the port's step paths and drivers open a
span. While a torch profiler records on this thread it opens a
``record_function`` of that name, which a device trace shows with the
kernels it launched; while ``tracer`` is enabled it records the Tracer's
``X`` event, inside that range. With neither it returns one shared no-op
context: a profiler check and no dispatcher call (a ``record_function``
entered with no profiler running still costs 12–13 µs of host time, torch
2.13 on an x86 CPU host, against under 1.5 µs for this check).
On the device a kernel belongs to the innermost open span, and a span's
range runs from its first to its last own kernel. So a span whose device
time is read opens and closes with work of its own around any span
nested in it; otherwise its range leaves the nested span's kernels out.

``counting()`` and ``count(name, amount)`` keep byte counts at the same
boundaries (``gather.bytes`` in ``parallel.mesh.take_rows``,
``exchange.bytes`` in the ragged exchange, ``exchange.group_bytes`` in
the grouping by destination, ``fused.merge_bytes`` in the range step's
receive merge). They count only while a
profiler records, and the first counted call after one made with no
profiler running starts every counter again from zero, so ``counts()``
holds exactly the last profiled window. A count is a host integer or a
device tensor, added on the device with no sync; ``counts()`` reads them.

``device_profile(log_dir)`` is the device side: a ``torch.profiler``
capture around a block (kernels, copies and the spans the port's steps
open), written as a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional


class Tracer:
    MAX_EVENTS = 1_000_000  # ~300 MB of JSON; beyond this, count drops

    def __init__(self, process_name: str = "sparkrdma_tpu_torch"):
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self.process_name = process_name
        self.enabled = True
        self.dropped = 0

    def _now_us(self) -> float:
        # Unix-epoch µs: the clock torch.profiler converts its events to
        return time.time_ns() / 1e3

    def _append(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.MAX_EVENTS:
                self.dropped += 1
            else:
                self._events.append(event)

    @contextmanager
    def span(self, name: str, category: str = "shuffle", **args):
        if not self.enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            self._append({"name": name, "cat": category, "ph": "X",
                          "ts": start,
                          "dur": max(0.0, self._now_us() - start),
                          "pid": os.getpid(), "tid": threading.get_ident(),
                          "args": args})

    def now_us(self) -> float:
        """Current trace-clock timestamp, for ``complete_span``: a caller
        stamps boundaries as they happen and emits the span afterwards."""
        return self._now_us()

    def complete_span(self, name: str, category: str, start_us: float,
                      end_us: float, **args) -> None:
        """Record a span with explicit trace-clock endpoints (from
        ``now_us``)."""
        if not self.enabled:
            return
        self._append({"name": name, "cat": category, "ph": "X",
                      "ts": start_us, "dur": max(0.0, end_us - start_us),
                      "pid": os.getpid(), "tid": threading.get_ident(),
                      "args": args})

    def counter(self, name: str, value: float,
                category: str = "fault") -> None:
        """Chrome "C"-phase counter sample: a running total rendered as a
        stepped series beside the spans."""
        if not self.enabled:
            return
        self._append({"name": name, "cat": category, "ph": "C",
                      "ts": self._now_us(), "pid": os.getpid(),
                      "args": {"value": value}})

    def instant(self, name: str, category: str = "shuffle", **args) -> None:
        if not self.enabled:
            return
        self._append({"name": name, "cat": category, "ph": "i", "s": "t",
                      "ts": self._now_us(), "pid": os.getpid(),
                      "tid": threading.get_ident(), "args": args})

    def events(self, name: str) -> List[dict]:
        """The recorded events called ``name``, in order."""
        with self._lock:
            return [e for e in self._events if e["name"] == name]

    def dump(self, path: str) -> int:
        """Write chrome trace JSON; returns event count."""
        with self._lock:
            events = list(self._events)
        meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
                 "args": {"name": self.process_name,
                          "dropped_events": self.dropped}}]
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)


@contextmanager
def device_profile(log_dir: str):
    """Capture a ``torch.profiler`` trace (host ops, CUDA kernels and
    copies when a card is present, ``record_function`` spans) around a
    block and write it to ``log_dir/trace_<pid>.json`` as a Chrome trace.
    Yields the profiler, whose ``key_averages()`` sums device time by
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


class _NullTracer(Tracer):
    def __init__(self):
        super().__init__()
        self.enabled = False


NULL = _NullTracer()


def get(conf=None) -> Tracer:
    """A live tracer when ``conf.trace_file`` is set, else the no-op
    tracer. ``conf`` is any object, read with ``getattr``."""
    if conf is not None and getattr(conf, "trace_file", ""):
        return Tracer()
    return NULL


# --- the one span entry -----------------------------------------------------

def profiling() -> bool:
    """Whether a torch profiler records on this thread. No profiler can
    run before torch is imported, so this never imports it."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


_NO_SPAN = nullcontext()


class _Span:
    """A ``record_function`` range (while profiled) around a Tracer ``X``
    event (while ``sink`` is set), stamped inside the range."""

    __slots__ = ("name", "sink", "profiled", "args", "_range", "_start")

    def __init__(self, name: str, sink, profiled: bool, args: dict):
        self.name, self.sink, self.profiled, self.args = (
            name, sink, profiled, args)
        self._range = None
        self._start = 0.0

    def __enter__(self):
        if self.profiled:
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        if self.sink is not None:
            self._start = self.sink.now_us()
        return None

    def __exit__(self, *exc):
        if self.sink is not None:
            end = self.sink.now_us()
            self.sink._append({
                "name": self.name, "cat": self.name.split(".")[0],
                "ph": "X", "ts": self._start,
                "dur": max(0.0, end - self._start), "pid": os.getpid(),
                "tid": threading.get_ident(), "args": self.args})
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, tracer: Optional[Tracer] = NULL, **args):
    """The port's span: a ``record_function`` range while a torch
    profiler records, the ``tracer``'s ``X`` event (category: the name's
    first part) while it is enabled, and otherwise a shared no-op
    context. Spans opened with no profiler running mark the counters
    stale (see ``counting``)."""
    global _stale
    profiled = profiling()
    sink = tracer if tracer is not None and tracer.enabled else None
    if not profiled:
        _stale = True
        if sink is None:
            return _NO_SPAN
    return _Span(name, sink, profiled, args)


# --- counters ---------------------------------------------------------------

_counts: Dict[str, object] = {}  # name -> host int or device int64 tensor
_counts_lock = threading.Lock()
_stale = True


def counting() -> bool:
    """Whether ``count`` counts now: a torch profiler records on this
    thread. The first call that finds one after a call (or a span) made
    with no profiler running starts every counter from zero."""
    global _stale
    if not profiling():
        _stale = True
        return False
    if _stale:
        with _counts_lock:
            _counts.clear()
        _stale = False
    return True


def count(name: str, amount, scale: int = 1) -> None:
    """Add ``amount * scale`` to counter ``name``: ``amount`` a host
    integer, or a device tensor whose sum is added in int64 to an
    accumulator on its device, with no sync. Callers count only where
    ``counting()`` says so."""
    with _counts_lock:
        if isinstance(amount, int):
            _counts[name] = _counts.get(name, 0) + amount * scale
            return
        import torch

        acc = _counts.get(name)
        if acc is None:
            acc = _counts[name] = torch.zeros((), dtype=torch.int64,
                                              device=amount.device)
        acc.add_(amount.sum(dtype=torch.int64), alpha=scale)


def counts() -> Dict[str, int]:
    """Every counter's total over the last profiled window, as host
    integers (a device accumulator is read once here)."""
    with _counts_lock:
        return {name: int(value) for name, value in _counts.items()}
