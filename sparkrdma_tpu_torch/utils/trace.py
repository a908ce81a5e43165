"""Chrome-trace-format span tracer.

A copy of ``Tracer``, ``_NullTracer``, ``NULL`` and ``get`` from
``sparkrdma_tpu/utils/trace.py``: host-side spans, instants and counters
that open in ``chrome://tracing`` or Perfetto, each a timed event with
thread identity. The exchange drivers (``parallel.device_plane``) take a
tracer and record one ``exchange.round`` span per round and an
``exchange.overlap`` instant per overlapped pair of rounds, as the JAX
drivers do. Zero overhead when off: the module-level ``NULL`` tracer's
``span()`` is a no-op context manager.

``device_profile(log_dir)`` is the device side: a ``torch.profiler``
capture around a block (kernels, copies and the ``record_function``
spans the port's steps carry), written as a Chrome trace into
``log_dir``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List


class Tracer:
    MAX_EVENTS = 1_000_000  # ~300 MB of JSON; beyond this, count drops

    def __init__(self, process_name: str = "sparkrdma_tpu_torch"):
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.process_name = process_name
        self.enabled = True
        self.dropped = 0

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

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
                          "ts": start, "dur": self._now_us() - start,
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
