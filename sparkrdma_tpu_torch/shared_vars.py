"""Shared variables: broadcasts and accumulators for engine jobs.

The reference gets both from Spark core (its plugin never implements
them): broadcasts deliver the build side of map-side joins to every
executor once per PROCESS instead of once per task closure, and
accumulators stream task-side counters back to the driver with
exactly-once merging for successful attempts. The in-tree engine
(engine.py) is the Spark half of this framework, so both live here:

* ``Broadcast`` — the value is pickled once driver-side and registered
  with the driver endpoint; a handle pickles as just its id, so task
  closures capturing it stay tiny. Executors fetch the blob at most once
  per process (``GetBroadcastReq`` on the control plane, served by the
  driver like the membership announces) and cache it.
* ``Accumulator`` — ``add()`` inside a task goes to a task-local sink;
  the deltas ride the task-result envelope back to the driver, which
  merges them only for the FIRST successful attempt of each task —
  speculative duplicates, retries and abandoned stragglers never
  double-count (Spark's guarantee for accumulators used in actions).

Sum semantics only (Spark's long/doubleAccumulator): deltas combine
with ``+`` on the worker and at the driver.
"""

from __future__ import annotations

import itertools
import logging
import pickle
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

log = logging.getLogger(__name__)

_ids = itertools.count(1)
_tl = threading.local()  # .sink: Dict[int, Any] | .fetch: Callable

# worker-process broadcast cache, FIFO-capped so long-lived executors
# hosting many jobs don't grow without bound; _inflight serializes the
# FIRST fetch per id so k concurrent tasks cost one transfer, not k
_CACHE_CAP = 64
_cache: Dict[int, Any] = {}
_inflight: Dict[int, threading.Lock] = {}
_cache_lock = threading.Lock()

# originals living in THIS process (driver): unpickling a handle here
# (in-process executors, local round-trips) resolves without any RPC.
# WEAK values: dropping the last user reference to a Broadcast lets the
# value be collected, and a finalizer drops the driver-endpoint blob too
# (the ContextCleaner role in Spark) — a long-lived driver that never
# calls unpersist() still doesn't grow without bound.
_local: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_local_lock = threading.Lock()


def _sink_add(sink: Dict[int, Any], acc_id: int, n: Any) -> None:
    sink[acc_id] = (sink[acc_id] + n) if acc_id in sink else n


class Broadcast:
    """Driver-created read-only shared value (sc.broadcast analogue)."""

    def __init__(self, bcast_id: int, value: Any, driver_ep=None):
        self.bcast_id = bcast_id
        self._value = value
        self._driver_ep = driver_ep

    @property
    def value(self) -> Any:
        return self._value

    def unpersist(self) -> None:
        """Drop the driver-side blob; executors keep cached copies (the
        reference's engine behaves the same: unpersist is advisory)."""
        if self._driver_ep is not None:
            self._driver_ep.unregister_broadcast(self.bcast_id)
        with _local_lock:
            _local.pop(self.bcast_id, None)

    def __reduce__(self):
        # ship the id, never the value — the whole point of broadcast
        return (_load_broadcast, (self.bcast_id,))


class _BroadcastProxy:
    """Worker-side handle: fetches + caches the value on first access."""

    def __init__(self, bcast_id: int):
        self.bcast_id = bcast_id

    @property
    def value(self) -> Any:
        with _cache_lock:
            if self.bcast_id in _cache:
                return _cache[self.bcast_id]
            gate = _inflight.setdefault(self.bcast_id, threading.Lock())
        try:
            with gate:  # concurrent first accesses: one fetch, losers wait
                with _cache_lock:
                    if self.bcast_id in _cache:
                        return _cache[self.bcast_id]
                fetch = getattr(_tl, "fetch", None)
                if fetch is None:
                    raise RuntimeError(
                        f"broadcast {self.bcast_id} accessed outside a task "
                        "context (no fetch channel to the driver)")
                value = pickle.loads(fetch(self.bcast_id))
                with _cache_lock:
                    while len(_cache) >= _CACHE_CAP:
                        _cache.pop(next(iter(_cache)))
                    _cache[self.bcast_id] = value
            return value
        finally:
            # drop the gate on failure too: a driver that unpersisted the
            # blob would otherwise leak one Lock per failed bcast_id forever
            with _cache_lock:
                _inflight.pop(self.bcast_id, None)

    def __reduce__(self):
        return (_load_broadcast, (self.bcast_id,))


def _load_broadcast(bcast_id: int):
    with _local_lock:
        orig = _local.get(bcast_id)
    return orig if orig is not None else _BroadcastProxy(bcast_id)


def create_broadcast(value: Any, driver_ep) -> Broadcast:
    """Pickle once, register with the driver endpoint, return the handle.

    Lifetime: the returned handle is the owner. When the caller drops its
    last reference (and no in-flight task closure holds one), the value
    becomes collectable and a finalizer unregisters the driver-side blob
    — Spark's ContextCleaner role, so un-unpersisted broadcasts don't pin
    driver memory forever."""
    bcast_id = next(_ids)
    driver_ep.register_broadcast(bcast_id, pickle.dumps(value))
    b = Broadcast(bcast_id, value, driver_ep)
    weakref.finalize(b, driver_ep.unregister_broadcast, bcast_id)
    with _local_lock:
        _local[bcast_id] = b
    return b


class Accumulator:
    """Driver-created write-only-from-tasks counter (longAccumulator
    analogue): ``add`` in tasks, ``value`` on the driver."""

    def __init__(self, name: str, zero: Any = 0):
        self.acc_id = next(_ids)
        self.name = name
        self._zero = zero
        self._value = zero
        self._lock = threading.Lock()

    def add(self, n: Any) -> None:
        sink = getattr(_tl, "sink", None)
        if sink is not None:
            _sink_add(sink, self.acc_id, n)
        else:
            # driver code outside any task (Spark allows this too)
            with self._lock:
                self._value = self._value + n

    @property
    def value(self) -> Any:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = self._zero

    def _merge(self, delta: Any) -> None:
        with self._lock:
            self._value = self._value + delta

    def __reduce__(self):
        return (_load_accumulator, (self.acc_id, self.name))


class _AccumulatorProxy:
    """Worker-side handle: add-only; the driver owns the value."""

    def __init__(self, acc_id: int, name: str):
        self.acc_id = acc_id
        self.name = name

    def add(self, n: Any) -> None:
        sink = getattr(_tl, "sink", None)
        if sink is None:
            raise RuntimeError(
                f"accumulator {self.name!r} add() outside a task context")
        _sink_add(sink, self.acc_id, n)

    @property
    def value(self) -> Any:
        raise RuntimeError(
            f"accumulator {self.name!r} value is driver-only")

    def __reduce__(self):
        return (_load_accumulator, (self.acc_id, self.name))


def _load_accumulator(acc_id: int, name: str):
    return _AccumulatorProxy(acc_id, name)


@contextmanager
def collecting():
    """Install a fresh per-task accumulator sink on this thread; yields
    the dict of deltas to ship with the task's result."""
    prev = getattr(_tl, "sink", None)
    deltas: Dict[int, Any] = {}
    _tl.sink = deltas
    try:
        yield deltas
    finally:
        _tl.sink = prev


@contextmanager
def serving(fetch: Optional[Callable[[int], bytes]]):
    """Install the broadcast fetch channel for this task thread."""
    prev = getattr(_tl, "fetch", None)
    _tl.fetch = fetch
    try:
        yield
    finally:
        _tl.fetch = prev
