"""Bounded recently-dead id tracking, shared by the two places an
unregister/death broadcast races in-flight traffic for the same id:

* :class:`~sparkrdma_tpu_torch.shuffle.location_plane.LocationPlane` marks a
  shuffle DEAD on the ``EPOCH_DEAD`` push so a LATE response stamped
  with the pre-death epoch cannot resurrect cached views (the epoch
  record is popped with the death — only the marker knows);
* :class:`~sparkrdma_tpu_torch.shuffle.push_merge.MergeStore` marks a
  dropped shuffle so a push racing the unregister broadcast cannot
  re-create segment state and charge disk bytes nothing will ever
  release.

Entries are bounded two ways, each load-bearing:

* **count** (FIFO eviction past ``cap``): a long-lived executor over
  thousands of shuffles cannot grow the marker set without bound;
* **time** (``ttl_s``): engine shuffle ids are REUSED, and in a
  default deployment (no tenancy push, no shard map, no adaptive plan)
  no push-delivered registration signal exists to re-arm a reused id —
  a permanent marker would disable caching/push-merge for the new
  incarnation forever. The zombie traffic the marker defends against
  is bounded by connection deadlines (requests time out, suspects
  close their windows), so a marker older than ``ttl_s`` has outlived
  every message that could still race it and expires on its own.

``discard`` is the fast path: push-delivered registration signals
(TenantMapMsg, ShardMapMsg, a pushed ReducePlanMsg) ride the same FIFO
broadcast channel as the death, so their arrival is authoritative
evidence of a new incarnation and clears the marker immediately.

NOT thread-safe — every caller consults it under its own lock.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable


class TombstoneCache:
    """Recently-dead integer ids, bounded by count and age."""

    def __init__(self, ttl_s: float = 30.0, cap: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl_s = float(ttl_s)
        self.cap = int(cap)
        self._clock = clock
        self._stamps: "OrderedDict[int, float]" = OrderedDict()

    def add(self, key: int) -> None:
        self._stamps[key] = self._clock()
        self._stamps.move_to_end(key)
        while len(self._stamps) > self.cap:
            self._stamps.popitem(last=False)

    def discard(self, key: int) -> None:
        self._stamps.pop(key, None)

    def __contains__(self, key: int) -> bool:
        stamp = self._stamps.get(key)
        if stamp is None:
            return False
        if self._clock() - stamp > self.ttl_s:
            del self._stamps[key]
            return False
        return True

    def __len__(self) -> int:
        return len(self._stamps)
