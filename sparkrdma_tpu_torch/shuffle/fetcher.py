"""Read-side metrics and the fetch-failure error.

A partial copy of ``sparkrdma_tpu/shuffle/fetcher.py`` holding only what
the mesh service needs: ``FetchFailedError`` (``fetcher.py:79``), which
staging raises for a map output that went missing, and the local-serving
counters of ``ReadMetrics`` (``fetcher.py:137``) that
``CachedPartitionReader`` records. The full copy of the host plane
replaces it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


class FetchFailedError(Exception):
    """A remote block could not be fetched; the engine should recompute the
    producing stage (reference surfaces Spark's FetchFailedException,
    scala/RdmaShuffleFetcherIterator.scala:376-381).

    ``verdict`` tells the recovery loop WHY: ``"peer_lost"`` (default —
    the slot may be dead; recompute everything it owned, maybe tombstone)
    vs ``"corrupt_output"`` (the owner is alive but THIS map's committed
    output failed its at-rest verification; re-execute just that map, on
    any live executor including the owner, and never tombstone a live
    peer over bit-rot)."""

    def __init__(self, shuffle_id: int, map_id: int, exec_index: int,
                 cause: str, verdict: str = "peer_lost"):
        super().__init__(f"shuffle {shuffle_id} map {map_id} "
                         f"(executor slot {exec_index}): {cause}")
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.exec_index = exec_index
        self.verdict = verdict


@dataclass
class ReadMetrics:
    """Reference: Spark task metrics wiring
    (scala/RdmaShuffleFetcherIterator.scala:104-106, 330-332, 349-361).
    Mutate via the record_* methods. Only the remote and local byte and
    fetch counters are copied; the host plane's copy brings the rest."""

    remote_bytes: int = 0
    local_bytes: int = 0
    remote_fetches: int = 0
    local_fetches: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_local(self, nbytes: int) -> None:
        with self._lock:
            self.local_bytes += nbytes
            self.local_fetches += 1
