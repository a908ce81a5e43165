"""Committed map outputs held in memory, served through the resolver's API.

The mesh service stages from executor managers, and reads of each only
its ``resolver``: ``map_ids(shuffle_id)`` and ``local_blocks(shuffle_id,
map_id, start, end)`` (``sparkrdma_tpu/shuffle/resolver.py:550-571``).
``LocalStore`` gives that serving API over outputs committed in memory,
laid out byte for byte as ``MonolithicShuffleWriter.close`` lays out a
spill (``sparkrdma_tpu/shuffle/writer.py:985-1045``): rows ``key (8
bytes LE) | payload (W bytes)``, stably grouped by partition, partitions
in id order. ``LocalExecutor`` is a manager with that one attribute.

It is the stand-in where the host plane is not there yet (the card
machine; tests of the port alone): no combiner, no disk, no integrity
check, nothing the writer and resolver do not do.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.shuffle.manager import Partitioner


class LocalStore:
    """Per shuffle, per map: the committed row bytes and the partition
    offsets into them."""

    def __init__(self):
        self._shuffles: Dict[int, Dict[int, Tuple[np.ndarray,
                                                  np.ndarray]]] = {}
        self._lock = threading.Lock()

    def commit(self, shuffle_id: int, map_id: int, keys: np.ndarray,
               payload: np.ndarray, partitioner: Partitioner,
               num_partitions: int) -> np.ndarray:
        """Commit one map output of ``keys u64[N]`` and ``payload
        u8[N, W]``, partitioned by ``partitioner``; a second commit of the
        same map replaces the first. Returns the per-partition byte
        lengths."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        payload = np.ascontiguousarray(payload, dtype=np.uint8)
        if payload.ndim != 2 or len(payload) != len(keys):
            raise ValueError(f"payload must be [{len(keys)}, W]")
        dest = np.asarray(partitioner(keys), dtype=np.int64)
        if len(dest) != len(keys):
            raise ValueError("partitioner returned wrong-length array")
        if len(dest) and (dest.min() < 0 or dest.max() >= num_partitions):
            raise ValueError("partitioner returned out-of-range partition id")
        order = np.argsort(dest, kind="stable")
        counts = np.bincount(dest, minlength=num_partitions)
        row_bytes = 8 + payload.shape[1]
        rows = np.empty((len(keys), row_bytes), dtype=np.uint8)
        rows[:, :8] = keys[order, None].view(np.uint8).reshape(len(keys), 8)
        rows[:, 8:] = payload[order]
        lengths = counts * row_bytes
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        with self._lock:
            self._shuffles.setdefault(shuffle_id, {})[map_id] = (
                rows.reshape(-1), offsets)
        return lengths

    def map_ids(self, shuffle_id: int) -> List[int]:
        with self._lock:
            return sorted(self._shuffles.get(shuffle_id, {}).keys())

    def local_blocks(self, shuffle_id: int, map_id: int,
                     start_partition: int, end_partition: int
                     ) -> Optional[bytes]:
        """Concatenated partitions ``[start, end)`` of one map output, or
        None for a map this store does not hold."""
        with self._lock:
            held = self._shuffles.get(shuffle_id, {}).get(map_id)
        if held is None:
            return None
        data, offsets = held
        last = len(offsets) - 1
        lo = min(max(0, start_partition), last)
        hi = min(max(lo, end_partition), last)
        return data[offsets[lo]:offsets[hi]].tobytes()


@dataclass
class LocalExecutor:
    """An executor manager as the mesh service sees one: its resolver."""

    resolver: LocalStore = field(default_factory=LocalStore)
