"""The shuffle handle and its partitioner spec.

A partial copy of ``sparkrdma_tpu/shuffle/manager.py`` holding only the
frozen dataclasses a task carries: ``PartitionerSpec``
(``manager.py:48-74``) and ``ShuffleHandle`` (``manager.py:77-95``). The
mesh service reads nothing else of a manager than its ``resolver``, so
no ``TpuShuffleManager`` is copied here; the full copy of the host plane
brings it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

Partitioner = Callable[[np.ndarray], np.ndarray]  # keys u64[N] -> i64[N]


@dataclass(frozen=True)
class PartitionerSpec:
    """Serializable partitioner description (handles cross process
    boundaries; callables don't)."""

    kind: str  # "hash" | "range" | "modulo"
    splitters: Optional[Tuple[int, ...]] = None

    def build(self, num_partitions: int) -> Partitioner:
        if self.kind == "hash":
            # host-side numpy mirror of ops.partition.hash_partition (same
            # murmur finalizer, bit-identical): the writer partitions on
            # the host
            def hash_part(keys):
                k = np.asarray(keys, dtype=np.uint64) & 0xFFFFFFFF
                k = ((k ^ (k >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
                k = ((k ^ (k >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
                k = k ^ (k >> 16)
                return (k % num_partitions).astype(np.int64)
            return hash_part
        if self.kind == "range":
            splitters = np.asarray(self.splitters, dtype=np.uint64)
            return lambda keys: np.searchsorted(
                splitters, np.asarray(keys), side="right").astype(np.int64)
        if self.kind == "modulo":
            return lambda keys: (np.asarray(keys) % num_partitions).astype(np.int64)
        raise ValueError(f"unknown partitioner kind {self.kind!r}")


@dataclass(frozen=True)
class ShuffleHandle:
    """(scala/RdmaUtils.scala:145-159 analogue). ``combiner`` is the
    map-side aggregator registered with the shuffle (Spark carries it on
    the handle's dependency): every writer of this shuffle applies it.
    None = no map-side combine. ``tenant`` is the owning tenant's id."""

    shuffle_id: int
    num_maps: int
    num_partitions: int
    row_payload_bytes: int
    partitioner: PartitionerSpec
    combiner: Optional[Callable] = None
    tenant: int = 0
