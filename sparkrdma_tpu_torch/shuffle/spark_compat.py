"""Reference-shaped API aliases.

The reference's whole deployment story is "change one config line and the
engine's existing calls keep working" (README.md:69-71:
``spark.shuffle.manager org.apache.spark.shuffle.rdma.RdmaShuffleManager``).
This module exposes the identical method surface —
``registerShuffle / getWriter / getReader / unregisterShuffle /
shuffleBlockResolver / stop`` (scala/RdmaShuffleManager.scala:143-310),
writer ``write / stop`` (writer/wrapper/RdmaWrapperShuffleWriter.scala:
102-122), reader ``read`` (scala/RdmaShuffleReader.scala:43) — over the
native snake_case API, so code written against the reference's shapes ports
mechanically.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import (
    PartitionerSpec,
    ShuffleHandle,
    TpuShuffleManager,
)


class ShuffleDependency:
    """The slice of Spark's ShuffleDependency the reference consumes:
    partition count + partitioner (scala/RdmaShuffleManager.scala:143-183),
    plus the aggregator (``combiner``) Spark carries on the dependency —
    when set, every writer of this shuffle applies map-side combine
    (the engine and shipped tasks pick it up automatically)."""

    def __init__(self, num_partitions: int,
                 partitioner: Optional[PartitionerSpec] = None,
                 row_payload_bytes: int = 0,
                 combiner=None):
        self.num_partitions = num_partitions
        self.partitioner = partitioner or PartitionerSpec("hash")
        self.row_payload_bytes = row_payload_bytes
        self.combiner = combiner


class SparkCompatShuffleManager:
    """camelCase facade over :class:`TpuShuffleManager`."""

    def __init__(self, conf: Optional[TpuShuffleConf] = None,
                 isDriver: bool = False, driverAddr=None,
                 executorId: str = "driver", **kw):
        self._m = TpuShuffleManager(conf, is_driver=isDriver,
                                    driver_addr=driverAddr,
                                    executor_id=executorId, **kw)

    # -- ShuffleManager SPI (scala/RdmaShuffleManager.scala:143-310) ------

    def registerShuffle(self, shuffleId: int, numMaps: int,
                        dependency: ShuffleDependency) -> ShuffleHandle:
        return self._m.register_shuffle(shuffleId, numMaps,
                                        dependency.num_partitions,
                                        dependency.partitioner,
                                        dependency.row_payload_bytes,
                                        combiner=dependency.combiner)

    def getWriter(self, handle: ShuffleHandle, mapId: int,
                  context=None, combiner=None) -> "CompatWriter":
        """``combiner`` is the map-side-combine hook (the aggregator half
        Spark's write path applies before spilling)."""
        return CompatWriter(self._m.get_writer(handle, mapId,
                                               combiner=combiner))

    def getReader(self, handle: ShuffleHandle, startPartition: int,
                  endPartition: int, context=None,
                  mapRange=None) -> "CompatReader":
        """``mapRange`` is the adaptive plan's split-task map slice
        (``(map_lo, map_hi)``); None reads the full map space."""
        return CompatReader(self._m.get_reader(handle, startPartition,
                                               endPartition,
                                               map_range=mapRange))

    def unregisterShuffle(self, shuffleId: int) -> bool:
        self._m.unregister_shuffle(shuffleId)
        return True

    @property
    def shuffleBlockResolver(self):
        return self._m.resolver

    def stop(self) -> None:
        self._m.stop()

    # escape hatch to the native API
    @property
    def native(self) -> TpuShuffleManager:
        return self._m

    @property
    def driverAddr(self):
        return self._m.driver_addr


class CompatWriter:
    """``write(records)`` + ``stop(success)``
    (writer/wrapper/RdmaWrapperShuffleWriter.scala:102-122)."""

    def __init__(self, inner):
        self._w = inner

    def write(self, records: Iterable[Tuple[int, np.ndarray]]) -> None:
        """records: iterable of (key, payload-row) pairs, or
        (keys-array, payload-matrix) batches."""
        if (isinstance(records, tuple) and len(records) == 2
                and isinstance(records[0], np.ndarray)):
            self._w.write_batch(*records)
            return
        keys, payloads = [], []
        for k, v in records:
            keys.append(k)
            payloads.append(v)
        if keys:
            self._w.write_batch(np.asarray(keys, dtype=np.uint64),
                                np.asarray(payloads, dtype=np.uint8))

    def stop(self, success: bool = True):
        return self._w.close(success)


class CompatReader:
    """``read()`` -> record iterator (scala/RdmaShuffleReader.scala:43).

    ``readBatches()`` is the performance surface: it yields
    ``(keys u64[N], payload u8[N, W])`` numpy batches straight off the
    fetcher with no per-row Python. ``read()`` exists for reference-shaped
    row-at-a-time consumers and costs a Python loop per record — at
    TeraSort scale use the batch form (everything in-tree does).
    """

    def __init__(self, inner):
        self._r = inner

    def read(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Row-at-a-time compatibility shim over ``readBatches``."""
        for keys, payload in self._r.read():
            for i in range(len(keys)):
                yield int(keys[i]), payload[i]

    def readBatches(self):
        """Vectorized record batches — the fast path."""
        return self._r.read()

    def readSortedSpilled(self, memoryBudgetBytes: int = 64 << 20):
        """Globally key-sorted batches with bounded memory (the
        ExternalSorter delegation, scala/RdmaShuffleReader.scala:100-114)."""
        return self._r.read_sorted_spilled(memory_budget_bytes=memoryBudgetBytes)

    def readAggregated(self, combine):
        """Vectorized combine over the sorted partition (the aggregator's
        merge half Spark applies on the read side)."""
        return self._r.read_aggregated(combine)

    def readAll(self):
        """The whole partition range as one (keys, payload) batch."""
        return self._r.read_all()

    @property
    def metrics(self):
        return self._r.metrics
