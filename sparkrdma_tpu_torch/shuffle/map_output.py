"""Map-output location tables.

Re-design of the reference's two-level address-table scheme:

* ``MapTaskOutput`` (reference: scala/RdmaMapTaskOutput.scala): one fixed
  16-byte entry per reduce partition. The reference stores
  ``(address:8, length:4, mkey:4)`` so a remote NIC can READ the bytes
  directly (scala/RdmaMapTaskOutput.scala:25, 47-56). With no NIC in the
  loop, the TPU build stores ``(offset:8, length:4, buf:4)`` — an offset
  into a staged, pool-owned byte region identified by a buffer token. The
  entry size and range-read API are kept so the wire format stays O(R)·16B
  and contiguous ranges of partitions can be served in one read
  (scala/RdmaMapTaskOutput.scala:58-75).

* ``DriverTable`` (reference: driver-side table allocated per shuffle at
  ``registerShuffle``, scala/RdmaShuffleManager.scala:168-183): one 12-byte
  entry per map task, ``(address:8, lkey:4)`` in the reference
  (scala/RdmaMapTaskOutput.scala:27). Here: ``(table_token:8, exec:4)`` —
  which executor owns map ``m``'s output and the token naming its
  MapTaskOutput table. A map task publishes by writing its entry at byte
  offset ``map_id * 12`` (scala/RdmaShuffleManager.scala:410-412); reducers
  fetch the whole table once per (shuffle, executor)
  (scala/RdmaShuffleManager.scala:341-376).

Both tables are flat little-endian byte buffers (numpy-backed) so they can be
shipped over the control plane, or placed in device memory, without a
serialization step.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np

# (offset: u64, length: u32, buf token: u32) — 16B, matching the reference's
# ENTRY_SIZE (scala/RdmaMapTaskOutput.scala:25).
ENTRY_SIZE = 16
_ENTRY_DTYPE = np.dtype([("offset", "<u8"), ("length", "<u4"), ("buf", "<u4")])

# (table token: u64, exec index: u32) — 12B, matching MAP_ENTRY_SIZE
# (scala/RdmaMapTaskOutput.scala:27).
MAP_ENTRY_SIZE = 12
_MAP_ENTRY = struct.Struct("<QI")

UNPUBLISHED = 0xFFFFFFFF


class BlockLocation(NamedTuple):
    """Where one (map, reduce) block lives: staged-buffer token + offset + len.

    Reference analogue: RdmaBlockLocation(address, length, mKey)
    (scala/RdmaUtils.scala:29-31).
    """

    offset: int
    length: int
    buf: int


class MapTaskOutput:
    """Per-map-task table of R block locations in a staged buffer."""

    def __init__(self, num_partitions: int, data: Optional[np.ndarray] = None):
        if num_partitions <= 0:
            raise ValueError("num_partitions must be positive")
        self.num_partitions = num_partitions
        if data is None:
            self._table = np.zeros(num_partitions, dtype=_ENTRY_DTYPE)
        else:
            if data.dtype != _ENTRY_DTYPE or len(data) != num_partitions:
                raise ValueError("bad table payload")
            self._table = data

    def put(self, reduce_id: int, offset: int, length: int, buf: int) -> None:
        """Record one partition's location (scala/RdmaMapTaskOutput.scala:77-83)."""
        self._table[reduce_id] = (offset, length, buf)

    def put_all(self, offsets: np.ndarray, lengths: np.ndarray, buf: int) -> None:
        """Vectorized fill from a partition-offset/length pair, one staged buffer."""
        self._table["offset"] = offsets
        self._table["length"] = lengths
        self._table["buf"] = buf

    def get_block_location(self, reduce_id: int) -> BlockLocation:
        """(scala/RdmaMapTaskOutput.scala:47-56)."""
        e = self._table[reduce_id]
        return BlockLocation(int(e["offset"]), int(e["length"]), int(e["buf"]))

    def get_range(self, start: int, end: int) -> bytes:
        """Serialized entries for partitions [start, end) — the unit reducers
        fetch remotely (scala/RdmaMapTaskOutput.scala:58-75)."""
        return self._table[start:end].tobytes()

    @property
    def total_bytes(self) -> int:
        return int(self._table["length"].sum())

    def to_bytes(self) -> bytes:
        return self._table.tobytes()

    @staticmethod
    def from_bytes(payload: bytes, num_partitions: Optional[int] = None) -> "MapTaskOutput":
        arr = np.frombuffer(bytearray(payload), dtype=_ENTRY_DTYPE)
        n = num_partitions if num_partitions is not None else len(arr)
        return MapTaskOutput(n, arr)

    @staticmethod
    def locations_from_range(payload: bytes):
        """Decode a ``get_range`` payload into BlockLocations."""
        arr = np.frombuffer(payload, dtype=_ENTRY_DTYPE)
        return [BlockLocation(int(e["offset"]), int(e["length"]), int(e["buf"])) for e in arr]


class DriverTable:
    """Driver-hosted per-shuffle table: map_id -> (table token, executor index).

    Allocated at registerShuffle time, sized ``num_maps * MAP_ENTRY_SIZE``
    (scala/RdmaShuffleManager.scala:168-172); written one-sidedly by map
    tasks at ``map_id * MAP_ENTRY_SIZE`` (scala/RdmaShuffleManager.scala:410-412);
    read whole by reducers (scala/RdmaShuffleManager.scala:341-376).
    """

    def __init__(self, num_maps: int):
        if num_maps <= 0:
            raise ValueError("num_maps must be positive")
        self.num_maps = num_maps
        self._buf = bytearray(num_maps * MAP_ENTRY_SIZE)
        self._published = 0  # O(1) count for the poll-heavy fetch path
        # commit-fencing state, driver-local (never serialized): highest
        # applied fence per (map, exec_index). Fences are allocated by
        # each executor's resolver, so they totally order attempts OF ONE
        # EXECUTOR; cross-executor overwrites always apply (recovery and
        # elastic rejoin depend on last-writer-wins across executors, and
        # a cross-executor late commit is a complete committed output of
        # the same deterministic map — not a torn location). Keyed per
        # executor, not last-applied-only: with only the last (fence,
        # exec) remembered, an intervening cross-executor publish reset
        # the baseline and a zombie attempt's OLD-fence re-publish from
        # the original executor applied again (modelcheck scenario
        # fence_loser found the schedule).
        self._fences: dict = {}  # map_id -> {exec_index: fence}
        for m in range(num_maps):
            _MAP_ENTRY.pack_into(self._buf, m * MAP_ENTRY_SIZE, 0, UNPUBLISHED)

    def publish(self, map_id: int, table_token: int, exec_index: int,
                fence: int = 0) -> bool:
        """Apply one entry write unless it is FENCED: a publish naming the
        same executor as the applied entry but an older fence is a zombie
        speculative attempt's late publish — rejected, returns False.
        Equal fences re-apply (publishes are idempotent overwrites)."""
        if not 0 <= map_id < self.num_maps:
            raise IndexError(f"map_id {map_id} out of range [0, {self.num_maps})")
        prev = self._fences.setdefault(map_id, {})
        if fence < prev.get(exec_index, 0):
            return False
        was = self.entry(map_id) is not None
        _MAP_ENTRY.pack_into(self._buf, map_id * MAP_ENTRY_SIZE, table_token, exec_index)
        prev[exec_index] = fence
        if not was and self.entry(map_id) is not None:
            self._published += 1
        return True

    def write_raw(self, byte_offset: int, payload: bytes) -> None:
        """The one-sided-WRITE analogue: blind positional write into the table
        (scala/RdmaShuffleManager.scala:384-418). Must be entry-aligned.
        Bypasses commit fencing by construction (a one-sided write has no
        CPU to compare epochs) — the control-plane publish path goes
        through :meth:`publish` instead."""
        if byte_offset % MAP_ENTRY_SIZE or len(payload) % MAP_ENTRY_SIZE:
            raise ValueError("unaligned driver-table write")
        if byte_offset < 0 or byte_offset + len(payload) > len(self._buf):
            raise IndexError("driver-table write out of bounds")
        first = byte_offset // MAP_ENTRY_SIZE
        n = len(payload) // MAP_ENTRY_SIZE
        was = sum(1 for m in range(first, first + n) if self.entry(m) is not None)
        self._buf[byte_offset:byte_offset + len(payload)] = payload
        now = sum(1 for m in range(first, first + n) if self.entry(m) is not None)
        self._published += now - was

    def entry(self, map_id: int):
        token, exec_index = _MAP_ENTRY.unpack_from(self._buf, map_id * MAP_ENTRY_SIZE)
        return (token, exec_index) if exec_index != UNPUBLISHED else None

    @property
    def num_published(self) -> int:
        return self._published

    def to_bytes(self) -> bytes:
        return bytes(self._buf)

    @staticmethod
    def from_bytes(payload: bytes) -> "DriverTable":
        if len(payload) % MAP_ENTRY_SIZE:
            raise ValueError("bad driver-table payload")
        t = DriverTable(len(payload) // MAP_ENTRY_SIZE)
        t._buf[:] = payload
        t._published = sum(1 for m in range(t.num_maps) if t.entry(m) is not None)
        return t

    @staticmethod
    def pack_entry(table_token: int, exec_index: int) -> bytes:
        return _MAP_ENTRY.pack(table_token, exec_index)
