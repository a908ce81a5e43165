"""Partitioned metadata ownership: per-shard write owners + standbys.

PR-6 sharded the *read* path (map-range shard replicas the driver keeps
fed); this module shards the *write* path. Each ``(shuffle, shard)`` has
one OWNER executor that runs the fence CAS for its contiguous map-range,
logs every applied write to a per-shard ``ha.OpLog`` BEFORE applying it
(the PR-17 discipline, one log per shard instead of one per driver), and
streams the records to a standby so failover stays per-shard. Ownership
is namespaced by a composed generation — driver incarnation in the high
32 bits, per-incarnation handoff seq below, exactly the
``ha.compose_epoch`` packing — so a write carrying a stale generation
can always be recognized and bounced to the driver, and a driver
failover automatically dominates every pre-failover owner.

Handoff is seal-then-replay: the outgoing owner (or its standby, when
the owner died) seals the log segment — sealed shards reject ALL writes,
turning the old owner into a forwarder — and the incoming owner replays
the segment under the new generation before accepting fresh writes.

Everything here is endpoint-free and transport-free on purpose: the
model checker (analysis/modelcheck.py handoff scenarios) and the
control-plane microbench (shuffle/ctrl_bench.py) drive these real
classes directly, and parallel/endpoints.py wires them to the RPC
frames (ShardPublishMsg / ShardOpMsg / ShardBatchMsg / ShardHandoffMsg).
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.shuffle import ha

_ENTRY = struct.Struct("<qi")  # (table_token, exec_index) — 12 bytes

# publish/merged outcomes. Only APPLIED writes are logged + batched;
# everything else is the caller's cue to forward the original to the
# driver (one extra hop, never a lost entry).
APPLIED = 0       # CAS won: logged, applied, batch-converged
FENCED = 1        # older fence than the applied one for (map, exec)
SEALED = 2        # shard sealed for handoff: owner is now a forwarder
STALE_GEN = 3     # sender's owner_gen is not the owned generation
NOT_OWNER = 4     # this host does not own the (shuffle, shard) range


class _OwnedShard:
    """One owned map-range: entries + fence floors + its op log."""

    __slots__ = ("lo", "hi", "num_maps", "gen", "sealed", "entries",
                 "fences", "merged_blobs", "log", "lock")

    def __init__(self, lo: int, hi: int, num_maps: int, gen: int) -> None:
        self.lo = lo
        self.hi = hi
        self.num_maps = num_maps
        self.gen = gen
        self.sealed = False
        self.entries: Dict[int, bytes] = {}
        # mirror of DriverTable._fences for the range: highest applied
        # fence per (map, exec) — per executor, not last-applied-only,
        # for the same fence_loser reason (map_output.py).
        self.fences: Dict[int, Dict[int, int]] = {}
        self.merged_blobs: List[bytes] = []
        # per-incarnation handoff seq as the log stamp; the full
        # composed gen rides the wire beside (it exceeds the u32
        # OpRecord incarnation field).
        self.log = ha.OpLog(incarnation=ha.epoch_seq(gen))
        self.lock = threading.Lock()


class ShardOwnerStore:
    """The owner half: every shard this executor currently owns.

    Locking is per shard — that independence IS the scale-out: N owned
    ranges admit N concurrent fence-CAS streams where the driver path
    serializes them on one endpoint lock (measured by ctrl_bench).
    ``op_cost_fn`` is called while holding the shard lock, modelling
    the per-write control-plane work for the bench.
    """

    def __init__(self, op_cost_fn: Optional[Callable[[], None]] = None):
        self._lock = threading.Lock()
        self._shards: Dict[Tuple[int, int], _OwnedShard] = {}
        self._op_cost_fn = op_cost_fn
        self.applied = 0
        self.fenced = 0
        self.rejected_sealed = 0
        self.rejected_stale = 0
        self.adoptions = 0
        self.seals = 0

    # -- ownership lifecycle ------------------------------------------------

    def adopt(self, shuffle_id: int, shard: int, lo: int, hi: int,
              num_maps: int, gen: int,
              replay: Optional[List[Tuple[int, bytes]]] = None) -> bool:
        """Take ownership of ``[lo, hi)`` at generation ``gen``,
        replaying the sealed segment (``(kind, payload)`` pairs from the
        old owner's log, via the standby buffer) under the new
        generation first. Forward-only: adopting at a generation not
        newer than the one already held is a no-op (a late replay of an
        old assignment must not resurrect a sealed shard)."""
        key = (shuffle_id, shard)
        with self._lock:
            cur = self._shards.get(key)
            if cur is not None and cur.gen >= gen:
                return False
            owned = _OwnedShard(lo, hi, num_maps, gen)
            self._shards[key] = owned
            self.adoptions += 1
        for kind, payload in (replay or []):
            if kind == ha.SHARD_OP_PUBLISH:
                map_id, fence, entry, lengths = ha.unpack_shard_publish(
                    payload)
                self.publish(shuffle_id, shard, map_id, entry, fence,
                             gen, lengths)
            elif kind == ha.SHARD_OP_MERGED:
                self.merged(shuffle_id, shard, gen, payload)
        return True

    def seal(self, shuffle_id: int, shard: int) -> List[ha.OpRecord]:
        """Seal the shard (all later writes bounce) and export its log
        segment for the successor to replay."""
        owned = self._shards.get((shuffle_id, shard))
        if owned is None:
            return []
        with owned.lock:
            owned.sealed = True
            self.seals += 1
            return owned.log.entries_since(0)

    def drop(self, shuffle_id: int) -> None:
        """Forget every shard of a dead shuffle (unregister/EPOCH_DEAD)."""
        with self._lock:
            for key in [k for k in self._shards if k[0] == shuffle_id]:
                del self._shards[key]

    # -- introspection ------------------------------------------------------

    def gen_of(self, shuffle_id: int, shard: int) -> Optional[int]:
        owned = self._shards.get((shuffle_id, shard))
        return owned.gen if owned is not None else None

    def owns(self, shuffle_id: int, shard: int) -> bool:
        owned = self._shards.get((shuffle_id, shard))
        return owned is not None and not owned.sealed

    def shard_for(self, shuffle_id: int, map_id: int) -> Optional[int]:
        """Which owned shard (if any) covers ``map_id``."""
        with self._lock:
            for (sid, shard), owned in self._shards.items():
                if sid == shuffle_id and owned.lo <= map_id < owned.hi:
                    return shard
        return None

    def owned_shards(self, shuffle_id: int) -> List[int]:
        with self._lock:
            return sorted(s for (sid, s) in self._shards
                          if sid == shuffle_id)

    def entries_of(self, shuffle_id: int, shard: int) -> Dict[int, bytes]:
        owned = self._shards.get((shuffle_id, shard))
        if owned is None:
            return {}
        with owned.lock:
            return dict(owned.entries)

    def merged_of(self, shuffle_id: int, shard: int) -> List[bytes]:
        owned = self._shards.get((shuffle_id, shard))
        if owned is None:
            return []
        with owned.lock:
            return list(owned.merged_blobs)

    # -- the write path -----------------------------------------------------

    def _admit(self, shuffle_id: int, shard: int, gen: int):
        owned = self._shards.get((shuffle_id, shard))
        if owned is None:
            return None, NOT_OWNER
        if owned.gen != gen:
            self.rejected_stale += 1
            return None, STALE_GEN
        if owned.sealed:
            self.rejected_sealed += 1
            return None, SEALED
        return owned, APPLIED

    def publish(self, shuffle_id: int, shard: int, map_id: int,
                entry: bytes, fence: int, gen: int,
                lengths=None) -> Tuple[int, Optional[ha.OpRecord]]:
        """The owner-side fence CAS, mirroring DriverTable.publish:
        reject fences older than the applied one for the same
        (map, exec); equal fences re-apply idempotently. Log-append
        BEFORE apply (the PR-17 rule: a standby that has the record can
        always reconstruct the apply; the reverse loses the write)."""
        owned, status = self._admit(shuffle_id, shard, gen)
        if owned is None or status != APPLIED:
            return status, None
        with owned.lock:
            # re-check under the lock: seal() may have won the race
            if owned.sealed:
                self.rejected_sealed += 1
                return SEALED, None
            if not owned.lo <= map_id < owned.hi:
                return NOT_OWNER, None
            exec_index = _ENTRY.unpack(entry)[1]
            floors = owned.fences.setdefault(map_id, {})
            if fence < floors.get(exec_index, 0):
                self.fenced += 1
                return FENCED, None
            rec = owned.log.append(
                ha.SHARD_OP_PUBLISH,
                ha.pack_shard_publish(map_id, fence, entry, lengths))
            floors[exec_index] = fence
            owned.entries[map_id] = bytes(entry)
            if self._op_cost_fn is not None:
                self._op_cost_fn()
            self.applied += 1
            return APPLIED, rec

    def merged(self, shuffle_id: int, shard: int, gen: int,
               blob: bytes) -> Tuple[int, Optional[ha.OpRecord]]:
        """Log + hold a merged-directory publish (opaque blob; the
        driver's zombie/fence checks run at batch convergence)."""
        owned, status = self._admit(shuffle_id, shard, gen)
        if owned is None or status != APPLIED:
            return status, None
        with owned.lock:
            if owned.sealed:
                self.rejected_sealed += 1
                return SEALED, None
            rec = owned.log.append(ha.SHARD_OP_MERGED, bytes(blob))
            owned.merged_blobs.append(bytes(blob))
            if self._op_cost_fn is not None:
                self._op_cost_fn()
            self.applied += 1
            return APPLIED, rec


class ShardStandbyBuffer:
    """The standby half: buffers the per-shard op stream, forward-only
    on ``(owner_gen, seq)`` — the same zombie fence the driver-level
    standby applies to ``(incarnation, seq)`` — so a sealed owner's
    straggler appends can never land behind a handoff."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (sid, shard) -> (last (gen, seq), ordered [(kind, blob)])
        self._streams: Dict[Tuple[int, int],
                            Tuple[Tuple[int, int],
                                  List[Tuple[int, bytes]]]] = {}
        self.ingested = 0
        self.dropped_stale = 0

    def ingest(self, shuffle_id: int, shard: int, gen: int, seq: int,
               kind: int, blob: bytes) -> bool:
        key = (shuffle_id, shard)
        with self._lock:
            last, records = self._streams.get(key, ((0, 0), []))
            if (gen, seq) <= last:
                self.dropped_stale += 1
                return False
            records.append((kind, bytes(blob)))
            self._streams[key] = ((gen, seq), records)
            self.ingested += 1
            return True

    def take(self, shuffle_id: int, shard: int) -> List[Tuple[int, bytes]]:
        """Drain the buffered segment for replay-on-adoption."""
        with self._lock:
            last, records = self._streams.pop((shuffle_id, shard),
                                              ((0, 0), []))
            return records

    def last(self, shuffle_id: int, shard: int) -> Tuple[int, int]:
        with self._lock:
            entry = self._streams.get((shuffle_id, shard))
            return entry[0] if entry else (0, 0)

    def drop(self, shuffle_id: int) -> None:
        with self._lock:
            for key in [k for k in self._streams if k[0] == shuffle_id]:
                del self._streams[key]
