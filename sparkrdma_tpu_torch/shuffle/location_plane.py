"""One-sided metadata plane: epoch-versioned location tables.

The reference's defining property is that the remote CPU never sits on
the serving path — locations are READ one-sided out of published tables
(scala/RdmaShuffleManager.scala:341-376). Our control plane carried that
flow as request/reply RPCs (``FetchTableReq``/``FetchOutputsReq``) on
EVERY stage, and iterative workloads (PageRank/ALS/TPC-DS supersteps
re-reading an unchanged parent shuffle) re-paid the full metadata cost
each superstep. Per "RPC Considered Harmful: Fast Distributed Deep
Learning on RDMA" (PAPERS.md), this module replaces the request/reply
metadata plane with one-sided publication of VERSIONED state:

* Every shuffle's location state carries an **epoch** (monotone,
  driver-allocated, starting at 1). Executors publish into the driver
  table once per map commit exactly as before — the epoch only moves
  when the state is REPAIRED: a re-execution overwrites an entry, an
  executor is tombstoned, or the shuffle unregisters (``EPOCH_DEAD``).
* Reducers keep a **local epoch-validated cache** (:class:`LocationPlane`)
  of the driver table and the per-map block-location entries. The warm
  path — superstep N over unchanged inputs — resolves every location
  from the cache: **zero metadata RPCs on the wire**. The cold path pays
  one driver-table sync plus one batched location read per (peer, epoch)
  and caches both under the epoch.
* Invalidation is **pushed**, not polled: the driver broadcasts
  ``EpochBumpMsg`` on the same channel as membership announces. A lost
  push is backstopped by the fetch path itself — a stale location fails
  its fetch, and the failure handler invalidates the cache the hard way
  (``invalidate``), so staleness can cost latency, never correctness.
* The driver table is **sharded by map-range across executors**
  (:class:`ShardMap`, ``metadata_shards``): the driver keeps ownership
  of shard assignment and commit fencing (only fence-surviving publishes
  are forwarded, as ``ShardEntryMsg``), while shard hosts serve
  cold-path table reads (``FetchShardReq`` long-poll) out of their
  replica (:class:`ShardStore`) — thousand-reducer fan-in spreads over
  shard hosts instead of serializing on one driver endpoint. The driver
  remains authoritative: any shard failure falls back to the driver
  long-poll.

"Memory-efficient array redistribution through portable collective
communication" (PAPERS.md) motivates the other half: redistribution
state stays RESIDENT across iterations instead of rebuilt per stage —
connections (already pre-warmed + cached), pool registrations, and this
module's location views all survive supersteps keyed by epoch, and
``shuffle/dist_cache.py`` extends the same idea to the reduced bytes
themselves (epoch-keyed cross-stage shuffle-output reuse).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.shuffle.map_output import (
    MAP_ENTRY_SIZE,
    UNPUBLISHED,
    _MAP_ENTRY,
    DriverTable,
)

# epoch sentinel mirrored from messages.EPOCH_DEAD (kept here too so the
# plane has no wire dependency; tests assert they stay equal)
EPOCH_DEAD = -1


class ShardMap:
    """Map-range -> shard-host assignment for one shuffle, driver-owned.

    Maps are divided into ``len(shard_slots)`` contiguous ranges;
    ``shard_slots[i]`` is the executor slot hosting shard ``i``'s
    replica. Contiguity keeps one shard read one contiguous table slice
    (the same reason the reference's table is positional: range reads
    stay O(1) request, O(range) bytes).
    """

    def __init__(self, num_maps: int, shard_slots: List[int]):
        if num_maps <= 0 or not shard_slots:
            raise ValueError("need maps and at least one shard slot")
        self.num_maps = num_maps
        # ceil-divided contiguous spans; the last shard may run short.
        # Shards whose range would start past the map space are DROPPED
        # (5 maps over 4 slots = span 2 = 3 real shards): an empty shard
        # would own no maps, receive no forwards, and fail every sharded
        # sync into the driver fallback. The truncation is stable across
        # the wire: ceil(m / ceil(m / span)) == span for any span this
        # constructor produces, so sender and receiver derive identical
        # ranges from the truncated slot list.
        self._span = -(-num_maps // len(shard_slots))
        self.shard_slots = list(shard_slots[:-(-num_maps // self._span)])

    @property
    def num_shards(self) -> int:
        return len(self.shard_slots)

    def shard_of(self, map_id: int) -> int:
        if not 0 <= map_id < self.num_maps:
            raise IndexError(map_id)
        return map_id // self._span

    def range_of(self, shard: int) -> Tuple[int, int]:
        """[map_lo, map_hi) of one shard (never empty for valid shards)."""
        lo = shard * self._span
        return lo, min(self.num_maps, lo + self._span)

    def slot_of_map(self, map_id: int) -> int:
        return self.shard_slots[self.shard_of(map_id)]

    @staticmethod
    def assign(num_maps: int, membership, max_shards: int,
               avoid=()) -> Optional["ShardMap"]:
        """The driver's assignment policy: up to ``max_shards`` shards
        over the live executor slots, round-robin; None when sharding is
        off (``max_shards`` < 1) or there is nobody to host.

        ``membership`` is the driver's MembershipPlane (anything with a
        ``live_slots()`` method) — consulted directly so a DRAINING slot
        is never assigned as a shard owner: its writes are being walked
        off the host, handing it a fence-CAS range would re-pin it. A
        raw slot list is still accepted (tests, the model checker), in
        which case the caller vouches for liveness. ``avoid`` excludes
        slots mid-removal: membership tombstoning and shard handoff are
        not atomic, so reassignment must not re-pick the slot whose
        death triggered it."""
        if max_shards < 1 or num_maps <= 0:
            return None
        if hasattr(membership, "live_slots"):
            slots = list(membership.live_slots())  # excludes DRAINING
        else:
            slots = list(membership)
        if avoid:
            slots = [s for s in slots if s not in set(avoid)]
        if not slots:
            return None
        n = min(max_shards, len(slots), num_maps)
        return ShardMap(num_maps, [slots[i % len(slots)]
                                   for i in range(n)])


class _ShardState:
    """One shuffle's replica on a shard host: applied entries by map id.

    A plain dict rather than a positional buffer: the host may receive
    forwards for any subset of the map space (the driver only forwards
    the ranges this host owns, but the store doesn't need to know the
    shard map — ``FetchShardReq`` carries its range explicitly, so the
    replica serves whatever it holds and reports the in-range count)."""

    __slots__ = ("entries", "epoch", "num_maps")

    def __init__(self, num_maps: int):
        self.entries: Dict[int, bytes] = {}
        self.epoch = 0
        self.num_maps = num_maps


class ShardStore:
    """Executor-side driver-table shard replicas (the serve half of the
    sharded metadata plane). Fed one-sided by the driver's
    ``ShardEntryMsg`` forwards; read by peers' ``FetchShardReq``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shuffles: Dict[int, _ShardState] = {}
        self.entries_applied = 0  # audit

    def apply(self, shuffle_id: int, epoch: int, map_id: int,
              num_maps: int, entry: bytes) -> None:
        """Apply one forwarded entry (idempotent positional overwrite;
        the driver already fenced it). The replica's epoch follows the
        newest forward — a repair forward carries the bumped epoch."""
        if len(entry) != MAP_ENTRY_SIZE:
            return
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            if state is None:
                state = _ShardState(num_maps)
                self._shuffles[shuffle_id] = state
            state.entries[map_id] = bytes(entry)
            state.epoch = max(state.epoch, epoch)
            state.num_maps = max(state.num_maps, num_maps)
            self.entries_applied += 1

    def drop(self, shuffle_id: int) -> None:
        with self._lock:
            self._shuffles.pop(shuffle_id, None)

    def count_in(self, shuffle_id: int, map_lo: int,
                 map_hi: int) -> Optional[int]:
        """Published entries within [map_lo, map_hi), or None when the
        host holds no replica for the shuffle."""
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            if state is None:
                return None
            return sum(1 for m in state.entries if map_lo <= m < map_hi)

    def read_range(self, shuffle_id: int, map_lo: int, map_hi: int
                   ) -> Optional[Tuple[int, int, bytes]]:
        """(num_published_in_range, epoch, entry bytes) for [map_lo,
        map_hi), UNPUBLISHED-filled holes; None = no replica here."""
        if map_hi < map_lo or map_lo < 0:
            return None
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            if state is None:
                return None
            out = bytearray()
            n = 0
            for m in range(map_lo, map_hi):
                e = state.entries.get(m)
                if e is None:
                    out += _MAP_ENTRY.pack(0, UNPUBLISHED)
                else:
                    out += e
                    n += 1
            return n, state.epoch, bytes(out)


class LocationPlane:
    """One executor's epoch-validated cache of location metadata.

    Three layers, all keyed by (shuffle, epoch):

    * the driver table (complete tables only — partial tables are never
      memoized, same rule the endpoint's old memo kept),
    * per-(map, partition-range) block-location entries (what
      ``FetchOutputsReq`` returns on the cold path),
    * the shuffle's :class:`ShardMap`, when the driver pushed one.

    Validity rule: a cached item serves iff its epoch equals the newest
    epoch this executor has OBSERVED for the shuffle (pushes and table
    responses both advance the observation; observations are monotone).
    An ``EPOCH_DEAD`` push drops everything for the shuffle.

    Bounded: location ranges evict FIFO past ``max_ranges`` so a
    long-lived executor reading thousands of shuffles can't grow the
    plane without bound (complete tables are one entry per shuffle and
    dropped on unregister, so they need no separate cap).
    """

    def __init__(self, enabled: bool = True, max_ranges: int = 8192):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._epochs: Dict[int, int] = {}
        # shuffles observed DEAD: an EPOCH_DEAD push pops the epoch
        # record, so without this marker a LATE response stamped with
        # the pre-death epoch re-cached views for a dead shuffle (the
        # modelcheck ttl_vs_late_fetch schedule). put_* paths drop for
        # marked shuffles; a POSITIVE pushed bump or a push-delivered
        # registration signal (note_registered) re-arms the id — both
        # ride the driver's FIFO broadcast channel, so their arrival
        # postdates the death. Count- and time-bounded (see
        # utils/tombstones.py): zombie responses are bounded by request
        # deadlines, so an aged marker has nothing left to reject and
        # expires rather than keeping a reused id cold forever.
        from sparkrdma_tpu_torch.utils.tombstones import TombstoneCache
        self._dead = TombstoneCache(ttl_s=60.0, cap=4096)
        self._tables: Dict[int, Tuple[DriverTable, int]] = {}
        self._locations: "OrderedDict[Tuple[int, int, int, int], Tuple[list, int]]" = OrderedDict()
        self._shard_maps: Dict[int, Tuple[ShardMap, int]] = {}
        # reduce plans (shuffle/planner.py): versioned by their OWN
        # plan_epoch, independent of the location epoch — a location
        # repair moves bytes, not the carve-up of reduce work. Newest
        # plan_epoch wins; EPOCH_DEAD drops the plan with the rest.
        self._plans: Dict[int, object] = {}
        # merged-segment directories (shuffle/push_merge.py): cached
        # under the LOCATION epoch like tables — a repair/tombstone bump
        # invalidates, so a re-pointed reducer re-pulls a directory the
        # driver has already pruned. Only non-empty directories are
        # cached (endpoint policy), so pre-finalize stages keep pulling.
        self._merged: Dict[int, Tuple[object, int]] = {}
        self._max_ranges = max_ranges
        # elastic membership (parallel/membership.py): the pushed
        # slot-state vector under ITS epoch — highest epoch wins, same
        # rule as announces. Empty until the first MembershipBumpMsg
        # (pre-elastic drivers never send one): every slot then reads
        # LIVE, the static-membership behavior.
        self._member_epoch = -1
        self._member_states: Tuple[int, ...] = ()
        # audit counters (surfaced via snapshot(); the warm-path test and
        # the iterative bench read these)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.stale_drops = 0

    # -- membership states (parallel/membership.py) -----------------------

    def note_membership(self, epoch: int, states) -> List[int]:
        """Apply one pushed slot-state vector; stale (lower-epoch)
        pushes are ignored. Returns the slots that BECAME live with this
        bump (mid-job joiners — the health monitor registers them)."""
        with self._lock:
            if epoch <= self._member_epoch:
                return []
            old = self._member_states
            new = tuple(int(s) for s in states)
            self._member_epoch = epoch
            self._member_states = new
        joined = []
        for i, s in enumerate(new):
            was = old[i] if i < len(old) else None
            if s == 0 and was != 0:  # SLOT_LIVE
                joined.append(i)
        return joined

    def membership(self) -> Tuple[int, Tuple[int, ...]]:
        """``(epoch, states)`` — ``(-1, ())`` before any bump."""
        with self._lock:
            return self._member_epoch, self._member_states

    def slot_draining(self, slot: int) -> bool:
        """True when the pushed state vector marks the slot DRAINING —
        pushers stop choosing it as a merge target and planners stop
        placing work there. Unknown slots (no bump yet, or a joiner
        newer than the vector) read False = LIVE."""
        with self._lock:
            if not 0 <= slot < len(self._member_states):
                return False
            return self._member_states[slot] == 1  # SLOT_DRAINING

    # -- epoch observation ------------------------------------------------

    def note_registered(self, shuffle_id: int) -> None:
        """Re-arm a DEAD id: called on push-delivered registration
        signals (TenantMapMsg, ShardMapMsg, pushed ReducePlanMsg) —
        they ride the same FIFO broadcast channel as the EPOCH_DEAD
        that killed the id, so their arrival postdates the death and
        names a NEW incarnation. Response-path put_* calls never clear
        the marker (a late response is exactly what the marker exists
        to reject). Residual window: a response from the OLD
        incarnation still in flight when the id is re-registered and
        re-armed can cache once — epochs restart per registration, so
        without a wire-level registration generation no local guard
        can tell the incarnations apart; the fetch-failure
        invalidation backstop (module docstring) keeps that a latency
        cost, never a correctness one."""
        with self._lock:
            self._dead.discard(shuffle_id)

    def known_epoch(self, shuffle_id: int) -> Optional[int]:
        with self._lock:
            return self._epochs.get(shuffle_id)

    def note_epoch(self, shuffle_id: int, epoch: int) -> bool:
        """Observe ``epoch`` for ``shuffle_id``; returns True when the
        observation invalidated cached state (the push-invalidation
        path). ``EPOCH_DEAD`` drops the shuffle entirely."""
        with self._lock:
            if epoch == EPOCH_DEAD:
                had = (self._tables.pop(shuffle_id, None) is not None)
                self._epochs.pop(shuffle_id, None)
                self._shard_maps.pop(shuffle_id, None)
                self._plans.pop(shuffle_id, None)
                self._merged.pop(shuffle_id, None)
                self._dead.add(shuffle_id)
                dropped = self._drop_locations_locked(shuffle_id)
                if had or dropped:
                    self.invalidations += 1
                return had or dropped
            # a positive PUSHED epoch re-arms a dead id: the broadcast
            # channel is FIFO, so this bump postdates the death — the
            # id was re-registered (engine shuffle ids are reused)
            self._dead.discard(shuffle_id)
            prev = self._epochs.get(shuffle_id)
            if prev is not None and epoch <= prev:
                return False
            self._epochs[shuffle_id] = epoch
            stale = False
            cached = self._tables.get(shuffle_id)
            # analysis: epoch-eq-ok(validity is exact-epoch match; the monotone guard above ordered the observation)
            if cached is not None and cached[1] != epoch:
                del self._tables[shuffle_id]
                stale = True
            merged = self._merged.get(shuffle_id)
            # analysis: epoch-eq-ok(validity is exact-epoch match; the monotone guard above ordered the observation)
            if merged is not None and merged[1] != epoch:
                del self._merged[shuffle_id]
                stale = True
            for key in [k for k in self._locations if k[0] == shuffle_id]:
                # analysis: epoch-eq-ok(validity is exact-epoch match; the monotone guard above ordered the observation)
                if self._locations[key][1] != epoch:
                    del self._locations[key]
                    stale = True
            if stale:
                self.invalidations += 1
                self.stale_drops += 1
            return stale

    # -- driver table -----------------------------------------------------

    def put_table(self, shuffle_id: int, table: DriverTable,
                  epoch: int) -> None:
        """Memoize a COMPLETE table under its epoch (and observe the
        epoch). Partial tables never memoize — later readers with higher
        expectations must go back to the source."""
        if not self.enabled or table.num_published < table.num_maps:
            return
        with self._lock:
            if shuffle_id in self._dead:
                # late response for a DEAD shuffle: the epoch record is
                # gone, only the marker knows this would resurrect it
                self.stale_drops += 1
                return
            prev = self._epochs.get(shuffle_id)
            if prev is not None and epoch < prev:
                # the response predates a pushed invalidation: stale
                self.stale_drops += 1
                return
            self._epochs[shuffle_id] = max(prev or 0, epoch)
            self._tables[shuffle_id] = (table, epoch)

    def table(self, shuffle_id: int) -> Optional[Tuple[DriverTable, int]]:
        """The cached complete table iff epoch-current, else None."""
        if not self.enabled:
            return None
        with self._lock:
            cached = self._tables.get(shuffle_id)
            if cached is None:
                self.misses += 1
                return None
            known = self._epochs.get(shuffle_id)
            # analysis: epoch-eq-ok(a cached view serves only at exactly the newest observed epoch; != means stale)
            if known is not None and cached[1] != known:
                del self._tables[shuffle_id]
                self.stale_drops += 1
                self.misses += 1
                return None
            self.hits += 1
            return cached

    # -- block-location entries -------------------------------------------

    def put_locations(self, shuffle_id: int, map_id: int, start: int,
                      end: int, locations: list, epoch: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            if shuffle_id in self._dead:
                self.stale_drops += 1
                return
            prev = self._epochs.get(shuffle_id)
            if prev is not None and epoch < prev:
                self.stale_drops += 1
                return
            self._epochs[shuffle_id] = max(prev or 0, epoch)
            key = (shuffle_id, map_id, start, end)
            self._locations[key] = (locations, epoch)
            self._locations.move_to_end(key)
            while len(self._locations) > self._max_ranges:
                self._locations.popitem(last=False)

    def locations(self, shuffle_id: int, map_id: int, start: int,
                  end: int) -> Optional[list]:
        if not self.enabled:
            return None
        with self._lock:
            key = (shuffle_id, map_id, start, end)
            cached = self._locations.get(key)
            if cached is None:
                self.misses += 1
                return None
            known = self._epochs.get(shuffle_id)
            # analysis: epoch-eq-ok(a cached view serves only at exactly the newest observed epoch; != means stale)
            if known is not None and cached[1] != known:
                del self._locations[key]
                self.stale_drops += 1
                self.misses += 1
                return None
            self.hits += 1
            return cached[0]

    # -- shard map --------------------------------------------------------

    def put_shard_map(self, shuffle_id: int, shard_map: ShardMap,
                      epoch: int) -> bool:
        """Cache a pushed shard assignment; highest generation wins
        (``epoch`` carries the composed ownership generation in
        shard_ownership mode, a constant 1 in replica mode — either
        way a reordered stale push must not roll a handoff back).
        Returns True when the assignment was accepted."""
        with self._lock:
            prev = self._shard_maps.get(shuffle_id)
            if prev is not None and epoch < prev[1]:
                return False
            self._shard_maps[shuffle_id] = (shard_map, epoch)
            return True

    def shard_map(self, shuffle_id: int) -> Optional[ShardMap]:
        with self._lock:
            cached = self._shard_maps.get(shuffle_id)
            return cached[0] if cached is not None else None

    def shard_map_v(self, shuffle_id: int):
        """(shard_map, generation) — the ownership write path needs the
        generation to stamp direct publishes."""
        with self._lock:
            return self._shard_maps.get(shuffle_id)

    # -- reduce plan ------------------------------------------------------

    def put_plan(self, shuffle_id: int, plan) -> bool:
        """Cache one shuffle's ReducePlan; newest ``plan_epoch`` wins
        (pushes may reorder — a stale re-delivery must never roll a
        re-plan back). Returns True when the plan was ACCEPTED (first
        plan or a newer epoch) — plan-keyed warm invalidation gates on
        this, so a rejected stale push can't wipe warm state either."""
        with self._lock:
            if shuffle_id in self._dead:
                return False  # a late plan response for a DEAD shuffle
            prev = self._plans.get(shuffle_id)
            if prev is not None and plan.plan_epoch <= prev.plan_epoch:
                return False
            self._plans[shuffle_id] = plan
            return True

    def plan(self, shuffle_id: int):
        """The cached ReducePlan (cache-first resolution; validity is by
        plan_epoch monotonicity, not the location epoch)."""
        with self._lock:
            return self._plans.get(shuffle_id)

    # -- merged-segment directory (push-merge) ----------------------------

    def put_merged(self, shuffle_id: int, directory, epoch: int) -> None:
        """Cache one shuffle's merged directory under its epoch (same
        staleness rule as tables: a response predating a pushed
        invalidation is dropped, never served)."""
        if not self.enabled:
            return
        with self._lock:
            if shuffle_id in self._dead:
                self.stale_drops += 1
                return
            prev = self._epochs.get(shuffle_id)
            if prev is not None and epoch < prev:
                self.stale_drops += 1
                return
            self._epochs[shuffle_id] = max(prev or 0, epoch)
            self._merged[shuffle_id] = (directory, epoch)

    def merged(self, shuffle_id: int):
        """The cached merged directory iff epoch-current, else None."""
        if not self.enabled:
            return None
        with self._lock:
            cached = self._merged.get(shuffle_id)
            if cached is None:
                self.misses += 1
                return None
            known = self._epochs.get(shuffle_id)
            # analysis: epoch-eq-ok(a cached view serves only at exactly the newest observed epoch; != means stale)
            if known is not None and cached[1] != known:
                del self._merged[shuffle_id]
                self.stale_drops += 1
                self.misses += 1
                return None
            self.hits += 1
            return cached[0]

    # -- invalidation -----------------------------------------------------

    def _drop_locations_locked(self, shuffle_id: int) -> bool:
        keys = [k for k in self._locations if k[0] == shuffle_id]
        for k in keys:
            del self._locations[k]
        return bool(keys)

    def invalidate(self, shuffle_id: int) -> None:
        """Hard invalidation (fetch failure / recovery / unregister):
        drop every cached view of the shuffle but KEEP the observed
        epoch — a re-read must come from the source, and a racing
        response stamped with the old epoch must still be recognized as
        stale."""
        with self._lock:
            dropped = (self._tables.pop(shuffle_id, None) is not None)
            dropped |= self._drop_locations_locked(shuffle_id)
            self._shard_maps.pop(shuffle_id, None)
            self._merged.pop(shuffle_id, None)
            # the plan drops too: invalidate() is also the unregister
            # backstop, and engine shuffle ids are reused — a re-read
            # refetches the plan from the driver for the price of one RPC
            self._plans.pop(shuffle_id, None)
            if dropped:
                self.invalidations += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tables": len(self._tables),
                "ranges": len(self._locations),
                "shard_maps": len(self._shard_maps),
                "plans": len(self._plans),
                "merged": len(self._merged),
                "member_epoch": self._member_epoch,
                "member_states": list(self._member_states),
                "dead": len(self._dead),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "stale_drops": self.stale_drops,
            }
