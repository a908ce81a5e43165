"""Async shuffle fetcher — the hot read path.

Re-design of ``scala/RdmaShuffleFetcherIterator.scala``. Preserved semantics,
point by point:

* three-level fetch: driver table once per shuffle (:183 →
  RdmaShuffleManager.scala:341-376), per-map block-location reads out of the
  owning executor (:293-315), then grouped data fetches (:119-180);
* block grouping: consecutive partitions of one map output are fetched in
  requests of at most ``shuffle_read_block_size`` bytes (:240-263);
* flow control: a ``max_bytes_in_flight`` gate — fetches beyond the budget
  queue until the consumer drains results (:264-276, 366-374), with the
  single-oversized-fetch escape so one huge block can't deadlock;
* randomized pending order so one peer isn't oversubscribed (:74-79);
* local map outputs short-circuit the network entirely (:327-337);
* results flow through a blocking queue; a sentinel terminates iteration
  (:47-50, 113-117); failures surface as ``FetchFailedError`` so the engine
  can recompute the stage (:376-381);
* **bounded read-ahead per peer**: each peer thread keeps up to
  ``read_ahead_depth`` grouped fetches outstanding on the pipelined
  connection and overlaps STEP-2 location reads with STEP-3 data reads —
  the ``sendQueueDepth / cores`` in-flight split that the reference's
  whole speedup rides on (:82-83). ``read_ahead_depth=1`` reproduces the
  fully sequential pre-pipelining behavior exactly (regression escape
  hatch);
* **coalesced reads** (``coalesce_reads``, on by default): per-peer
  batching at BOTH fetch levels. STEP 2 becomes ONE batched location RPC
  per (shuffle, peer) covering every map this reducer needs there —
  O(peers) instead of O(maps) metadata round trips, the unit the
  reference fetches when it READs a peer's whole address table once
  (RdmaShuffleManager.scala:341-376). STEP 3 becomes VECTORED reads:
  per-map groups bound for the same peer merge across maps into single
  request frames (up to ``max_vectored_bytes``/frame caps), each landing
  in one refcounted multi-view pool lease the way the reference lands
  one scatter-READ of many blocks in a single registration
  (java/RdmaRegisteredBuffer.java:28-87). Per-map attribution is kept:
  every vectored response is sliced back into per-(map, range) results,
  and a corrupt sub-block (per-block CRC trailer) refetches ONLY the
  affected ranges, blaming the owning map. A peer that fails the first
  batched call (mixed-version: an old server drops the unknown frame)
  falls back to the per-map dataplane for that peer.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel.endpoints import (
    DeadExecutorError,
    ExecutorEndpoint,
)
from sparkrdma_tpu_torch.parallel.messages import STATUS_CORRUPT, STATUS_OK
from sparkrdma_tpu_torch.parallel.transport import (
    Backoff,
    ChecksumError,
    FetchStatusError,
    TransportError,
)
from sparkrdma_tpu_torch.shuffle.resolver import TpuShuffleBlockResolver
from sparkrdma_tpu_torch.utils.stats import FetchPipelineStats

log = logging.getLogger(__name__)


class _Aborted(Exception):
    """Internal: the consumer abandoned/failed the iteration."""


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
class FetchResult:
    """One successful grouped fetch (or the failure/sentinel marker).

    ``data`` is bytes, or — when a vectored response landed in a pool
    lease — a uint8 numpy view into the shared
    :class:`~sparkrdma_tpu_torch.runtime.pool.RegisteredBuffer` (``lease``).
    Lease-backed results must be :meth:`free`\\ d once consumed so the
    pool buffer returns on last release; ``free`` is a no-op otherwise.
    Use ``len(data)``, not truthiness (ndarray truthiness raises)."""

    map_id: int = -1
    start_partition: int = 0
    end_partition: int = 0
    data: bytes = b""
    is_local: bool = False
    failure: Optional[FetchFailedError] = None
    is_sentinel: bool = False
    lease: Optional[object] = None  # RegisteredBuffer holding `data`'s view
    _free_lock: threading.Lock = field(default_factory=threading.Lock,
                                       repr=False, compare=False)

    def free(self) -> None:
        """Release this result's reference on the shared pool lease.

        Idempotent AND race-safe: the native fetch engine completes
        results from a non-consumer thread, so a consumer ``free`` can
        race an unwind ``free`` — exactly one of them may hand the
        reference back or the pool double-frees the backing buffer."""
        with self._free_lock:
            lease, self.lease = self.lease, None
        if lease is not None:
            lease.release()


@dataclass
class ReadMetrics:
    """Reference: Spark task metrics wiring
    (scala/RdmaShuffleFetcherIterator.scala:104-106, 330-332, 349-361).
    Updated from concurrent peer threads — mutate via the record_* methods."""

    remote_bytes: int = 0
    local_bytes: int = 0
    remote_fetches: int = 0
    local_fetches: int = 0
    fetch_wait_s: float = 0.0
    fetch_latencies_s: List[float] = field(default_factory=list)
    # failure path: transient retries absorbed, CRC mismatches refetched,
    # terminal failures escalated to FetchFailed (stage retry)
    retries: int = 0
    checksum_failures: int = 0
    failed_fetches: int = 0
    # request frames this reducer put on the wire: location RPCs (per-map
    # or batched) + data reads (grouped or vectored), retries included —
    # the RPC-count the coalesced dataplane exists to shrink. The
    # coalescing tier-1 test asserts this drops vs the per-map path.
    requests_per_reduce: int = 0
    # METADATA RPCs only (driver-table/shard syncs + block-location
    # reads) — the count the epoch-versioned location plane exists to
    # zero: a warm superstep over an unchanged shuffle must read as 0
    # here (asserted by the wire-traffic test and the iterative bench).
    metadata_rpcs_per_stage: int = 0
    # location-plane cache hits this reducer resolved without the wire
    location_cache_hits: int = 0
    # warm read-range hits (warm_read_cache): whole partition ranges
    # served from dist_cache without starting a fetch at all
    warm_range_hits: int = 0
    # push-merge dataplane: partitions served by ONE merged-segment read
    # instead of the M-way per-map fan-in, the bytes they carried, and
    # partitions that DEGRADED back to per-map (replica unreachable or
    # its segment failed the entry CRC)
    merged_reads: int = 0
    merged_bytes: int = 0
    merged_fallbacks: int = 0
    # planned-push dataplane: (map, partition) ranges served from the
    # local PushedInputStore — zero metadata RPCs, zero data RPCs — and
    # the bytes they carried. A fully-pushed reducer's whole input reads
    # as pushed here (the pushplan bench and the zero-RPC test assert it).
    pushed_reads: int = 0
    pushed_bytes: int = 0
    # cold table syncs whose shard phase came up short (owner/replica
    # lost or lagging) and burned the driver-authoritative fallback —
    # the partitioned-ownership health signal: sustained nonzero here
    # means the shard fan-in is not actually absorbing reads
    shard_fallbacks: int = 0
    # cold-tier dataplane: partitions restored from tiered blobs (the
    # LAST resolve rung before re-execution), the bytes they carried,
    # and restores that DEGRADED onward (blob missing/rotten/torn —
    # per-partition, down to re-execution of exactly the covered maps)
    tiered_reads: int = 0
    tiered_bytes: int = 0
    tiered_fallbacks: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_remote(self, nbytes: int, latency_s: float) -> None:
        with self._lock:
            self.remote_bytes += nbytes
            self.remote_fetches += 1
            self.fetch_latencies_s.append(latency_s)

    def record_request(self) -> None:
        with self._lock:
            self.requests_per_reduce += 1

    def record_metadata_rpc(self) -> None:
        with self._lock:
            self.metadata_rpcs_per_stage += 1

    def record_location_hit(self, n: int = 1) -> None:
        with self._lock:
            self.location_cache_hits += n

    def record_local(self, nbytes: int) -> None:
        with self._lock:
            self.local_bytes += nbytes
            self.local_fetches += 1

    def record_merged(self, nbytes: int) -> None:
        with self._lock:
            self.merged_reads += 1
            self.merged_bytes += nbytes

    def record_merged_fallback(self) -> None:
        with self._lock:
            self.merged_fallbacks += 1

    def record_pushed(self, nbytes: int) -> None:
        with self._lock:
            self.pushed_reads += 1
            self.pushed_bytes += nbytes

    def record_shard_fallback(self) -> None:
        with self._lock:
            self.shard_fallbacks += 1

    def record_tiered(self, nbytes: int) -> None:
        with self._lock:
            self.tiered_reads += 1
            self.tiered_bytes += nbytes

    def record_tiered_fallback(self) -> None:
        with self._lock:
            self.tiered_fallbacks += 1

    def record_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def record_checksum_failure(self) -> None:
        with self._lock:
            self.checksum_failures += 1

    def record_failure(self) -> None:
        with self._lock:
            self.failed_fetches += 1


@dataclass
class _PendingFetch:
    exec_index: int
    map_id: int
    start_partition: int
    end_partition: int
    blocks: List  # [(buf, offset, length)]
    total_bytes: int


@dataclass
class _VectoredFetch:
    """One coalesced data request: per-map groups merged across maps for
    one peer. ``blocks`` is the request-order concatenation of every
    segment's ranges; the response payload slices back into per-segment
    results positionally, so per-map attribution survives the merge."""

    exec_index: int
    segments: List[_PendingFetch]
    blocks: List  # [(buf, offset, length)] across all segments
    total_bytes: int


class ShuffleFetcher:
    """Iterator of FetchResults for one reducer's partition range."""

    def __init__(self, endpoint: ExecutorEndpoint,
                 resolver: Optional[TpuShuffleBlockResolver],
                 conf: TpuShuffleConf, shuffle_id: int, num_maps: int,
                 start_partition: int, end_partition: int,
                 seed: Optional[int] = None, reader_stats=None, tracer=None,
                 pool=None, map_range=None):
        from sparkrdma_tpu_torch.utils import trace as trace_mod
        self.endpoint = endpoint
        self.resolver = resolver
        self.conf = conf
        # map-range restriction (adaptive reduce planning): a SPLIT task
        # reads its partition from a disjoint [map_start, map_end) slice
        # of the map space — the rest of the fetch machinery (grouping,
        # coalescing, retries, blame) is untouched, it just sees fewer
        # maps. None = the full map space (every pre-planner caller).
        self.map_start, self.map_end = map_range or (0, num_maps)
        if not 0 <= self.map_start <= self.map_end <= num_maps:
            raise ValueError(f"bad map_range ({self.map_start}, "
                             f"{self.map_end}) for {num_maps} maps")
        # staging pool (runtime/pool.py): when present, each vectored
        # response lands in ONE refcounted multi-view RegisteredBuffer
        # lease — many logical blocks, one pool buffer, returned on last
        # consumer release (java/RdmaRegisteredBuffer.java:28-87)
        self.pool = pool
        # tenancy: staging leases charge the shuffle's owning tenant
        self.tenant = (resolver.tenant_of(shuffle_id)
                       if resolver is not None
                       and hasattr(resolver, "tenant_of")
                       else endpoint.tenant_of(shuffle_id)
                       if hasattr(endpoint, "tenant_of") else 0)
        self.reader_stats = reader_stats  # ShuffleReaderStats | None
        self.tracer = tracer or trace_mod.NULL
        self.shuffle_id = shuffle_id
        self.num_maps = num_maps
        self.start_partition = start_partition
        self.end_partition = end_partition
        self.metrics = ReadMetrics()
        # per-peer read-ahead telemetry (depth + queue-wait histograms).
        # When stats collection is on this IS reader_stats.pipeline — one
        # object, one lock per issue, one source of truth in snapshots
        self.pipeline = (reader_stats.pipeline if reader_stats is not None
                         else FetchPipelineStats())
        self._results: "queue.Queue[FetchResult]" = queue.Queue()
        self._expected_results = 0
        self._consumed = 0
        # max_bytes_in_flight gate (:264-276)
        self._in_flight = 0
        self._in_flight_cv = threading.Condition()
        self._failed = False
        self._aborted = threading.Event()
        self._rng = random.Random(seed)
        # retry backoff shares the fetcher seed so a chaos scenario's
        # sleep schedule replays with it
        self._backoff = Backoff.from_conf(conf, rng=random.Random(seed))
        self._threads: List[threading.Thread] = []
        # location-state version this fetch resolved against (stamped by
        # start() from the table sync): cached locations and warm
        # partition ranges store under it, pushed epoch bumps invalidate
        self.epoch = 0
        self._started = False
        self._reducer_bytes_recorded = False
        # push-merge: partitions satisfied by merged-segment reads, per
        # map — the per-map paths (grouping, local short-circuit) skip
        # them so every (map, partition) is served EXACTLY once; the
        # driver table is kept for the merged threads' per-map fallback
        self._skip: Dict[int, set] = {}
        # planned push: partitions with at least one staged pushed range
        # — merged resolution skips them entirely (a merged segment
        # cannot be sliced around the pushed maps; the leftover maps of
        # a partially-pushed partition ride the per-map plane instead)
        self._pushed_parts: set = set()
        self._table = None
        # cold tier: the tiered-directory snapshot this fetch resolved
        # against (sibling-blob fallback consults it on a failed restore)
        self._tiered_dir = None

    # -- setup: plan + launch (initialize/startAsyncRemoteFetches) -------

    def start(self) -> "ShuffleFetcher":
        self._started = True
        # planned push: resolve staged pushed ranges FIRST — before the
        # driver-table sync, before merged segments, before per-map
        # pull. A reducer whose inputs ALL arrived serves entirely from
        # the local PushedInputStore and returns here with ZERO metadata
        # RPCs and ZERO data RPCs; any hole falls through to the
        # ordinary dataplanes below, byte-identically.
        self._resolve_pushed()
        all_parts = set(range(self.start_partition, self.end_partition))
        if all(self._skip.get(m, set()) >= all_parts
               for m in range(self.map_start, self.map_end)):
            self._peer_threads_left = 0
            self._results.put(FetchResult(is_sentinel=True))
            return self
        with self.tracer.span("fetch.driver_table", "fetch",
                              shuffle=self.shuffle_id):
            table, self.epoch = self.endpoint.get_driver_table_v(
                self.shuffle_id, self.num_maps, metrics=self.metrics)
        my_index = self._my_index()
        self._table = table
        # push-merge: resolve merged-segment coverage FIRST — partitions
        # a live replica covers become one sequential vectored read each,
        # and the per-map machinery below only plans what is left
        merged_by_slot = self._resolve_merged(my_index)
        all_parts = set(range(self.start_partition, self.end_partition))
        local_maps: List[int] = []
        by_peer: Dict[int, List[int]] = {}
        # cold tier: maps no earlier rung can serve — never published
        # (full-fleet restart: the fresh table is empty) or published on
        # a slot the membership has TOMBSTONED (authoritative death, not
        # mere lag) — divert to the TIERED rung instead of escalating.
        # Live owners never divert: tiered resolves LAST by precedence.
        cold_maps: List[int] = []
        from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
        cold_on = bool(self.conf.cold_tier)
        members = self.endpoint.members() if cold_on else []
        for m in range(self.map_start, self.map_end):
            if self._skip.get(m, set()) >= all_parts:
                continue  # every partition rides a merged segment
            entry = table.entry(m)
            if entry is None:
                if cold_on:
                    cold_maps.append(m)
                    continue
                raise FetchFailedError(self.shuffle_id, m, -1,
                                       "map output never published")
            _, exec_idx = entry
            if exec_idx == my_index:
                local_maps.append(m)
            elif (cold_on and exec_idx < len(members)
                    and members[exec_idx] == TOMBSTONE):
                cold_maps.append(m)
            else:
                by_peer.setdefault(exec_idx, []).append(m)
        tiered_tasks = self._resolve_tiered(cold_maps, all_parts)

        # Local short-circuit (:327-337): serve directly, count
        # separately — per uncovered contiguous run when merged segments
        # satisfy part of the range.
        for m in local_maps:
            skip = self._skip.get(m, set())
            run_lo = None
            for p in range(self.start_partition, self.end_partition + 1):
                if p < self.end_partition and p not in skip:
                    if run_lo is None:
                        run_lo = p
                    continue
                if run_lo is not None:
                    data = self._local_read(m, run_lo, p, my_index)
                    self.metrics.record_local(len(data))
                    self._expected_results += 1
                    self._results.put(FetchResult(m, run_lo, p, data,
                                                  is_local=True))
                    run_lo = None

        # A freshly-joined reducer can hold driver-table entries referencing
        # executor slots its membership list hasn't caught up to yet (the
        # announce is async); wait for the list to cover the highest slot we
        # need before resolving peers.
        if by_peer:
            try:
                self.endpoint.wait_for_members(
                    max(by_peer) + 1,
                    timeout=self.conf.connect_timeout_ms / 1000)
            except TimeoutError as e:
                raise FetchFailedError(self.shuffle_id, -1, max(by_peer),
                                       f"membership never covered slot: {e}"
                                       ) from e

        # One fetch thread per peer: location reads then grouped data reads.
        # The per-peer thread bounds per-channel outstanding work the way the
        # reference divides sendQueueDepth across cores (:82-83).
        peers = list(by_peer.items())
        self._rng.shuffle(peers)  # randomized order (:74-79)
        count_lock = threading.Lock()
        for exec_idx, maps in peers:
            t = threading.Thread(target=self._fetch_from_peer,
                                 args=(exec_idx, maps, count_lock),
                                 daemon=True,
                                 name=f"fetch-s{self.shuffle_id}-e{exec_idx}")
            self._threads.append(t)
        # Merged-segment threads: one per replica slot, sequential wide
        # reads (already one request per partition — a window buys
        # nothing over the per-slot thread parallelism).
        for slot, entries in sorted(merged_by_slot.items()):
            t = threading.Thread(
                target=self._fetch_merged_from_slot,
                args=(slot, entries, my_index, count_lock),
                daemon=True,
                name=f"fetch-merged-s{self.shuffle_id}-e{slot}")
            self._threads.append(t)
        # Tiered-restore thread: blob reads are local-FS/object GETs with
        # no per-peer channel to parallelize over — one thread drains the
        # whole plan sequentially, same containment contract as a peer.
        if tiered_tasks:
            t = threading.Thread(
                target=self._fetch_tiered,
                args=(tiered_tasks, count_lock),
                daemon=True, name=f"fetch-tiered-s{self.shuffle_id}")
            self._threads.append(t)
        # Expected-result accounting: each peer thread registers its request
        # count before its first enqueue; the sentinel goes in when all
        # threads have finished (tracked by _peer_threads_left).
        self._peer_threads_left = (len(peers) + len(merged_by_slot)
                                   + (1 if tiered_tasks else 0))
        if self._peer_threads_left == 0:
            self._results.put(FetchResult(is_sentinel=True))
        for t in self._threads:
            t.start()
        return self

    def _local_read(self, m: int, lo: int, hi: int,
                    my_index: int) -> bytes:
        """One local short-circuit read under the bounded retry policy
        (transient EIO retries; at-rest rot escalates with a
        corrupt_output verdict so ONLY this map re-executes)."""
        from sparkrdma_tpu_torch.utils.integrity import CorruptOutputError
        attempts = 1 + max(0, self.conf.fetch_retry_budget)
        for attempt in range(attempts):
            try:
                data = self.resolver.local_blocks(self.shuffle_id, m,
                                                  lo, hi)
                break
            except CorruptOutputError as e:
                # our OWN committed output rotted: same demotion as the
                # remote case — re-execute the map (a reread cannot heal
                # persistent rot), don't fail the job
                raise FetchFailedError(
                    self.shuffle_id, m, my_index,
                    f"local map output corrupt at rest: {e}",
                    verdict="corrupt_output") from e
            except OSError as e:
                # transient local disk error: same bounded retry the
                # remote path gets (a remote serve answers the retryable
                # STATUS_ERROR for this) — escalating on the first EIO
                # would recompute every local map elsewhere over a hiccup
                if attempt + 1 >= attempts:
                    raise FetchFailedError(
                        self.shuffle_id, m, my_index,
                        f"local map output unreadable after "
                        f"{attempts} attempt(s): {e}") from e
                self.metrics.record_retry()
                # abort-aware like every other retry wait in this file: a
                # concurrent teardown must not sit out the full backoff
                if self._aborted.wait(self._backoff.delay(attempt)):
                    raise FetchFailedError(
                        self.shuffle_id, m, my_index,
                        "fetch aborted during local read retry") from e
        if data is None:
            raise FetchFailedError(self.shuffle_id, m, my_index,
                                   "local map output missing")
        return data

    def _my_index(self) -> int:
        try:
            return self.endpoint.exec_index()
        except KeyError:
            return -1

    # -- pushed-first resolution (planned-push dataplane) ----------------

    def _resolve_pushed(self) -> None:
        """Serve every (map, partition) range the local PushedInputStore
        staged under the CACHED plan's exact epoch — no wire traffic of
        any kind. Served pairs join ``_skip`` (the same dedupe contract
        as merged segments: every pair is served exactly once) and their
        partitions are excluded from merged resolution. Cache-only plan
        lookup: no cached plan means no pushes were routed here under
        it, so there is nothing to consume — the ordinary dataplanes own
        the stage."""
        store = getattr(self.endpoint, "pushed_store", None)
        if store is None or not self.conf.planned_push:
            return
        plane = getattr(self.endpoint, "location_plane", None)
        plan = plane.plan(self.shuffle_id) if plane is not None else None
        if plan is None:
            return
        epoch = plan.plan_epoch
        need = set(range(self.map_start, self.map_end))
        served = bytes_total = 0
        for p in range(self.start_partition, self.end_partition):
            blobs = store.take(self.shuffle_id, p, epoch)
            if not blobs:
                continue
            self._pushed_parts.add(p)
            for m in sorted(need & set(blobs)):
                data = blobs[m]
                self.metrics.record_pushed(len(data))
                self._expected_results += 1
                self._results.put(FetchResult(m, p, p + 1, data,
                                              is_local=True))
                self._skip.setdefault(m, set()).add(p)
                served += 1
                bytes_total += len(data)
        if served:
            self.tracer.instant("fetch.pushed", "fetch",
                                shuffle=self.shuffle_id, epoch=epoch,
                                ranges=served, bytes=bytes_total)

    # -- merged-segment-first resolution (push-merge dataplane) ----------

    def _resolve_merged(self, my_index: int) -> Dict[int, list]:
        """Pick ONE live merged entry per partition (widest coverage
        first) and build the per-map skip sets. Returns entries grouped
        by hosting slot. Empty when push-merge is off, this is a
        map-range-SPLIT task (a merged segment holds every covered map's
        rows — it cannot be sliced to a map subset), or nothing has
        finalized yet."""
        if not self.conf.push_merge:
            return {}
        if (self.map_start, self.map_end) != (0, self.num_maps):
            return {}
        directory = self.endpoint.get_merged_directory(
            self.shuffle_id, metrics=self.metrics)
        if directory is None:
            return {}
        from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
        members = self.endpoint.members()
        by_slot: Dict[int, list] = {}
        for p in range(self.start_partition, self.end_partition):
            if p in self._pushed_parts:
                # planned push already serves (some of) this partition;
                # a merged segment cannot be sliced around the pushed
                # maps, so the leftovers ride the per-map plane
                continue
            for entry in directory.entries(p):
                s = entry.slot
                if (s != my_index
                        and (s >= len(members) or members[s] == TOMBSTONE
                             or self.endpoint.peer_suspect(s))):
                    continue
                covered = entry.covered_maps(self.num_maps)
                if not covered:
                    continue
                by_slot.setdefault(s, []).append(entry)
                for m in covered:
                    self._skip.setdefault(m, set()).add(p)
                break
        return by_slot

    def _fetch_merged_from_slot(self, slot: int, entries: list,
                                my_index: int,
                                count_lock: threading.Lock) -> None:
        """Drain one replica slot's merged segments: ONE sequential
        vectored read per partition (local when this executor hosts the
        replica), entry-CRC verified; a failed or CRC-bad segment
        DEGRADES to the per-map dataplane for exactly that partition."""
        try:
            peer = None
            if slot != my_index:
                peer = self.endpoint.member_at(slot)
                self.endpoint.watch_peer(slot, peer)
            try:
                for entry in entries:
                    if self._aborted.is_set():
                        raise _Aborted()
                    data = self._merged_segment_data(peer, slot, entry,
                                                     my_index)
                    if data is None:
                        self.metrics.record_merged_fallback()
                        self.tracer.instant(
                            "fetch.merged_fallback", "fetch", peer=slot,
                            partition=entry.partition_id)
                        self._merged_fallback(entry, my_index, count_lock)
                        continue
                    self.metrics.record_merged(len(data))
                    p = entry.partition_id
                    if peer is None:
                        self.metrics.record_local(len(data))
                        with count_lock:
                            self._expected_results += 1
                        self._results.put(FetchResult(-2, p, p + 1, data,
                                                      is_local=True))
                    else:
                        with count_lock:
                            self._expected_results += 1
                        self._results.put(FetchResult(-2, p, p + 1, data))
            finally:
                if peer is not None:
                    self.endpoint.unwatch_peer(slot)
        except _Aborted:
            pass
        except Exception as e:  # noqa: BLE001 — same containment contract
            # as _fetch_from_peer: any thread failure must surface as a
            # FetchFailedError result, never a silent dead thread
            failure = (e if isinstance(e, FetchFailedError) else
                       FetchFailedError(self.shuffle_id, -2, slot,
                                        f"{type(e).__name__}: {e}"))
            self._results.put(FetchResult(failure=failure))
        finally:
            with count_lock:
                self._peer_threads_left -= 1
                last = self._peer_threads_left == 0
                if last:
                    self._results.put(FetchResult(is_sentinel=True))
            if last and self._aborted.is_set():
                self._drain_unconsumed()

    def _merged_segment_data(self, peer, slot: int, entry,
                             my_index: int) -> Optional[bytes]:
        """One merged segment's bytes, or None -> per-map fallback.
        Remote reads get the bounded transient-retry treatment but never
        ESCALATE from here — a dead replica degrades, it does not blame
        the hosting slot's map outputs (it owns none of them); at-rest
        rot (entry-CRC mismatch) degrades immediately (a refetch re-reads
        the same rotted file)."""
        import zlib
        blocks = [(entry.token, off, ln) for off, ln in entry.ranges]

        def crc_ok(data: bytes) -> bool:
            if zlib.crc32(data) == entry.crc32:
                return True
            self.metrics.record_checksum_failure()
            log.warning("merged segment for shuffle %d partition %d on "
                        "slot %d failed its entry CRC; degrading to "
                        "per-map fetch", self.shuffle_id,
                        entry.partition_id, slot)
            return False

        if peer is None:
            parts = []
            for token, off, ln in blocks:
                seg = (self.resolver.read_block(self.shuffle_id, token,
                                                off, ln)
                       if self.resolver is not None else None)
                if seg is None:
                    return None
                parts.append(seg)
            data = b"".join(parts)
            return data if crc_ok(data) else None
        attempts = 1 + max(0, self.conf.fetch_retry_budget)
        total = sum(ln for _, _, ln in blocks)
        # the in-flight byte gate covers merged reads like every other
        # remote fetch; the consumer's dequeue releases on success, every
        # other exit releases here
        self._acquire_in_flight(total)
        delivered = False
        try:
            data = None
            for attempt in range(attempts):
                if self._aborted.is_set():
                    raise _Aborted()
                if self.endpoint.peer_suspect(slot):
                    return None
                try:
                    self.metrics.record_request()
                    t0 = time.monotonic()
                    with self.tracer.span("fetch.merged", "fetch",
                                          peer=slot,
                                          partition=entry.partition_id,
                                          bytes=total):
                        data = self.endpoint.fetch_blocks(
                            peer, self.shuffle_id, blocks)
                    dt = time.monotonic() - t0
                    self.metrics.record_remote(len(data), dt)
                    if self.reader_stats is not None:
                        self.reader_stats.update(slot, dt,
                                                 nbytes=len(data))
                    break
                except (TransportError, TimeoutError) as e:
                    self._note_transient(e, "merged", slot,
                                         -2, attempt + 1 < attempts,
                                         attempt + 1)
                    if attempt + 1 >= attempts:
                        return None
                    if self._aborted.wait(self._backoff.delay(attempt)):
                        raise _Aborted()
            if data is None or not crc_ok(data):
                return None
            delivered = True
            return data
        finally:
            if not delivered:
                self._release_in_flight(total)

    def _merged_fallback(self, entry, my_index: int,
                         count_lock: threading.Lock) -> None:
        """Per-map fetch of ONE partition whose merged segment degraded:
        each covered map's bytes come from its table owner under the
        ordinary retry envelope, so blame and recovery semantics are
        exactly the per-map dataplane's (a dead owner escalates into
        FetchFailed -> recovery, which may re-point to ANOTHER replica)."""
        p = entry.partition_id
        for m in entry.covered_maps(self.num_maps):
            if not self.map_start <= m < self.map_end:
                continue
            e = self._table.entry(m)
            if e is None:
                raise FetchFailedError(self.shuffle_id, m, -1,
                                       "map output never published")
            owner = e[1]
            if owner == my_index:
                data = self._local_read(m, p, p + 1, my_index)
                self.metrics.record_local(len(data))
                with count_lock:
                    self._expected_results += 1
                self._results.put(FetchResult(m, p, p + 1, data,
                                              is_local=True))
                continue
            try:
                owner_peer = self.endpoint.member_at(owner)
            except DeadExecutorError as exc:
                raise FetchFailedError(
                    self.shuffle_id, m, owner,
                    f"merged replica degraded and owner tombstoned: "
                    f"{exc}") from exc

            def read_locs(m=m, owner_peer=owner_peer):
                self.metrics.record_request()
                self.metrics.record_metadata_rpc()
                return self.endpoint.fetch_output_range(
                    owner_peer, self.shuffle_id, m, p, p + 1)

            locs = self._with_retries("locations", owner, m, read_locs)
            blocks = [(loc.buf, loc.offset, loc.length) for loc in locs]
            nbytes = sum(b[2] for b in blocks)
            self._acquire_in_flight(nbytes)

            def read_blocks(m=m, owner_peer=owner_peer, blocks=blocks):
                self.metrics.record_request()
                return self.endpoint.fetch_blocks(
                    owner_peer, self.shuffle_id, blocks)

            try:
                data = self._with_retries("blocks", owner, m, read_blocks)
            except BaseException:
                self._release_in_flight(nbytes)
                raise
            self.metrics.record_remote(len(data), 0.0)
            with count_lock:
                self._expected_results += 1
            self._results.put(FetchResult(m, p, p + 1, data))

    # -- tiered (cold) resolution: the LAST rung before re-execution -----

    def _resolve_tiered(self, cold_maps: List[int], all_parts: set):
        """Plan the TIERED rung for maps no earlier rung can serve.

        Per partition, greedily pick blob entries (widest coverage
        first) whose ENTIRE covered map set is still needed there — a
        blob is the concatenation of all its covered maps' rows and
        cannot be sliced to a subset, exactly like a merged segment; an
        entry overlapping a map some earlier rung already serves is
        unusable (precedence: live owners never resolve tiered). A
        (map, partition) pair left uncovered escalates NOW as
        FetchFailedError — the rung below tiered is re-execution.

        Returns ``[(partition, entry, covered_maps)]`` restore tasks."""
        if not cold_maps:
            return []
        directory = self.endpoint.get_tiered_directory(
            self.shuffle_id, metrics=self.metrics)
        self._tiered_dir = directory
        need: Dict[int, set] = {
            m: {p for p in all_parts if p not in self._skip.get(m, set())}
            for m in cold_maps}
        tasks: List = []
        if directory is not None:
            for p in range(self.start_partition, self.end_partition):
                for entry in directory.entries(p):
                    covered = entry.covered_maps(self.num_maps)
                    if not covered:
                        continue
                    if any(m not in need or p not in need[m]
                           for m in covered):
                        continue  # overlaps a served map: unusable
                    tasks.append((p, entry, tuple(covered)))
                    for m in covered:
                        need[m].discard(p)
                        self._skip.setdefault(m, set()).add(p)
        for m in sorted(need):
            if need[m]:
                raise FetchFailedError(
                    self.shuffle_id, m, -1,
                    "map output never published and no cold coverage "
                    f"(partitions {sorted(need[m])})")
        return tasks

    def _blob_store(self):
        """The blob store for restores: the installed TieringService's
        (one handle per process) or a fresh one off the conf — a pure
        reducer (no merge role) still restores."""
        svc = getattr(self.endpoint, "tiering", None)
        if svc is not None and getattr(svc, "store", None) is not None:
            return svc.store
        from sparkrdma_tpu_torch.shuffle.cold_tier import open_store
        return open_store(self.conf)

    def _fetch_tiered(self, tasks: List,
                      count_lock: threading.Lock) -> None:
        """Drain the tiered-restore plan: one blob GET per task under
        the bounded retry envelope, whole-blob CRC verified against the
        ledger CRC the entry carries. A missing/rotten/torn blob first
        tries a SIBLING blob with identical coverage (another merge
        target's upload of the same partition), then escalates as
        FetchFailedError blaming a covered map — the rung below is
        re-execution of exactly that map set, never corrupt output."""
        try:
            store = self._blob_store()
            if store is None:
                raise FetchFailedError(
                    self.shuffle_id, tasks[0][2][0] if tasks else -1, -1,
                    "cold tier unavailable (no blob store)")
            for p, entry, maps_served in tasks:
                if self._aborted.is_set():
                    raise _Aborted()
                data = self._tiered_blob_data(store, p, entry,
                                              maps_served)
                self.metrics.record_tiered(len(data))
                self.tracer.instant("fetch.tiered", "fetch",
                                    shuffle=self.shuffle_id, partition=p,
                                    bytes=len(data))
                self._emit_tiered(p, data, count_lock)
        except _Aborted:
            pass
        except Exception as e:  # noqa: BLE001 — same containment as the
            # peer threads: any failure surfaces as a result, never a
            # silent dead thread
            failure = (e if isinstance(e, FetchFailedError) else
                       FetchFailedError(self.shuffle_id, -3, -1,
                                        f"{type(e).__name__}: {e}"))
            self._results.put(FetchResult(failure=failure))
        finally:
            with count_lock:
                self._peer_threads_left -= 1
                last = self._peer_threads_left == 0
                if last:
                    self._results.put(FetchResult(is_sentinel=True))
            if last and self._aborted.is_set():
                self._drain_unconsumed()

    def _tiered_blob_data(self, store, p: int, entry,
                          maps_served) -> bytes:
        """One task's verified bytes. Store unavailability retries with
        backoff (the same transient envelope remote fetches get); a CRC
        mismatch or absence moves to the next candidate immediately (a
        re-get re-reads the same rotted bytes; absence is
        authoritative — the blob was reaped)."""
        import zlib
        candidates = [entry]
        directory = getattr(self, "_tiered_dir", None)
        if directory is not None:
            want = set(maps_served)
            candidates += [
                e for e in directory.entries(p)
                if e.blob_key != entry.blob_key
                and set(e.covered_maps(self.num_maps)) == want]
        attempts = 1 + max(0, self.conf.fetch_retry_budget)
        last_err = "no candidate blob"
        for cand in candidates:
            for attempt in range(attempts):
                if self._aborted.is_set():
                    raise _Aborted()
                try:
                    blob = store.get(cand.blob_key)
                except KeyError:
                    last_err = f"blob {cand.blob_key} absent (reaped?)"
                    break
                except OSError as e:
                    last_err = f"blob {cand.blob_key} unreadable: {e}"
                    if attempt + 1 < attempts:
                        self.metrics.record_retry()
                        if self._aborted.wait(self._backoff.delay(attempt)):
                            raise _Aborted()
                    continue
                if (len(blob) == cand.nbytes
                        and zlib.crc32(blob) == cand.crc32 & 0xFFFFFFFF):
                    return blob
                self.metrics.record_checksum_failure()
                last_err = f"blob {cand.blob_key} failed its ledger CRC"
                log.warning("tiered blob for shuffle %d partition %d "
                            "failed verification (%s); degrading",
                            self.shuffle_id, p, last_err)
                break
        self.metrics.record_tiered_fallback()
        # "cold_unusable": every candidate blob for this partition was
        # rotten, torn, or gone — recovery must NOT re-point the map
        # back at the same directory entries (that would retry the same
        # dead blob forever); re-executing publishes a repair, which
        # drops the bad entries driver-side
        raise FetchFailedError(
            self.shuffle_id, maps_served[0], -1,
            f"tiered restore of partition {p} failed: {last_err}",
            verdict="cold_unusable")

    def _emit_tiered(self, p: int, data: bytes,
                     count_lock: threading.Lock) -> None:
        """One restored partition through the ordinary pool-leased
        landing: the blob's bytes copy into ONE RegisteredBuffer lease
        (BufferPool accounting, tenant-charged) exactly like a vectored
        response; no pool means plain bytes. map_id -3 marks the cold
        dataplane (merged reads use -2)."""
        payload, lease = data, None
        if self.pool is not None and len(data):
            lease = self.pool.get_registered(len(data),
                                             tenant=self.tenant)
            view = lease.slice(len(data))
            view[:] = np.frombuffer(data, dtype=np.uint8)
            payload = view
        with count_lock:
            self._expected_results += 1
        self._results.put(FetchResult(-3, p, p + 1, payload,
                                      is_local=True, lease=lease))
        if lease is not None:
            lease.release()

    # -- per-peer fetch pipeline ----------------------------------------

    def _fetch_from_peer(self, exec_idx: int, maps: List[int],
                         count_lock: threading.Lock) -> None:
        try:
            peer = self.endpoint.member_at(exec_idx)
            depth = self.conf.resolved_read_ahead_depth()
            # register heartbeat interest for the duration of the fetch:
            # if the peer dies silently mid-window, the monitor closes the
            # connection (failing the window NOW) and marks the slot
            # suspect so the retry envelope escalates instead of re-dialing
            self.endpoint.watch_peer(exec_idx, peer)
            try:
                served = False
                if self.conf.coalesce_reads:
                    served = self._fetch_coalesced(peer, exec_idx, maps,
                                                   count_lock, depth)
                if not served:
                    if depth <= 1:
                        self._fetch_sequential(peer, exec_idx, maps,
                                               count_lock)
                    else:
                        self._fetch_pipelined(peer, exec_idx, maps,
                                              count_lock, depth)
            finally:
                self.endpoint.unwatch_peer(exec_idx)
        except _Aborted:
            pass  # consumer went away; exit quietly
        except Exception as e:  # noqa: BLE001 — ANY peer-thread failure must
            # surface as a FetchFailedError result, never a silent dead
            # thread (which would truncate the reduce input undetected)
            failure = (e if isinstance(e, FetchFailedError) else
                       FetchFailedError(self.shuffle_id,
                                        maps[0] if maps else -1,
                                        exec_idx, f"{type(e).__name__}: {e}"))
            self._results.put(FetchResult(failure=failure))
        finally:
            with count_lock:
                self._peer_threads_left -= 1
                last = self._peer_threads_left == 0
                if last:
                    self._results.put(FetchResult(is_sentinel=True))
            # an aborted iteration stops consuming: once nothing more
            # can be enqueued, pool leases parked in the queue must be
            # returned (close() drains too, but a completion racing it
            # can land after that drain — this one cannot be raced)
            if last and self._aborted.is_set():
                self._drain_unconsumed()

    def _group_locations(self, exec_idx: int, m: int,
                         locs) -> List[_PendingFetch]:
        """STEP 3 grouping: consecutive partitions, ≤ read block size
        (:240-263). Zero-length blocks ride along byte-free but still
        count toward a block-count bound so a wide, mostly-empty
        partition range can't build a request frame past the native
        server's inbound frame cap — the bound is DERIVED from that cap
        (csrc/blockserver.cpp kMaxReqFrame via
        ``resolved_max_fetch_blocks``), not a constant that can drift
        from the C++ limit."""
        pending: List[_PendingFetch] = []
        group: List = []
        group_start = self.start_partition
        group_bytes = 0
        limit = self.conf.shuffle_read_block_size
        max_blocks = self.conf.resolved_max_fetch_blocks()
        # push-merge: partitions a merged segment already serves are
        # skipped (groups seal at the hole so ranges stay contiguous).
        # getattr: unit tests build bare fetchers around this method
        skip = getattr(self, "_skip", {}).get(m, ())
        for i, loc in enumerate(locs):
            p = self.start_partition + i
            if p in skip:
                if group:
                    pending.append(_PendingFetch(
                        exec_idx, m, group_start, p, group, group_bytes))
                    group, group_bytes = [], 0
                group_start = p + 1
                continue
            if group and (group_bytes + loc.length > limit
                          or len(group) >= max_blocks):
                pending.append(_PendingFetch(
                    exec_idx, m, group_start, p, group, group_bytes))
                group, group_start, group_bytes = [], p, 0
            group.append((loc.buf, loc.offset, loc.length))
            group_bytes += loc.length
        if group:
            pending.append(_PendingFetch(
                exec_idx, m, group_start,
                self.start_partition + len(locs), group, group_bytes))
        return pending

    # -- coalesced dataplane (per-peer batching at both levels) ----------

    def _coalesce_plan(self, exec_idx: int,
                       groups: List[_PendingFetch]) -> List[_VectoredFetch]:
        """Merge per-map groups bound for one peer into vectored requests
        of at most ``max_vectored_bytes`` (floored at the per-map read
        block size — coalescing must never shrink a request the per-map
        planner would have sent whole) and the frame-derived block-count
        cap. A single oversized group still rides alone, preserving the
        per-map path's single-oversized-fetch escape."""
        # clamp to what the servers will actually serve: multi-block
        # responses past max(256 MiB, read block size) are answered
        # BAD_RANGE — authoritative, so an oversized plan would re-fail
        # identically on every stage retry (endpoints._MAX_RESP_PAYLOAD,
        # csrc kMaxRespPayload)
        from sparkrdma_tpu_torch.parallel.endpoints import ExecutorEndpoint
        limit = max(min(self.conf.max_vectored_bytes,
                        ExecutorEndpoint._MAX_RESP_PAYLOAD),
                    self.conf.shuffle_read_block_size)
        max_blocks = self.conf.resolved_max_fetch_blocks()
        plan: List[_VectoredFetch] = []
        cur: List[_PendingFetch] = []
        cur_bytes = cur_blocks = 0

        def seal():
            plan.append(_VectoredFetch(
                exec_idx, list(cur), [b for s in cur for b in s.blocks],
                cur_bytes))

        for g in groups:
            if cur and (cur_bytes + g.total_bytes > limit
                        or cur_blocks + len(g.blocks) > max_blocks):
                seal()
                cur, cur_bytes, cur_blocks = [], 0, 0
            cur.append(g)
            cur_bytes += g.total_bytes
            cur_blocks += len(g.blocks)
        if cur:
            seal()
        return plan

    def _fetch_coalesced(self, peer, exec_idx: int, maps: List[int],
                         count_lock: threading.Lock, depth: int) -> bool:
        """The coalesced dataplane for one peer: ONE batched location RPC
        (chunked only past the endpoint's response-size bound), then
        vectored cross-map data reads through the read-ahead window.
        Returns False — caller falls back to the per-map dataplane —
        when the first batched call fails at the transport level TWICE
        (one guarded retry absorbs a transient blip): a mixed-version
        peer doesn't know the frame type and tears the connection down
        on every attempt, which lands here as TransportErrors. Later
        failures ride the normal retry envelope (the peer has already
        proven it speaks the batched protocol)."""
        # cache-first resolution (location_plane): maps whose entries are
        # already held under the current epoch never touch the wire —
        # the warm path resolves the WHOLE peer from cache and issues
        # zero metadata RPCs
        plane = self.endpoint.location_plane
        locs_by_map: Dict[int, List] = {}
        uncached: List[int] = []
        for m in maps:
            locs = plane.locations(self.shuffle_id, m,
                                   self.start_partition, self.end_partition)
            if locs is None:
                uncached.append(m)
            else:
                locs_by_map[m] = locs
        if locs_by_map:
            self.metrics.record_location_hit(len(locs_by_map))
        per = self.endpoint.outputs_batch_maps(self.start_partition,
                                               self.end_partition)
        try:
            for i in range(0, len(uncached), per):
                chunk = uncached[i:i + per]

                def read_chunk(chunk=chunk):
                    self.metrics.record_request()
                    self.metrics.record_metadata_rpc()
                    with self.tracer.span("fetch.locations", "fetch",
                                          peer=exec_idx, maps=len(chunk),
                                          batched=True):
                        return self.endpoint.fetch_outputs(
                            peer, self.shuffle_id, chunk,
                            self.start_partition, self.end_partition)

                if i == 0:
                    self._suspect_check(exec_idx, chunk[0])
                    try:
                        fetched = read_chunk()
                    except FetchStatusError:
                        raise
                    except (TransportError, TimeoutError) as e:
                        # one guarded retry separates a transient blip
                        # from a genuine mixed-version peer: demoting a
                        # new-version peer to the per-map dataplane over
                        # one dropped connection would silently erase the
                        # RPC reduction for the whole reduce. A zero
                        # retry budget means fail-fast everywhere — honor
                        # it here too (straight to the per-map fallback)
                        if self.conf.fetch_retry_budget <= 0:
                            raise
                        self._suspect_check(exec_idx, chunk[0])
                        self._note_transient(e, "locations", exec_idx,
                                             chunk[0], True, 1)
                        if self._aborted.wait(self._backoff.delay(0)):
                            raise _Aborted()
                        fetched = read_chunk()
                else:
                    fetched = self._with_retries(
                        "locations", exec_idx, chunk[0], read_chunk)
                locs_by_map.update(fetched)
                for m, locs in fetched.items():
                    plane.put_locations(self.shuffle_id, m,
                                        self.start_partition,
                                        self.end_partition, locs,
                                        self.epoch)
        except FetchStatusError as e:
            # authoritative per-map answer (unknown map / bad range): the
            # per-map path would re-fail identically — escalate now
            # (_fail blames the exact map the peer named when the status
            # carries one)
            self._fail("locations", exec_idx, maps[0], 1, e)
        except (TransportError, TimeoutError) as e:
            # a suspect verdict is what FAILED the batched call (the
            # monitor closed the connection under it): falling back would
            # re-dial a fresh connection the monitor never closes and
            # wait out the full request deadline — escalate now instead
            self._suspect_check(exec_idx, maps[0])
            log.debug("batched location fetch from peer %d failed (%s); "
                      "falling back to the per-map dataplane", exec_idx, e)
            self.tracer.instant("fetch.coalesce_fallback", "fetch",
                                peer=exec_idx, error=type(e).__name__)
            return False
        groups: List[_PendingFetch] = []
        for m in maps:
            groups.extend(self._group_locations(exec_idx, m,
                                                locs_by_map[m]))
        plan = self._coalesce_plan(exec_idx, groups)
        # randomized issue order (:74-79), at vectored-request granularity
        self._rng.shuffle(plan)
        with count_lock:
            self._expected_results += sum(len(v.segments) for v in plan)
        # 4th resolution engine: the native client (csrc/fetchclient.cpp)
        # lands response payloads directly in lease memory — engaged only
        # where the wire bytes ARE the lease bytes (native block port, no
        # wire compression/codec, pool present). Declines (engine not
        # built, connect failure) fall through to the Python dispatch.
        if (self._native_fetch_usable(peer)
                and self._fetch_vectored_native(peer, exec_idx, plan,
                                                depth)):
            return True
        if depth <= 1:
            self._fetch_vectored_sequential(peer, exec_idx, plan)
        else:
            self._fetch_vectored_windowed(peer, exec_idx, plan, depth)
        return True

    def _fetch_vectored_sequential(self, peer, exec_idx: int,
                                   plan: List[_VectoredFetch]) -> None:
        for vf in plan:
            if self._aborted.is_set():
                raise _Aborted()
            # same pre-issue fail-fast as the windowed path: the first
            # attempt dials outside the retry envelope, and a fresh
            # post-verdict connection is one the monitor never closes
            self._suspect_check(exec_idx, vf.segments[0].map_id)
            self._acquire_in_flight(vf.total_bytes)
            t0 = time.monotonic()
            try:
                with self.tracer.span("fetch.vectored", "fetch",
                                      peer=exec_idx,
                                      maps=len(vf.segments),
                                      blocks=len(vf.blocks),
                                      bytes=vf.total_bytes):
                    data = self._vectored_data(peer, exec_idx, vf)
            except BaseException:
                self._release_in_flight(vf.total_bytes)
                raise
            dt = time.monotonic() - t0
            self.metrics.record_remote(len(data), dt)
            if self.reader_stats is not None:
                self.reader_stats.update(exec_idx, dt, nbytes=len(data))
            self._emit_vectored(vf, data)

    def _fetch_vectored_windowed(self, peer, exec_idx: int,
                                 plan: List[_VectoredFetch],
                                 depth: int) -> None:
        """The read-ahead window over vectored requests: locations are
        already in hand (one batched RPC), so the window carries only
        STEP-3 data reads — same budget interplay as the per-map
        pipelined path (never block on the byte gate while holding
        completions)."""
        ready: deque = deque((vf, time.monotonic()) for vf in plan)
        inflight: deque = deque()  # (vf, AsyncFetch, t_ready, t_issue)
        try:
            while ready or inflight:
                if self._aborted.is_set():
                    raise _Aborted()
                while ready and len(inflight) < depth:
                    vf, t_ready = ready[0]
                    # never issue into a suspect peer: a request on a
                    # fresh post-verdict connection would wait out its
                    # whole deadline (the monitor only closes cached
                    # connections once, at verdict time)
                    self._suspect_check(exec_idx, vf.segments[0].map_id)
                    if not self._try_acquire_in_flight(
                            vf.total_bytes, nonblocking=bool(inflight)):
                        break
                    ready.popleft()
                    t_issue = time.monotonic()
                    self.metrics.record_request()
                    handle = self.endpoint.fetch_blocks_async(
                        peer, self.shuffle_id, vf.blocks)
                    inflight.append((vf, handle, t_ready, t_issue))
                    self.pipeline.record_issue(exec_idx, len(inflight),
                                               t_issue - t_ready)
                if inflight:
                    self._complete_oldest_vectored(peer, exec_idx, inflight)
        except BaseException:
            # same unwind contract as _fetch_pipelined: window-held budget
            # and send-budget slots must not outlive the window
            for vf, handle, _tr, _ti in inflight:
                handle.cancel()
                self._release_in_flight(vf.total_bytes)
            raise

    def _complete_oldest_vectored(self, peer, exec_idx: int,
                                  inflight: deque) -> None:
        vf, handle, t_ready, t_issue = inflight[0]
        wire_done_s = None
        try:
            data = handle.result()
            wire_done_s = handle.wire_done_s
        except (TransportError, TimeoutError, AssertionError) as e:
            inflight.popleft()
            t_issue = time.monotonic()  # latency covers the serving retry
            try:
                data = self._vectored_data(peer, exec_idx, vf,
                                           first_error=e)
            except BaseException:
                self._release_in_flight(vf.total_bytes)
                raise
        else:
            inflight.popleft()
        now = time.monotonic()
        dt = now - t_issue
        self.metrics.record_remote(len(data), dt)
        if self.reader_stats is not None:
            self.reader_stats.update(exec_idx, dt, nbytes=len(data))
        if self.tracer.enabled:
            end_us = self.tracer.now_us()
            issue_us = end_us - (now - t_issue) * 1e6
            ready_us = end_us - (now - t_ready) * 1e6
            wire_us = (end_us - (now - wire_done_s) * 1e6
                       if wire_done_s is not None else end_us)
            wire_us = min(max(wire_us, issue_us), end_us)
            map0 = vf.segments[0].map_id
            # the per-map pipelined path's issue→wire→complete contract
            # is kept (one trace schema either way); fetch.vectored adds
            # the coalescing shape on top
            self.tracer.complete_span("fetch.issue", "fetch",
                                      ready_us, issue_us,
                                      map=map0, peer=exec_idx)
            self.tracer.complete_span("fetch.blocks", "fetch",
                                      issue_us, wire_us, map=map0,
                                      peer=exec_idx, bytes=vf.total_bytes)
            self.tracer.complete_span("fetch.complete", "fetch",
                                      wire_us, end_us,
                                      map=map0, peer=exec_idx)
            self.tracer.complete_span("fetch.vectored", "fetch",
                                      issue_us, end_us, peer=exec_idx,
                                      maps=len(vf.segments),
                                      blocks=len(vf.blocks),
                                      bytes=vf.total_bytes)
        self._emit_vectored(vf, data)

    # -- native client engine (csrc/fetchclient.cpp) ---------------------

    def _native_fetch_usable(self, peer) -> bool:
        """The native engine engages only where the wire bytes are
        already exactly the lease bytes: a pool to lease from, the peer
        advertising a native block port, and nothing (compression, wire
        codec) transforming payloads between the wire and the reader."""
        if not (self.conf.native_fetch and self.pool is not None):
            return False
        if not getattr(peer, "block_port", 0) or self.conf.wire_compress:
            return False
        if getattr(self.endpoint, "_codec", None) is not None:
            return False
        from sparkrdma_tpu_torch.shuffle.native_fetch import NativeFetchEngine
        return NativeFetchEngine.available()

    def _fetch_vectored_native(self, peer, exec_idx: int,
                               plan: List[_VectoredFetch],
                               depth: int) -> bool:
        """Drive one peer's vectored plan through the native client
        engine: requests are doorbell-batched (one writev carries up to
        ``fetch_doorbell_batch`` frames) and each response payload is
        scattered by the C epoll loop straight into a pool lease — no
        Python bytes object, no copy; ``_emit_vectored_lease`` just
        hands out views. CRC trailers verify in C.

        Returns False only before any request was consumed (engine not
        built, dial failed) — the caller then runs the ordinary Python
        dispatch. Once engaged it always returns True: happy-path
        requests complete natively, and ANY anomaly (connection death,
        truncation, CRC mismatch, non-OK status) re-runs that request
        through ``_vectored_data``'s retry/suspect/checksum envelope,
        so failure behavior stays byte-identical with the Python path.
        A dead connection degrades the not-yet-issued remainder of the
        plan to the Python dispatch too."""
        from sparkrdma_tpu_torch.shuffle import native_fetch as nf
        try:
            eng = nf.NativeFetchEngine()
        except RuntimeError:
            return False
        conn = eng.connect(peer.rpc_host, peer.block_port,
                           timeout_ms=self.conf.connect_timeout_ms)
        if not conn:
            eng.close()
            return False
        deadline_s = self.conf.resolved_request_deadline_s()
        batch = max(1, self.conf.fetch_doorbell_batch)
        window = max(1, depth)
        ready: deque = deque(plan)
        outstanding: Dict[int, tuple] = {}  # req_id -> (vf, lease, t_issue)
        next_req = 1
        unsent = 0
        try:
            while (ready and eng.alive(conn)) or outstanding:
                if self._aborted.is_set():
                    raise _Aborted()
                while (ready and len(outstanding) < window
                       and eng.alive(conn)):
                    vf = ready[0]
                    # same pre-issue fail-fast as the Python paths
                    self._suspect_check(exec_idx, vf.segments[0].map_id)
                    if not self._try_acquire_in_flight(
                            vf.total_bytes,
                            nonblocking=bool(outstanding)):
                        break
                    ready.popleft()
                    lease = addr = None
                    if vf.total_bytes:
                        lease = self.pool.get_registered(vf.total_bytes,
                                                         tenant=self.tenant)
                        addr = lease._buf.view.ctypes.data
                    req_id, next_req = next_req, next_req + 1
                    self.metrics.record_request()
                    t_issue = time.monotonic()
                    rc = eng.submit(conn, req_id, self.shuffle_id,
                                    vf.blocks, addr, vf.total_bytes)
                    if rc != 0:
                        # rejected before the wire (dead conn, frame too
                        # big): this request runs through the Python
                        # envelope; the rest keep their native path
                        if lease is not None:
                            lease.release()
                        self._vectored_fallback(
                            peer, exec_idx, vf,
                            TransportError(
                                f"native fetch submit failed rc={rc}"),
                            t_issue)
                        continue
                    outstanding[req_id] = (vf, lease, t_issue)
                    unsent += 1
                    if unsent >= batch:
                        eng.flush()
                        unsent = 0
                if unsent:
                    eng.flush()  # ring the doorbell on a partial batch
                    unsent = 0
                if not outstanding:
                    continue
                comps = eng.poll(timeout_ms=50)
                now = time.monotonic()
                for c in comps:
                    ent = outstanding.pop(c.req_id, None)
                    if ent is not None:
                        vf, lease, t_issue = ent
                        self._finish_native(peer, exec_idx, vf, lease, c,
                                            now - t_issue)
                if outstanding and not comps:
                    oldest = min(t for _v, _l, t in outstanding.values())
                    if now - oldest > deadline_s:
                        # server stalled under the oldest request: kill
                        # the connection — every in-flight request fails
                        # over to the Python envelope via its kErrConn
                        # completion, the unissued rest degrade below
                        eng.close_conn(conn)
        except BaseException:
            # unwind contract: window budget and leases held by requests
            # that will never complete must not outlive this call
            for vf, lease, _t in outstanding.values():
                if lease is not None:
                    lease.release()
                self._release_in_flight(vf.total_bytes)
            raise
        finally:
            eng.close()
        if ready:  # connection died: Python dispatch for the remainder
            leftovers = list(ready)
            if depth <= 1:
                self._fetch_vectored_sequential(peer, exec_idx, leftovers)
            else:
                self._fetch_vectored_windowed(peer, exec_idx, leftovers,
                                              depth)
        return True

    def _finish_native(self, peer, exec_idx: int, vf: _VectoredFetch,
                       lease, comp, dt: float) -> None:
        """Settle one native completion: emit zero-copy on the happy
        path, otherwise release the lease and re-run the request through
        the Python envelope (which re-classifies the failure itself —
        per-block CRC blame, corrupt-output isolation, retry budget)."""
        if (comp.status == STATUS_OK and comp.crc_state >= 0
                and comp.nbytes == vf.total_bytes):
            self.metrics.record_remote(vf.total_bytes, dt)
            if self.reader_stats is not None:
                self.reader_stats.update(exec_idx, dt,
                                         nbytes=vf.total_bytes)
            if self.tracer.enabled:
                end_us = self.tracer.now_us()
                issue_us = end_us - dt * 1e6
                self.tracer.complete_span("fetch.vectored", "fetch",
                                          issue_us, end_us, peer=exec_idx,
                                          maps=len(vf.segments),
                                          blocks=len(vf.blocks),
                                          bytes=vf.total_bytes,
                                          native=True)
            self._emit_vectored_lease(vf, lease)
            return
        if lease is not None:
            lease.release()
        if comp.crc_state < 0:
            # C-side CRC mismatch: the Python refetch re-verifies and —
            # if the rot persists — raises the per-block ChecksumError
            # the heal path wants, so blame lands on the right map
            self.metrics.record_checksum_failure()
            err = None
        elif comp.status > 0:
            # the server named a status: refetch fresh so the Python
            # client classifies it (BAD_RANGE size-cap retry, CORRUPT
            # isolation) exactly as it would its own response
            err = None
        else:
            err = TransportError("native fetch engine: connection "
                                 f"failed (status {comp.status})")
        self._vectored_fallback(peer, exec_idx, vf, err, time.monotonic())

    def _vectored_fallback(self, peer, exec_idx: int, vf: _VectoredFetch,
                           err: Optional[BaseException],
                           t_issue: float) -> None:
        """Re-run one request through the Python envelope — the same
        contract torn async fetches use in _complete_oldest_vectored."""
        try:
            data = self._vectored_data(peer, exec_idx, vf,
                                       first_error=err)
        except BaseException:
            self._release_in_flight(vf.total_bytes)
            raise
        dt = time.monotonic() - t_issue
        self.metrics.record_remote(len(data), dt)
        if self.reader_stats is not None:
            self.reader_stats.update(exec_idx, dt, nbytes=len(data))
        self._emit_vectored(vf, data)

    def _emit_vectored_lease(self, vf: _VectoredFetch, lease) -> None:
        """Slice per-(map, range) results off an ALREADY-FILLED lease:
        the native engine scattered the response payload into the
        lease's backing buffer in request order, the same order
        ``slice`` bump-allocates — handing out views is the whole job.
        ``lease`` is None only for an all-empty request."""
        for seg in vf.segments:
            payload = (lease.slice(seg.total_bytes)
                       if lease is not None else b"")
            self._results.put(FetchResult(
                seg.map_id, seg.start_partition, seg.end_partition,
                payload, lease=lease))
        if lease is not None:
            lease.release()  # creator's ref; results hold theirs

    def _vectored_data(self, peer, exec_idx: int, vf: _VectoredFetch,
                       first_error: Optional[BaseException] = None) -> bytes:
        """The payload of one vectored request, healed: a CRC failure
        that names its bad blocks refetches ONLY the affected segments
        (per-map blame); anything else retries whole-request under the
        envelope, blamed on the request's first map."""

        def read_all():
            self.metrics.record_request()
            return self.endpoint.fetch_blocks(peer, self.shuffle_id,
                                              vf.blocks)

        err = first_error
        if err is None:
            try:
                return read_all()
            except (TransportError, TimeoutError, AssertionError) as e:
                err = e
        if (isinstance(err, ChecksumError) and err.bad_blocks is not None
                and err.body is not None and len(vf.segments) > 1):
            return self._heal_vectored(peer, exec_idx, vf, err)
        if (isinstance(err, FetchStatusError)
                and err.status == STATUS_CORRUPT and len(vf.segments) > 1):
            return self._isolate_corrupt_vectored(peer, exec_idx, vf)
        return self._with_retries("blocks", exec_idx,
                                  vf.segments[0].map_id, read_all,
                                  first_error=err)

    def _isolate_corrupt_vectored(self, peer, exec_idx: int,
                                  vf: _VectoredFetch) -> bytes:
        """A server-side at-rest CORRUPT verdict covers a whole vectored
        response (the serve aborts before sending any torn byte), so a
        multi-map request can't tell WHICH map's committed output rotted.
        Refetch each segment alone: healthy maps keep their bytes, and
        the corrupt one fails under the envelope with ITS map charged —
        the re-execution (corrupt_output verdict) then recomputes exactly
        the rotten output, not the first map that happened to share the
        frame."""
        parts: List[bytes] = []
        for seg in vf.segments:

            def refetch(seg=seg):
                self.metrics.record_request()
                with self.tracer.span("fetch.refetch_range", "fault",
                                      map=seg.map_id, peer=exec_idx,
                                      bytes=seg.total_bytes,
                                      blocks=len(seg.blocks)):
                    return self.endpoint.fetch_blocks(
                        peer, self.shuffle_id, seg.blocks)

            parts.append(self._with_retries("blocks", exec_idx, seg.map_id,
                                            refetch))
        return b"".join(parts)

    def _heal_vectored(self, peer, exec_idx: int, vf: _VectoredFetch,
                       err: ChecksumError) -> bytes:
        """Salvage a partially-corrupt vectored response: segments whose
        sub-blocks all verified keep their bytes from ``err.body``; each
        affected segment refetches alone under the retry envelope with
        ITS map charged (retry counters, trace events, and — on
        exhaustion — the FetchFailedError all blame the map that owns
        the corrupt range, not the whole request)."""
        bad = set(err.bad_blocks)
        parts: List[Optional[bytes]] = []
        dirty: List[int] = []
        pos = block_index = 0
        for si, seg in enumerate(vf.segments):
            nblocks = len(seg.blocks)
            if bad.isdisjoint(range(block_index, block_index + nblocks)):
                parts.append(err.body[pos:pos + seg.total_bytes])
            else:
                parts.append(None)
                dirty.append(si)
            pos += seg.total_bytes
            block_index += nblocks
        for si in dirty:
            seg = vf.segments[si]

            def refetch(seg=seg):
                self.metrics.record_request()
                with self.tracer.span("fetch.refetch_range", "fault",
                                      map=seg.map_id, peer=exec_idx,
                                      bytes=seg.total_bytes,
                                      blocks=len(seg.blocks)):
                    return self.endpoint.fetch_blocks(
                        peer, self.shuffle_id, seg.blocks)

            # the vectored attempt was attempt one FOR EACH affected
            # segment: charge it so the budget spans the same wall-clock
            # either way and the retry counters attribute per map
            parts[si] = self._with_retries("blocks", exec_idx, seg.map_id,
                                           refetch, first_error=err)
        return b"".join(parts)

    def _emit_vectored(self, vf: _VectoredFetch, data: bytes) -> None:
        """Slice one vectored payload back into per-(map, range) results.
        With a pool, the whole response lands in ONE refcounted
        multi-view lease (each result holds a reference; the buffer
        returns to the pool on the last consumer's ``free``)."""
        lease = None
        if self.pool is not None and vf.total_bytes:
            lease = self.pool.get_registered(vf.total_bytes,
                                             tenant=self.tenant)
        pos = 0
        for seg in vf.segments:
            n = seg.total_bytes
            if lease is not None:
                view = lease.slice(n)
                if n:
                    view[:] = np.frombuffer(data, dtype=np.uint8,
                                            count=n, offset=pos)
                payload = view
            else:
                payload = data[pos:pos + n]
            pos += n
            self._results.put(FetchResult(
                seg.map_id, seg.start_partition, seg.end_partition,
                payload, lease=lease))
        if lease is not None:
            lease.release()  # creator's ref; results hold theirs

    # -- retry envelope (deadline + backoff, transient vs fatal) ---------

    def _suspect_check(self, exec_idx: int, map_id: int) -> None:
        if self.endpoint.peer_suspect(exec_idx):
            raise FetchFailedError(
                self.shuffle_id, map_id, exec_idx,
                "peer declared suspect by the heartbeat monitor")

    def _note_transient(self, e: BaseException, what: str, exec_idx: int,
                        map_id: int, will_retry: bool, attempt: int) -> None:
        if isinstance(e, ChecksumError):
            self.metrics.record_checksum_failure()
            if self.reader_stats is not None:
                self.reader_stats.failures.incr("checksum_mismatches")
        if will_retry:
            self.metrics.record_retry()
            if self.reader_stats is not None:
                self.reader_stats.failures.incr("fetch_retries")
            self.tracer.instant("fetch.retry", "fault", what=what,
                                peer=exec_idx, map=map_id,
                                attempt=attempt, error=type(e).__name__)
            log.debug("fetch retry %d (%s, map %d, peer %d): %s",
                      attempt, what, map_id, exec_idx, e)

    def _fail(self, what: str, exec_idx: int, map_id: int, consumed: int,
              err: BaseException):
        self.metrics.record_failure()
        if self.reader_stats is not None:
            self.reader_stats.failures.incr("fetch_failures")
        # an authoritative status that names its map (batched location
        # responses do) beats the caller's request-level blame
        named = getattr(err, "map_id", None)
        if isinstance(named, int):
            map_id = named
        verdict = ("corrupt_output"
                   if getattr(err, "status", None) == STATUS_CORRUPT
                   else "peer_lost")
        # staleness backstop: whatever location view led here is now
        # suspect — drop it (warm cached BYTES included) so the
        # post-recovery retry re-syncs a fresh snapshot instead of
        # re-serving the cache that just failed (covers a lost epoch
        # push: invalidation by failure, the hard way, costs one refetch
        # — never a wrong result)
        self.endpoint.location_plane.invalidate(self.shuffle_id)
        from sparkrdma_tpu_torch.shuffle import dist_cache
        dist_cache.drop(self.shuffle_id)
        raise FetchFailedError(
            self.shuffle_id, map_id, exec_idx,
            f"{what} failed after {consumed} attempt(s): {err}",
            verdict=verdict) from err

    def _with_retries(self, what: str, exec_idx: int, map_id: int, fn,
                      first_error: Optional[BaseException] = None):
        """Run one remote call under the failure policy: TRANSIENT
        outcomes (connection loss, connect refusal, request deadline,
        CRC mismatch, transient server status) retry with exponential
        backoff + jitter up to ``fetch_retry_budget``; FATAL outcomes
        (suspect peer, authoritative non-OK status, protocol bugs)
        escalate immediately as :class:`FetchFailedError` so
        ``run_reduce_with_retry`` recomputes the stage. ``first_error``
        charges an already-failed async attempt against the budget (the
        pipelined window's in-flight issue was attempt one)."""
        attempts = 1 + max(0, self.conf.fetch_retry_budget)
        consumed = 0
        if first_error is not None:
            consumed = 1
            retryable = (getattr(first_error, "retryable", True)
                         and not isinstance(first_error, AssertionError))
            self._note_transient(first_error, what, exec_idx, map_id,
                                 retryable and consumed < attempts, consumed)
            if not retryable or consumed >= attempts:
                self._fail(what, exec_idx, map_id, consumed, first_error)
            self._suspect_check(exec_idx, map_id)
            if self._aborted.wait(self._backoff.delay(consumed - 1)):
                raise _Aborted()
        while True:
            if self._aborted.is_set():
                raise _Aborted()
            self._suspect_check(exec_idx, map_id)
            try:
                return fn()
            except (TransportError, TimeoutError, AssertionError) as e:
                consumed += 1
                retryable = (getattr(e, "retryable", True)
                             and not isinstance(e, AssertionError))
                self._note_transient(e, what, exec_idx, map_id,
                                     retryable and consumed < attempts,
                                     consumed)
                if not retryable or consumed >= attempts:
                    self._fail(what, exec_idx, map_id, consumed, e)
                if self._aborted.wait(self._backoff.delay(consumed - 1)):
                    raise _Aborted()

    def _fetch_sequential(self, peer, exec_idx: int, maps: List[int],
                          count_lock: threading.Lock) -> None:
        """``read_ahead_depth=1``: the fully serialized fetch — every
        location read then every data read, one at a time. Kept verbatim
        as the regression escape hatch the pipelined path is diffed
        against."""
        plane = self.endpoint.location_plane
        pending: List[_PendingFetch] = []
        for m in maps:
            # STEP 2: block locations (:293-315) — cache-first: an
            # epoch-current cached range resolves without the wire
            locs = plane.locations(self.shuffle_id, m,
                                   self.start_partition,
                                   self.end_partition)
            if locs is not None:
                self.metrics.record_location_hit()
                pending.extend(self._group_locations(exec_idx, m, locs))
                continue

            def read_locs(m=m):
                self.metrics.record_request()
                self.metrics.record_metadata_rpc()
                with self.tracer.span("fetch.locations", "fetch",
                                      map=m, peer=exec_idx):
                    return self.endpoint.fetch_output_range(
                        peer, self.shuffle_id, m,
                        self.start_partition, self.end_partition)

            locs = self._with_retries("locations", exec_idx, m, read_locs)
            plane.put_locations(self.shuffle_id, m, self.start_partition,
                                self.end_partition, locs, self.epoch)
            pending.extend(self._group_locations(exec_idx, m, locs))
        self._rng.shuffle(pending)
        with count_lock:
            self._expected_results += len(pending)
        for fetch in pending:
            if self._aborted.is_set():
                raise _Aborted()
            self._acquire_in_flight(fetch.total_bytes)
            t0 = time.monotonic()

            def read_blocks(fetch=fetch):
                self.metrics.record_request()
                with self.tracer.span("fetch.blocks", "fetch",
                                      map=fetch.map_id, peer=exec_idx,
                                      bytes=fetch.total_bytes):
                    return self.endpoint.fetch_blocks(
                        peer, self.shuffle_id, fetch.blocks)

            try:
                data = self._with_retries("blocks", exec_idx, fetch.map_id,
                                          read_blocks)
            except BaseException:
                # envelope exhausted (FetchFailedError) or abort: this
                # fetch's budget must not leak past its failure
                self._release_in_flight(fetch.total_bytes)
                raise
            dt = time.monotonic() - t0
            self.metrics.record_remote(len(data), dt)
            if self.reader_stats is not None:
                self.reader_stats.update(exec_idx, dt, nbytes=len(data))
            self._results.put(FetchResult(
                fetch.map_id, fetch.start_partition, fetch.end_partition,
                data))

    def _fetch_pipelined(self, peer, exec_idx: int, maps: List[int],
                         count_lock: threading.Lock, depth: int) -> None:
        """Bounded read-ahead window: up to ``depth`` location reads AND
        up to ``depth`` grouped data fetches outstanding at once on the
        shared pipelined connection, completions drained oldest-first.
        This is the structure the reference's speedup comes from — many
        one-sided READs in flight per channel (:82-83) — mapped onto the
        transport's req-id multiplexing.

        Budget interplay: a data fetch is only ISSUED once its bytes fit
        the ``max_bytes_in_flight`` gate. When the gate is full and this
        window still holds issued fetches, the oldest is completed first
        (its enqueue lets the consumer drain and release budget) — never
        block on the gate while holding completions, or the release that
        would unblock it could never happen."""
        maps = list(maps)
        self._rng.shuffle(maps)  # randomized order (:74-79)
        loc_pending: deque = deque()  # (map_id, AsyncFetch, t_issue)
        ready: deque = deque()        # (_PendingFetch, t_ready)
        inflight: deque = deque()     # (_PendingFetch, AsyncFetch,
        #                                t_ready, t_issue)
        # cache-first: maps with epoch-current cached locations feed the
        # data window directly; only misses enter the STEP-2 read-ahead
        plane = self.endpoint.location_plane
        misses: List[int] = []
        now0 = time.monotonic()
        for m in maps:
            locs = plane.locations(self.shuffle_id, m,
                                   self.start_partition,
                                   self.end_partition)
            if locs is None:
                misses.append(m)
                continue
            self.metrics.record_location_hit()
            groups = self._group_locations(exec_idx, m, locs)
            self._rng.shuffle(groups)
            with count_lock:
                self._expected_results += len(groups)
            ready.extend((g, now0) for g in groups)
        maps = misses
        mi = 0
        try:
            while mi < len(maps) or loc_pending or ready or inflight:
                if self._aborted.is_set():
                    raise _Aborted()
                # top up STEP-2 read-ahead: overlap location reads with
                # everything else
                while mi < len(maps) and len(loc_pending) < depth:
                    m = maps[mi]
                    # same fail-fast as the sequential path's envelope: a
                    # suspect verdict must stop NEW issues (a fresh dial
                    # after the verdict is a connection the monitor will
                    # never close for us)
                    self._suspect_check(exec_idx, m)
                    mi += 1
                    self.metrics.record_request()
                    self.metrics.record_metadata_rpc()
                    loc_pending.append((
                        m,
                        self.endpoint.fetch_output_range_async(
                            peer, self.shuffle_id, m,
                            self.start_partition, self.end_partition),
                        time.monotonic()))
                # harvest landed location reads in issue order
                while loc_pending and loc_pending[0][1].done():
                    self._harvest_locations(peer, exec_idx,
                                            loc_pending.popleft(),
                                            ready, count_lock)
                # issue STEP-3 data fetches while the window has room and
                # the in-flight byte budget admits them. With an empty
                # window the acquire may block (same as the sequential
                # path — nothing of ours is withheld from the consumer);
                # with fetches in flight it must not: the release that
                # would unblock it needs their completions enqueued first.
                while ready and len(inflight) < depth:
                    fetch, t_ready = ready[0]
                    if not self._try_acquire_in_flight(
                            fetch.total_bytes, nonblocking=bool(inflight)):
                        break
                    ready.popleft()
                    t_issue = time.monotonic()
                    self.metrics.record_request()
                    handle = self.endpoint.fetch_blocks_async(
                        peer, self.shuffle_id, fetch.blocks)
                    inflight.append((fetch, handle, t_ready, t_issue))
                    self.pipeline.record_issue(exec_idx, len(inflight),
                                               t_issue - t_ready)
                # complete: whenever the window holds fetches the oldest
                # completion is both the progress path and the budget-
                # release path; with an empty window, block on the oldest
                # location read instead
                if inflight:
                    self._complete_oldest(peer, exec_idx, inflight)
                elif loc_pending:
                    self._harvest_locations(peer, exec_idx,
                                            loc_pending.popleft(),
                                            ready, count_lock)
        except BaseException:
            # window-held budget must not outlive the window: the issued-
            # but-uncompleted fetches' bytes were acquired above and their
            # results will never reach the consumer (who releases on
            # dequeue). The abandoned handles are cancelled too — a
            # pending request holds a send-budget slot on the SHARED
            # connection until its future resolves, so walking away
            # without cancelling would leak one slot per abandoned fetch
            # on every failed attempt (the sequential path's blocking
            # request() cancels on timeout for the same reason)
            for _m, handle, _t in loc_pending:
                handle.cancel()
            for fetch, handle, _tr, _ti in inflight:
                handle.cancel()
                self._release_in_flight(fetch.total_bytes)
            raise

    def _harvest_locations(self, peer, exec_idx: int, entry, ready: deque,
                           count_lock: threading.Lock) -> None:
        m, handle, t_issue = entry
        try:
            locs = handle.result()
        except (TransportError, TimeoutError, AssertionError) as e:
            # the windowed async issue was attempt one; run the remaining
            # retry budget synchronously (re-queueing into the window
            # would reorder the drain for no benefit)
            def retry_locs(m=m):
                self.metrics.record_request()
                self.metrics.record_metadata_rpc()
                return self.endpoint.fetch_output_range(
                    peer, self.shuffle_id, m,
                    self.start_partition, self.end_partition)

            locs = self._with_retries("locations", exec_idx, m, retry_locs,
                                      first_error=e)
        self.endpoint.location_plane.put_locations(
            self.shuffle_id, m, self.start_partition, self.end_partition,
            locs, self.epoch)
        if self.tracer.enabled:
            # same span the sequential path brackets around its blocking
            # location read — STEP-2 latency stays measurable in the
            # mode built to hide it
            end_us = self.tracer.now_us()
            start_us = end_us - (time.monotonic() - t_issue) * 1e6
            self.tracer.complete_span("fetch.locations", "fetch",
                                      start_us, end_us,
                                      map=m, peer=exec_idx)
        groups = self._group_locations(exec_idx, m, locs)
        # randomized issue order within the map (:74-79), like the
        # sequential path's shuffle of `pending` — without it every
        # reducer walks each map's groups in identical ascending
        # partition order and hotspots the same serving range
        self._rng.shuffle(groups)
        with count_lock:
            self._expected_results += len(groups)
        now = time.monotonic()
        ready.extend((g, now) for g in groups)

    def _complete_oldest(self, peer, exec_idx: int, inflight: deque) -> None:
        """Finish the window's oldest data fetch: decode on this thread,
        record metrics + issue→wire→complete trace spans, enqueue. A
        transient failure retries synchronously within the budget (each
        window entry heals independently — one bit-flipped response costs
        one refetch, not the whole window); exhaustion unwinds the window
        via the FetchFailedError."""
        fetch, handle, t_ready, t_issue = inflight[0]
        wire_done_s = None
        try:
            data = handle.result()
            wire_done_s = handle.wire_done_s
        except (TransportError, TimeoutError, AssertionError) as e:
            inflight.popleft()
            # re-stamp the issue time: the recorded latency should cover
            # the retry that actually served the bytes, not the failed
            # wait + backoff sleeps (which would skew the histograms the
            # pipeline analysis reads); the failed handle's wire stamp is
            # stale for the same reason
            t_issue = time.monotonic()

            def retry_blocks(fetch=fetch):
                self.metrics.record_request()
                return self.endpoint.fetch_blocks(
                    peer, self.shuffle_id, fetch.blocks)

            try:
                data = self._with_retries("blocks", exec_idx, fetch.map_id,
                                          retry_blocks, first_error=e)
            except BaseException:
                # this entry's budget is released here; the rest of the
                # window is released by _fetch_pipelined's unwind
                self._release_in_flight(fetch.total_bytes)
                raise
        else:
            inflight.popleft()
        now = time.monotonic()
        dt = now - t_issue
        self.metrics.record_remote(len(data), dt)
        if self.reader_stats is not None:
            self.reader_stats.update(exec_idx, dt, nbytes=len(data))
        if self.tracer.enabled:
            end_us = self.tracer.now_us()
            issue_us = end_us - (now - t_issue) * 1e6
            ready_us = end_us - (now - t_ready) * 1e6
            wire_us = (end_us - (now - wire_done_s) * 1e6
                       if wire_done_s is not None else end_us)
            # the stamp rides the future's done-callback, which can run
            # AFTER result() already returned — clamp so a late stamp
            # can't put the wire phase outside [issue, complete]
            wire_us = min(max(wire_us, issue_us), end_us)
            self.tracer.complete_span(
                "fetch.issue", "fetch", ready_us, issue_us,
                map=fetch.map_id, peer=exec_idx)
            # the wire phase keeps the sequential path's span name so
            # existing trace consumers see one contract either way
            self.tracer.complete_span(
                "fetch.blocks", "fetch", issue_us, wire_us,
                map=fetch.map_id, peer=exec_idx, bytes=fetch.total_bytes)
            self.tracer.complete_span(
                "fetch.complete", "fetch", wire_us, end_us,
                map=fetch.map_id, peer=exec_idx)
        self._results.put(FetchResult(
            fetch.map_id, fetch.start_partition, fetch.end_partition,
            data))

    # -- flow control ----------------------------------------------------

    def _acquire_in_flight(self, nbytes: int) -> None:
        with self._in_flight_cv:
            # single-oversized-fetch escape: proceed when nothing's in flight
            while (self._in_flight > 0
                   and self._in_flight + nbytes > self.conf.max_bytes_in_flight):
                if self._aborted.is_set():
                    raise _Aborted()
                self._in_flight_cv.wait(timeout=0.5)
            if self._aborted.is_set():
                raise _Aborted()
            self._in_flight += nbytes

    def _try_acquire_in_flight(self, nbytes: int,
                               nonblocking: bool) -> bool:
        """Window-aware acquire: blocking when the caller holds no
        outstanding completions (identical to ``_acquire_in_flight``,
        single-oversized escape included), one-shot when it does."""
        if not nonblocking:
            self._acquire_in_flight(nbytes)
            return True
        with self._in_flight_cv:
            if self._aborted.is_set():
                raise _Aborted()
            if (self._in_flight > 0
                    and self._in_flight + nbytes > self.conf.max_bytes_in_flight):
                return False
            self._in_flight += nbytes
            return True

    def _release_in_flight(self, nbytes: int) -> None:
        with self._in_flight_cv:
            self._in_flight -= nbytes
            self._in_flight_cv.notify_all()

    @property
    def bytes_in_flight(self) -> int:
        with self._in_flight_cv:
            return self._in_flight

    def _drain_unconsumed(self) -> None:
        """Free pool leases of results the consumer will never take
        (failure/early-exit teardown; a plain-bytes or sentinel result's
        free() is a no-op)."""
        while True:
            try:
                self._results.get_nowait().free()
            except queue.Empty:
                return

    def close(self) -> None:
        """Abort outstanding work: wakes budget waiters, stops peer
        threads at their next checkpoint (teardown semantics of
        RdmaChannel.java:872-956 — outstanding work must not outlive the
        consumer). Unconsumed lease-backed results return their pool
        buffers (the last peer thread re-drains for completions that
        race this)."""
        self._aborted.set()
        with self._in_flight_cv:
            self._in_flight_cv.notify_all()
        self._drain_unconsumed()
        # skew observability: this reducer's input-byte total lands in
        # the pow2 bytes_per_reducer histogram exactly once per fetch
        # lifetime (every read path funnels through close) — and ONLY
        # for a cleanly COMPLETED fetch: a failed or abandoned fetch
        # would record partial bytes, and its stage retry would record
        # the same logical reducer again, skewing the reduce_balance
        # gauge with tasks that never existed
        if (self.reader_stats is not None and self._started
                and not self._reducer_bytes_recorded
                and not self._failed
                and self._consumed >= self._expected_results):
            self._reducer_bytes_recorded = True
            self.reader_stats.record_reducer_bytes(
                self.metrics.remote_bytes + self.metrics.local_bytes
                + self.metrics.tiered_bytes)

    # -- iteration (:342-382) -------------------------------------------

    def __iter__(self):
        sentinel_seen = False
        while True:
            if sentinel_seen and self._consumed >= self._expected_results:
                return
            t0 = time.monotonic()
            result = self._results.get()
            self.metrics.fetch_wait_s += time.monotonic() - t0
            if result.is_sentinel:
                sentinel_seen = True
                continue
            if result.failure is not None:
                self._failed = True
                self.close()
                # any escalated failure makes this shuffle's cached
                # locations AND warm bytes suspect (peer-thread crashes
                # included, which never went through _fail):
                # refetch-snapshot on retry
                self.endpoint.location_plane.invalidate(self.shuffle_id)
                from sparkrdma_tpu_torch.shuffle import dist_cache
                dist_cache.drop(self.shuffle_id)
                raise result.failure
            self._consumed += 1
            if not result.is_local:
                # grouped-fetch payload length == sum of its block lengths
                self._release_in_flight(len(result.data))
            yield result
