"""TpuShuffleManager: the engine-facing plugin hub.

Re-design of ``scala/RdmaShuffleManager.scala`` keeping its API shape —
``register_shuffle / get_writer / get_reader / unregister_shuffle / stop``
(:143-310) — so an engine swaps shuffle implementations with one config line
(README.md:69-71 analogue).

Role split matches the reference: the driver allocates per-shuffle tables
and runs membership (:38-140, 155-183); executors lazily boot their
endpoint + hello on first writer/reader (:186-232) — here the boot happens
in ``__init__`` since there's no engine-imposed laziness to preserve, and a
single process may host the driver role, an executor role, or both (the
reference forbids local mode, :154, because in-process RDMA is pointless;
an in-process multi-executor TPU cluster is, by contrast, the primary
single-host deployment, so it is supported, not rejected).

The shuffle **handle** carries everything a task needs — ids, sizes, row
width, partitioner spec — the way the reference's handles piggyback the
driver table's (address, length, rkey) through task serialization
(scala/RdmaUtils.scala:145-159).
"""

from __future__ import annotations

import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel.endpoints import DriverEndpoint, ExecutorEndpoint
from sparkrdma_tpu_torch.runtime.pool import BufferPool
from sparkrdma_tpu_torch.shuffle.reader import TpuShuffleReader
from sparkrdma_tpu_torch.shuffle.resolver import TpuShuffleBlockResolver
from sparkrdma_tpu_torch.shuffle.writer import Partitioner, TpuShuffleWriter
from sparkrdma_tpu_torch.utils.stats import MemStats, ShuffleReaderStats
from sparkrdma_tpu_torch.utils import trace as trace_mod

import logging

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class PartitionerSpec:
    """Serializable partitioner description (handles cross process
    boundaries; callables don't)."""

    kind: str  # "hash" | "range" | "modulo"
    splitters: Optional[Tuple[int, ...]] = None

    def build(self, num_partitions: int) -> Partitioner:
        if self.kind == "hash":
            # host-side numpy mirror of ops.partition.hash_partition (same
            # murmur finalizer, bit-identical) — the writer partitions on
            # the host, and routing through jnp would dispatch to the
            # default accelerator for no benefit
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
    the handle's dependency): every writer of this shuffle applies it —
    including stage-retry recomputes and shipped tasks, whose handles
    travel by cloudpickle. None = no map-side combine."""

    shuffle_id: int
    num_maps: int
    num_partitions: int
    row_payload_bytes: int
    partitioner: PartitionerSpec
    combiner: Optional[Callable] = None
    # tenancy: the tenant id minted at registerShuffle rides the handle
    # through task serialization, so every writer/reader/pool lease on
    # every executor charges the right owner even if the one-sided
    # TenantMapMsg push was lost (shuffle/tenancy.py)
    tenant: int = 0


class TpuShuffleManager:
    """One per process; ``is_driver`` and/or executor role."""

    def __init__(self, conf: Optional[TpuShuffleConf] = None,
                 is_driver: bool = False,
                 driver_addr: Optional[Tuple[str, int]] = None,
                 host: str = "127.0.0.1", executor_id: str = "driver",
                 spill_dir: Optional[str] = None,
                 num_executors_hint: int = 0,
                 lease_store=None, lease_holder: Optional[str] = None):
        self.conf = conf or TpuShuffleConf()
        self.is_driver = is_driver
        self.driver: Optional[DriverEndpoint] = None
        self.executor: Optional[ExecutorEndpoint] = None
        self.resolver: Optional[TpuShuffleBlockResolver] = None
        self._handles: Dict[int, ShuffleHandle] = {}
        self._lock = threading.Lock()
        self.pool = BufferPool(self.conf)
        # worker-process shuffle cache budget (mesh results + warm
        # iterative ranges, shuffle/dist_cache.py) — process-global, so
        # co-hosted managers share one bound like they share the process
        from sparkrdma_tpu_torch.shuffle import dist_cache
        dist_cache.configure(self.conf.dist_cache_budget,
                             tenant_quota=self.conf.tenant_cache_quota)
        self.reader_stats = (ShuffleReaderStats(self.conf)
                             if self.conf.collect_shuffle_reader_stats else None)
        self.tracer = trace_mod.get(self.conf)
        self._role_name = executor_id  # "driver" for the driver role
        self._mem_stats = MemStats()

        if is_driver:
            # HA deployments hand the driver role a shared lease store
            # (shuffle/ha.py): the endpoint renews the lease and mutes
            # itself the instant a standby wins the next term
            self.driver = DriverEndpoint(self.conf, host=host,
                                         lease_store=lease_store,
                                         lease_holder=lease_holder)
            driver_addr = self.driver.address
        if driver_addr is None:
            raise ValueError("executor role needs driver_addr")
        self.driver_addr = driver_addr

        self.block_server = None
        self.pusher = None
        self.merge_client = None
        if executor_id != "driver":
            from sparkrdma_tpu_torch.runtime.blockserver import maybe_create
            self.block_server = maybe_create(self.conf, host=host,
                                             tracer=self.tracer)
            spill_dir = spill_dir or tempfile.mkdtemp(prefix="tpushuffle_")
            self.resolver = TpuShuffleBlockResolver(
                spill_dir, block_server=self.block_server, conf=self.conf)
            self.executor = ExecutorEndpoint(
                host, executor_id, driver_addr, data_source=self.resolver,
                conf=self.conf,
                block_port=self.block_server.port if self.block_server else 0,
                tracer=self.tracer)
            planned = (self.conf.planned_push and self.conf.adaptive_plan)
            if self.conf.push_merge:
                # push-merge dataplane (shuffle/push_merge.py): this
                # executor is a merge TARGET (store served through the
                # endpoint) and an overflow client for the writer's
                # ENOSPC ladder
                from sparkrdma_tpu_torch.shuffle.push_merge import (
                    MergeClient, MergeStore)
                self.executor.merge_store = MergeStore(self.resolver,
                                                       self.conf)
                self.merge_client = MergeClient(self.executor, self.conf)
                if self.conf.cold_tier:
                    # cold tier (shuffle/cold_tier.py): finalized merged
                    # segments tier to the blob store in the background;
                    # the publish callback rides the one-sided driver
                    # channel like every other publish
                    from sparkrdma_tpu_torch.shuffle.cold_tier import (
                        TieringService, open_store)
                    store = open_store(self.conf)
                    if store is not None:
                        self.executor.tiering = TieringService(
                            store, self.resolver, self.conf,
                            publish=self.executor._publish_tiered,
                            tracer=self.tracer)
            if planned:
                # planned push (shuffle/pushed_store.py): this executor
                # is a planned-push TARGET — staged reduce inputs the
                # fetcher resolves first
                from sparkrdma_tpu_torch.shuffle.pushed_store import (
                    PushedInputStore)
                self.executor.pushed_store = PushedInputStore(
                    self.resolver, self.conf, pool=self.pool,
                    tracer=self.tracer)
            if self.conf.push_merge or planned:
                # one background pusher serves both dataplanes: merge
                # replicas at commit, planned reducer slots once the
                # plan is in hand (replayed via on_plan when it lands
                # after the commit)
                from sparkrdma_tpu_torch.shuffle.push_merge import SegmentPusher
                self.pusher = SegmentPusher(
                    self.executor, self.resolver, self.conf,
                    pool=self.pool, tracer=self.tracer,
                    pushed_store=self.executor.pushed_store)
                self.executor.on_plan_cb = self.pusher.on_plan
            self.executor.start()
            if num_executors_hint:
                self.executor.wait_for_members(num_executors_hint)

    # -- engine SPI ------------------------------------------------------

    def register_shuffle(self, shuffle_id: int, num_maps: int,
                         num_partitions: int,
                         partitioner: PartitionerSpec,
                         row_payload_bytes: int = 0,
                         combiner=None, tenant: int = 0) -> ShuffleHandle:
        """Driver-side (scala/RdmaShuffleManager.scala:143-183).

        ``tenant`` is the owning tenant id minted here and threaded
        through every layer (quotas, fair-share serving, admission).
        With ``admission_max_inflight`` configured, a tenant at its
        in-flight cap parks in the admission queue and — past the queue
        depth or the park deadline — gets
        :class:`~sparkrdma_tpu_torch.shuffle.tenancy.AdmissionRejected` with
        a retry-after hint instead of a registration."""
        if self.driver is None:
            raise RuntimeError("register_shuffle is a driver-role call")
        self.driver.register_shuffle(shuffle_id, num_maps, num_partitions,
                                     tenant=tenant)
        handle = ShuffleHandle(shuffle_id, num_maps, num_partitions,
                               row_payload_bytes, partitioner, combiner,
                               tenant=tenant)
        with self._lock:
            self._handles[shuffle_id] = handle
        return handle

    def get_writer(self, handle: ShuffleHandle, map_id: int,
                   combiner=None) -> "_PublishingWriter":
        """(scala/RdmaShuffleManager.scala:263-291). Map-side combine
        comes from the handle's registered combiner (every writer of the
        shuffle, on every path — recomputes included); the ``combiner``
        kwarg overrides per-writer (writer.make_sum_combiner or a custom
        ``(keys_sorted, payload_sorted) -> (keys', payload')``)."""
        if self.executor is None or self.resolver is None:
            raise RuntimeError("get_writer is an executor-role call")
        self._teach_tenant(handle)
        overflow = (self.merge_client.overflow_spill
                    if self.merge_client is not None else None)
        inner = TpuShuffleWriter(
            self.resolver, handle.shuffle_id, map_id, handle.num_partitions,
            handle.partitioner.build(handle.num_partitions),
            handle.row_payload_bytes,
            combiner=combiner if combiner is not None else handle.combiner,
            conf=self.conf, pool=self.pool, tracer=self.tracer,
            overflow_spill=overflow)
        return _PublishingWriter(inner, self.executor, tracer=self.tracer,
                                 pusher=self.pusher)

    def get_reader(self, handle: ShuffleHandle, start_partition: int,
                   end_partition: int, map_range=None) -> TpuShuffleReader:
        """(scala/RdmaShuffleManager.scala:234-261). ``map_range`` is the
        adaptive plan's split-task map slice — ``(map_lo, map_hi)`` reads
        the partition range from just those maps; None reads all."""
        if self.executor is None:
            raise RuntimeError("get_reader is an executor-role call")
        self._teach_tenant(handle)
        return TpuShuffleReader(self.executor, self.resolver, self.conf,
                                handle.shuffle_id, handle.num_maps,
                                start_partition, end_partition,
                                handle.row_payload_bytes,
                                reader_stats=self.reader_stats,
                                tracer=self.tracer, pool=self.pool,
                                map_range=map_range)

    def _teach_tenant(self, handle: ShuffleHandle) -> None:
        """Teach local components the handle's tenant (the backstop for
        a lost TenantMapMsg push — handles travel with tasks, so the
        local path always knows the owner)."""
        tenant = getattr(handle, "tenant", 0)
        if self.resolver is not None:
            self.resolver.note_tenant(handle.shuffle_id, tenant)
        if self.executor is not None:
            self.executor.note_tenant(handle.shuffle_id, tenant)
        from sparkrdma_tpu_torch.shuffle import dist_cache
        dist_cache.set_tenant(handle.shuffle_id, tenant)

    def gc_orphans(self, live_shuffle_ids, min_age_s: float = 60.0) -> int:
        """Executor-role GC sweep: reap committed outputs, merged
        segments and overflow blobs of shuffles absent from the
        driver's live set (``live_shuffle_ids``) and unknown locally —
        debris of dead processes that no unregister push will ever
        name. ``min_age_s`` skips files fresh enough to be a commit or
        push racing the live-set snapshot. Returns files reaped."""
        if self.resolver is None:
            raise RuntimeError("gc_orphans is an executor-role call")
        n = self.resolver.reap_orphans(live_shuffle_ids, min_age_s)
        if self.executor is not None and self.executor.merge_store is not None:
            n += self.executor.merge_store.reap_orphans(live_shuffle_ids,
                                                        min_age_s)
        if self.executor is not None and self.executor.tiering is not None:
            n += self.executor.tiering.reap_orphans(live_shuffle_ids,
                                                    min_age_s)
        return n

    def plan_reduce(self, handle: ShuffleHandle):
        """Driver-role: build + publish the shuffle's adaptive
        ReducePlan at map-stage completion (shuffle/planner.py). Returns
        the plan, or None when ``adaptive_plan`` is off or no sizes were
        collected — callers fall back to the identity plan."""
        if self.driver is None:
            raise RuntimeError("plan_reduce is a driver-role call")
        return self.driver.build_reduce_plan(handle.shuffle_id,
                                             tracer=self.tracer)

    def decommission_slot(self, slot: int,
                          deadline_ms: Optional[int] = None) -> dict:
        """Driver-role: gracefully drain + retire one executor slot
        (parallel/membership.py) — push-merge replicates the drainee's
        committed outputs, location entries re-point under a bumped
        epoch, and the slot retires with zero re-executions; a drainee
        death mid-drain falls back to ordinary tombstone recovery."""
        if self.driver is None:
            raise RuntimeError("decommission_slot is a driver-role call")
        return self.driver.decommission_slot(slot, deadline_ms=deadline_ms)

    def join_cluster(self) -> None:
        """Executor-role: announce an explicit mid-job JOIN (the elastic
        scale-up path; the startup hello already made this executor a
        member — this names the intent so the driver traces it)."""
        if self.executor is None:
            raise RuntimeError("join_cluster is an executor-role call")
        self.executor.join_cluster()

    def recover_and_republish(self) -> dict:
        """Elastic rejoin: recover committed spills from disk and
        re-publish them under this executor's (new) slot. The positional
        publish overwrite atomically repairs each driver-table entry."""
        if self.resolver is None or self.executor is None:
            raise RuntimeError("executor-role call")
        recovered = self.resolver.recover()
        for shuffle_id, entries in recovered.items():
            for m, token in entries:
                lengths = None
                if self.conf.adaptive_plan:
                    # re-publishes must feed the size histogram too, or
                    # a post-rejoin plan would undercount this executor
                    table = self.resolver.get_output_table(shuffle_id, m)
                    if table is not None:
                        lengths = [table.get_block_location(p).length
                                   for p in range(table.num_partitions)]
                self.executor.publish_map_output(
                    shuffle_id, m, token,
                    fence=self.resolver.committed_fence(shuffle_id, m),
                    lengths=lengths)
        return recovered

    def unregister_shuffle(self, shuffle_id: int) -> None:
        """(scala/RdmaShuffleManager.scala:293-299)."""
        if self.driver is not None:
            self.driver.unregister_shuffle(shuffle_id)
        if self.executor is not None:
            self.executor.invalidate_shuffle(shuffle_id)
            if self.executor.merge_store is not None:
                self.executor.merge_store.drop_shuffle(shuffle_id)
            if self.executor.pushed_store is not None:
                self.executor.pushed_store.drop_shuffle(shuffle_id)
            if self.executor.tiering is not None:
                self.executor.tiering.drop_shuffle(shuffle_id)
        if self.pusher is not None:
            self.pusher.forget(shuffle_id)
        if self.resolver is not None:
            self.resolver.remove_shuffle(shuffle_id)
        with self._lock:
            self._handles.pop(shuffle_id, None)

    def stop(self) -> None:
        """Stats dump then teardown (scala/RdmaShuffleManager.scala:301-310;
        histograms at RdmaShuffleReaderStats.scala:55-81; pool stats at
        RdmaBufferManager.java:217-231)."""
        if self.reader_stats is not None:
            self.reader_stats.log_summary(log)
        if self.block_server is not None:
            # flush the registered-region pool's activity into the trace
            # (serve.pin / serve.zero_copy / serve.remap instants) BEFORE
            # the dump below writes the file
            self.block_server.trace_serve()
        if self.tracer.enabled and self.conf.trace_file:
            # one file per role so a cluster of managers sharing one conf
            # doesn't overwrite each other's dumps
            path = f"{self.conf.trace_file}.{self._role_name}.json"
            n = self.tracer.dump(path)
            log.info("wrote %d trace events to %s", n, path)
        # quiesce traffic sources before destroying the pool: outstanding
        # readers hold views into pool memory
        if self.pusher is not None:
            self.pusher.stop()
        if self.executor is not None and self.executor.merge_store is not None:
            log.info("merge store at stop: %s",
                     self.executor.merge_store.snapshot())
            self.executor.merge_store.stop()
        if self.executor is not None and self.executor.pushed_store is not None:
            log.info("pushed store at stop: %s",
                     self.executor.pushed_store.snapshot())
            self.executor.pushed_store.stop()
        if self.executor is not None and self.executor.tiering is not None:
            log.info("cold tier at stop: %s",
                     self.executor.tiering.snapshot())
            self.executor.tiering.stop()
        if self.executor is not None:
            if self.executor.suspect_events or self.executor.checksum_failures:
                log.warning("peer health at stop: %s (checksum failures: %d)",
                            self.executor.health_snapshot(),
                            self.executor.checksum_failures)
            self.executor.stop()
        if self.resolver is not None:
            self.resolver.stop()
        if self.block_server is not None:
            # second flush catches serves that landed after the trace dump
            # (in-memory instants only) and logs the final gauges
            log.info("native block server stats: %s",
                     self.block_server.trace_serve())
            self.block_server.stop()
        pool_stats = self.pool.stop()
        if pool_stats.get("bins"):
            log.info("buffer pool stats: %s", pool_stats)
        log.info("host paging over manager lifetime: %s", self._mem_stats.diff())
        if self.driver is not None:
            self.driver.stop()


class _PublishingWriter:
    """Writer wrapper that publishes the map output on successful close
    (RdmaWrapperShuffleWriter.scala:104-122)."""

    def __init__(self, inner: TpuShuffleWriter, endpoint: ExecutorEndpoint,
                 tracer=None, pusher=None):
        self._inner = inner
        self._endpoint = endpoint
        self._tracer = tracer or trace_mod.NULL
        self._pusher = pusher  # SegmentPusher | None (push-merge)

    def write_batch(self, keys, payload=None) -> None:
        self._inner.write_batch(keys, payload)

    def close(self, success: bool = True):
        with self._tracer.span("writer.commit", "write",
                               shuffle=self._inner.shuffle_id,
                               map=self._inner.map_id):
            result = self._inner.close(success)
        if result is None:
            return None
        token, partition_lengths = result
        if self._pusher is not None:
            # push-merge: queue the committed output's background push
            # BEFORE the publish can complete the map stage at the
            # driver — the finalize broadcast then provably trails this
            # submit, so targets' idle-grace wait sees the push coming
            self._pusher.submit(self._inner.shuffle_id,
                                self._inner.map_id, self._inner.fence,
                                partition_lengths)
        with self._tracer.span("writer.publish", "write",
                               shuffle=self._inner.shuffle_id,
                               map=self._inner.map_id):
            # the publish carries the attempt's fencing token: a stale
            # (zombie) attempt can't even get here — its commit already
            # raised StaleAttemptError — and the driver's fence check
            # rejects lateness the resolver couldn't see. With adaptive
            # planning the partition lengths (already in hand from the
            # commit) ride along so the driver's size histogram needs no
            # extra round trip.
            lengths = ([int(n) for n in partition_lengths]
                       if self._endpoint.conf.adaptive_plan else None)
            self._endpoint.publish_map_output(self._inner.shuffle_id,
                                              self._inner.map_id, token,
                                              fence=self._inner.fence,
                                              lengths=lengths)
        return token, partition_lengths

    @property
    def closed(self) -> bool:
        return self._inner.closed

    @property
    def fence(self) -> int:
        return self._inner.fence

    @property
    def metrics(self):
        out = {"bytes_written": self._inner.bytes_written,
               "records_written": self._inner.records_written}
        write_metrics = getattr(self._inner, "metrics", None)
        if write_metrics is not None:
            out["write"] = write_metrics.snapshot()
        return out

    @property
    def write_metrics(self):
        """The streaming writer's :class:`WriteMetrics` (scatter/spill/
        merge timing, spill count/bytes, peak buffered bytes)."""
        return self._inner.metrics
