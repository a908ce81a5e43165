"""Minimal DAG/stage engine: the host that proves the drop-in SPI.

The reference ships no engine — Apache Spark's DAGScheduler is the caller:
it plans stages around ``ShuffleDependency`` boundaries and drives the
plugin through exactly ``registerShuffle`` -> ``getWriter`` per map task ->
``getReader`` per reduce task -> ``unregisterShuffle``
(scala/RdmaShuffleManager.scala:143-310), retrying a whole producing stage
when a reducer surfaces ``FetchFailedException``
(scala/RdmaShuffleFetcherIterator.scala:376-381). A standalone framework
needs that half in-tree: this module is a ~300-LoC DAGScheduler analogue
that schedules multi-stage jobs across executor managers through the
camelCase compat SPI (`shuffle/spark_compat.py`) — the same sequence Spark
would issue — with stage retry built in (recompute lost maps on survivors,
repair the driver table via idempotent positional publishes, invalidate
reader caches, re-attempt).

Plan model (RDD-lite):

* ``MapStage`` — ``num_tasks`` deterministic map tasks, each writing
  key/payload batches through a ``CompatWriter`` into this stage's shuffle
  (its ``ShuffleDependency`` fixes partition count + partitioner). May read
  parent shuffles (task t reads partition t of each parent — Spark's
  co-partitioning contract).
* ``ResultStage`` — terminal tasks returning values; task t reads
  partition t of each parent shuffle.

Tasks must be deterministic (recompute yields identical records) — the
exact property Spark relies on for lineage recomputation.

Port of ``sparkrdma_tpu/engine.py``: the same scheduler, with ``mesh=`` a
``parallel.mesh.VirtualMesh`` (D shards on one card) whose mesh-mode
stages ride the port's ``device_plane`` and ``mesh_service``; no call
there takes an axis name. Distributed mesh mode (``dist_mesh_axis``, one
collective across executor processes) needs ``parallel/multihost.py``,
which is not ported yet, so asking for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError
from sparkrdma_tpu_torch import shared_vars
from sparkrdma_tpu_torch.shuffle.spark_compat import (
    CompatReader,
    CompatWriter,
    ShuffleDependency,
    SparkCompatShuffleManager,
)

log = logging.getLogger(__name__)

_stage_ids = itertools.count()
# process-global so two engines over one cluster can't collide on ids
_shuffle_ids = itertools.count(1)

# map task: fn(ctx, writer, task_id) -> None  (writes its records)
MapTaskFn = Callable[["TaskContext", CompatWriter, int], None]
# result task: fn(ctx, task_id) -> value
ResultTaskFn = Callable[["TaskContext", int], object]


@dataclass
class MapStage:
    """A stage that materializes one shuffle (ShuffleMapStage analogue)."""

    num_tasks: int
    dep: ShuffleDependency
    task_fn: MapTaskFn
    parents: List["MapStage"] = field(default_factory=list)
    stage_id: int = field(default_factory=lambda: next(_stage_ids))

    def __post_init__(self):
        _check_copartition(self)


@dataclass
class ResultStage:
    """Terminal stage returning one value per task (ResultStage analogue)."""

    num_tasks: int
    task_fn: ResultTaskFn
    parents: List[MapStage] = field(default_factory=list)
    stage_id: int = field(default_factory=lambda: next(_stage_ids))

    def __post_init__(self):
        _check_copartition(self)


def _check_copartition(stage) -> None:
    for p in stage.parents:
        if p.dep.num_partitions != stage.num_tasks:
            raise ValueError(
                f"stage {stage.stage_id}: task count {stage.num_tasks} must "
                f"equal parent stage {p.stage_id}'s partition count "
                f"{p.dep.num_partitions} (task t reads partition t)")


class _JobTornDownError(Exception):
    """Internal: the job finished and tore its shuffles down while this
    (abandoned speculative-loser or cancelled-sibling) attempt was still
    running. The attempt's outcome can no longer matter — exit quietly
    instead of dying on a missing handle."""


# cached per-shuffle marker: the cost model (or a mid-stage degrade)
# routed this stage to the host dataplane — readers use getReader
_HOST_PLANE = object()


class _MeshCell:
    """Once-cell for one shuffle's mesh-reduce results (per-shuffle lock:
    independent shuffles reduce concurrently)."""

    __slots__ = ("lock", "value")

    def __init__(self):
        self.lock = threading.Lock()
        self.value: Optional[list] = None


class TaskContext:
    """What a running task sees: readers over its parents' shuffles."""

    def __init__(self, engine: "DAGEngine", mgr: SparkCompatShuffleManager,
                 stage, task_id: int):
        self._engine = engine
        self.manager = mgr
        self._stage = stage
        self.task_id = task_id

    def read(self, parent_index: int = 0) -> CompatReader:
        """Reader over partition ``task_id`` of the parent's shuffle —
        the getReader(handle, t, t+1) call Spark issues per reduce task.

        With a mesh configured, the reader serves from the ICI collective
        data plane (one mesh reduce per parent shuffle, partitions split
        out); otherwise it drains the TCP fetcher. Same records either
        way — the reference's property that getReader IS the fast path
        (scala/RdmaShuffleManager.scala:234-261)."""
        parent = self._stage.parents[parent_index]
        handle = self._engine._handles.get(parent.stage_id)
        if handle is None:
            raise _JobTornDownError(parent.stage_id)
        if self._engine.mesh is not None:
            reader = self._engine._mesh_read(handle, self.task_id)
            if reader is not None:
                return reader
            # the cost model picked (or a degrade forced) the HOST
            # dataplane for this stage: same records through the
            # fetcher path with all its retry/CRC machinery
        return self.manager.getReader(handle, self.task_id, self.task_id + 1)


class DAGEngine:
    """Schedules stage DAGs over a cluster of compat shuffle managers.

    ``driver`` is the driver-role manager; ``executors`` the executor-role
    managers — in-process ``SparkCompatShuffleManager`` objects and/or
    ``tasks.RemoteExecutor`` proxies for executor PROCESSES (tasks ship by
    cloudpickle and run against the remote manager, the way Spark ships
    closures to the reference's executors). Tasks round-robin over live
    executors; a FetchFailed from any task triggers recompute of the lost
    maps of the failed shuffle on survivors (positional republish repairs
    the driver table atomically), then the task retries —
    ``max_stage_retries`` bounds attempts per task per failed shuffle; an
    unreachable executor costs the same budget under the task-delivery
    key instead.
    """

    def __init__(self, driver: SparkCompatShuffleManager,
                 executors: Sequence[SparkCompatShuffleManager],
                 max_stage_retries: int = 2,
                 max_parallel_tasks: Optional[int] = None,
                 speculation: bool = False,
                 speculation_multiplier: float = 1.5,
                 mesh=None, mesh_axis: str = "shuffle",
                 mesh_impl: str = "auto", mesh_rows_per_round: int = 0,
                 dataplane: str = "auto",
                 device_hbm_budget: int = 0,
                 dist_mesh_axis: Optional[str] = None,
                 dist_rows_per_round: int = 0,
                 dist_fail_grace_s: float = 5.0):
        self.driver = driver
        self.executors = list(executors)
        self.max_stage_retries = max_stage_retries
        # ICI data plane: with a VirtualMesh here, on-mesh stages'
        # reduce reads are served by the FUSED device dataplane (one
        # shard_map partition+exchange+sort per round,
        # parallel/device_plane.py + shuffle/mesh_service.py) — the
        # engine SPI and the accelerated path become the same code path,
        # as in the reference. Which plane carries each stage is decided
        # by the COST MODEL (device_plane.select_dataplane: stage
        # residency, estimated bytes vs the HBM budget, topology support)
        # rather than a flag; `dataplane` overrides it ("device"/"host"),
        # and a stage whose exchange overflows or loses an executor
        # mid-stage degrades to the host dataplane by itself.
        # mesh_rows_per_round > 0 pins the round size (DEPRECATED: rounds
        # are auto-sized from device_hbm_budget / the device_hbm_budget
        # conf key — see docs/CONFIG.md "Device exchange").
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.mesh_impl = mesh_impl
        self.mesh_rows_per_round = mesh_rows_per_round
        self.dataplane = dataplane
        self.device_hbm_budget = device_hbm_budget
        # stages forced onto the host dataplane mid-job (overflow or
        # mid-stage executor loss): shuffle_id -> reason
        self._mesh_degraded: Dict[int, str] = {}
        if mesh is not None and any(self._is_remote(ex) for ex in executors):
            raise ValueError(
                "mesh data plane needs in-process executors (their "
                "resolvers stage straight to the mesh); for executor "
                "PROCESSES over a jax.distributed mesh pass "
                "dist_mesh_axis instead")
        # Distributed mesh mode: executor PROCESSES form a jax.distributed
        # group (each calls multihost.init_multihost at startup, one
        # engine executor per jax process); per parent shuffle the engine
        # ships ONE collective closure to every process — each stages its
        # local spills and enters the global-mesh exchange
        # (parallel/multihost.py), keeps its received partitions in
        # shuffle/dist_cache.py, and reduce tasks are placed on the
        # partition's owner (misplacement falls back to the TCP fetcher).
        # Collectives serialize driver-side: two in flight would enter in
        # different orders on different processes and deadlock the group.
        self.dist_mesh_axis = dist_mesh_axis
        self.dist_rows_per_round = dist_rows_per_round
        self.dist_fail_grace_s = dist_fail_grace_s
        if dist_mesh_axis is not None:
            raise NotImplementedError(
                "distributed mesh mode (dist_mesh_axis) is not ported: it "
                "needs parallel/multihost.py (ROADMAP.md, queue A, item 4)")
        self._dist_lock = threading.RLock()
        self._dist_owner: Dict[int, Dict[int, object]] = {}
        # Speculative execution (Spark's spark.speculation): once half a
        # stage's tasks have finished, a task running longer than
        # multiplier x their median gets a backup attempt on a different
        # executor; first completion wins. Safe because map publishes are
        # idempotent positional writes and tasks are deterministic — the
        # same properties stage retry already relies on. Requires
        # max_parallel_tasks > 1 (a sequential stage has no one to race).
        self.speculation = speculation
        self.speculation_multiplier = speculation_multiplier
        # Tasks within a stage dispatch concurrently up to this bound
        # (Spark's running-tasks-per-stage model; remote executors run
        # them in their task_threads slots). Default = one in-flight task
        # per executor — concurrency is the contract, as in Spark, and
        # task_fns must be thread-safe the way Spark closures must be.
        # Pass 1 for strictly sequential debugging runs.
        if max_parallel_tasks is None:
            max_parallel_tasks = max(1, len(self.executors))
        if speculation and max_parallel_tasks <= 1:
            raise ValueError("speculation requires max_parallel_tasks > 1")
        self.max_parallel_tasks = max(1, max_parallel_tasks)
        # driver-side spans for stages/tasks (the scheduling-layer view the
        # reference gets from Spark's event log; chrome-trace via
        # conf trace_file, utils/trace.py)
        self.tracer = driver.native.tracer
        # recoveries serialize: concurrent tasks tripping over the same
        # dead executor must repair a shuffle once, not once per task.
        # RLock: a recompute task's own FetchFailed recovers recursively.
        self._recover_lock = threading.RLock()
        self._recovered: set = set()  # (shuffle_id, dead_slot)
        self._handles: Dict[int, object] = {}      # stage_id -> ShuffleHandle
        self._stages: Dict[int, MapStage] = {}     # stage_id -> stage
        self._owners: Dict[int, Dict[int, int]] = {}  # stage_id -> map->slot
        # shared variables (shared_vars): engine-created accumulators by
        # id, and the first-success dedupe ledger — a task's deltas merge
        # exactly once no matter how many attempts (speculation, retry,
        # abandoned stragglers) eventually succeed. Keys carry a per-job
        # GENERATION: a straggler that outlives its job (or lands after a
        # later job reused its stage id) holds a gen that is no longer
        # active, so its late deltas are dropped instead of re-applied
        # against a purged ledger.
        self._accs: Dict[int, "shared_vars.Accumulator"] = {}
        self._acc_applied: set = set()  # (job_gen, stage_id, task_id)
        self._acc_lock = threading.Lock()
        self._job_gens = itertools.count(1)
        self._active_gens: set = set()
        self._gen_of_stage: Dict[int, int] = {}  # stage_id -> job gen
        # mesh mode: shuffle_id -> _MeshCell whose .value is the list of
        # per-partition (keys, payload) — ONE reduce per shuffle, shared
        # by every task reading it
        self._mesh_cache: Dict[int, _MeshCell] = {}
        self._mesh_lock = threading.Lock()
        # pinned stages (rdd.persist): their shuffles survive job teardown
        # so later jobs SKIP the whole producing sub-DAG and read the
        # materialized outputs — Spark's skipped-stages semantics, which
        # is also its cache recovery story: a lost map output surfaces as
        # FetchFailed and the ordinary stage retry recomputes it from the
        # pinned stage's task_fn (the captured lineage). Refcounted ids:
        # two cached RDDs sharing ancestors unpin independently.
        self._pin_counts: Dict[int, int] = {}
        self._pinned_complete: set = set()

    # -- public ----------------------------------------------------------

    def broadcast(self, value) -> "shared_vars.Broadcast":
        """Register a read-only shared value with the driver; task
        closures capturing the returned handle ship only its id, and each
        executor process fetches + caches the value at most once
        (Spark's sc.broadcast — which the reference's jobs lean on for
        map-side joins; here it rides the same control plane as the
        driver table)."""
        return shared_vars.create_broadcast(value, self.driver.native.driver)

    def pin(self, stage: MapStage) -> None:
        """Pin ``stage`` and every ancestor MapStage: their shuffles stay
        registered (with data) past job teardown, so subsequent jobs skip
        the producing stages entirely and read the materialized outputs.
        Ancestors pin too because a pinned map lost to executor failure
        recomputes via its task_fn, which reads the parent shuffles —
        lineage recovery needs the whole chain alive (Spark keeps all
        shuffle files until dependency GC for exactly this reason)."""

        seen: set = set()  # once per pin() call: diamond lineages
        # (shared memoized ancestors) must walk linearly, not per-path

        def visit(s):
            if s.stage_id in seen:
                return
            seen.add(s.stage_id)
            self._pin_counts[s.stage_id] = \
                self._pin_counts.get(s.stage_id, 0) + 1
            for p in s.parents:
                visit(p)

        visit(stage)

    def unpin(self, stage: MapStage) -> None:
        """Release one pin on ``stage`` + ancestors; a stage whose count
        hits zero has its shuffle torn down now (rdd.unpersist)."""
        seen: set = set()

        def visit(s):
            if s.stage_id in seen:
                return
            seen.add(s.stage_id)
            n = self._pin_counts.get(s.stage_id, 0) - 1
            if n > 0:
                self._pin_counts[s.stage_id] = n
            elif n == 0:
                del self._pin_counts[s.stage_id]
                self._pinned_complete.discard(s.stage_id)
                self._teardown_stage(s)
            for p in s.parents:
                visit(p)

        visit(stage)

    def _teardown_stage(self, stage) -> None:
        """Unregister one stage's shuffle everywhere and drop its engine
        state (shared by job teardown and unpin)."""
        handle = self._handles.pop(stage.stage_id, None)
        self._stages.pop(stage.stage_id, None)
        with self._recover_lock:
            self._owners.pop(stage.stage_id, None)
        if handle is None:
            return
        with self._recover_lock:
            # a late concurrent recovery must see either the full memo
            # or the post-teardown one, never a half-rebuilt set
            self._recovered = {k for k in self._recovered
                               if k[0] != handle.shuffle_id}
        with self._mesh_lock:
            self._mesh_cache.pop(handle.shuffle_id, None)
        self._mesh_degraded.pop(handle.shuffle_id, None)
        self._dist_owner.pop(handle.shuffle_id, None)
        self.driver.unregisterShuffle(handle.shuffle_id)
        # executor-side too: drops the resolver's spill data and the
        # memoized driver table, not just the driver entry — else every
        # job leaks its full shuffle dataset
        for ex in self._live():
            try:
                self._unregister_on(ex, handle.shuffle_id)
            except Exception:  # noqa: BLE001 — cleanup is best-effort; a
                # dying executor must not mask the job's real outcome
                log.warning("cleanup of shuffle %d failed on an executor",
                            handle.shuffle_id, exc_info=True)

    def warm_stats(self) -> dict:
        """Metadata-plane observability for iterative jobs: per-executor
        location-plane snapshots (cache hits = metadata RPCs NOT issued
        on warm supersteps) plus the worker cache's byte/eviction
        counters. Pinned stages (``pin``) are the warm-path unit: their
        shuffles survive job teardown, so superstep N+1's readers
        resolve them from epoch-validated caches — zero location RPCs —
        until an epoch bump (loss, re-execution) invalidates."""
        from sparkrdma_tpu_torch.shuffle import dist_cache

        planes = {}
        for i, ex in enumerate(self.executors):
            if not self._is_remote(ex) and ex.native.executor is not None:
                planes[i] = ex.native.executor.location_plane.snapshot()
        return {"location_planes": planes, "dist_cache": dist_cache.stats()}

    def accumulator(self, name: str, zero=0) -> "shared_vars.Accumulator":
        """Create a driver-owned counter tasks can ``add`` to (Spark's
        longAccumulator). Deltas merge on the driver exactly once per
        task regardless of speculation or retries."""
        acc = shared_vars.Accumulator(name, zero)
        with self._acc_lock:
            self._accs[acc.acc_id] = acc
        return acc

    def _apply_acc_deltas(self, stage_id: int, task_id: int,
                          deltas: Dict[int, object],
                          job_gen: Optional[int] = None) -> None:
        """Merge one successful attempt's accumulator deltas, first
        success only (Spark's exactly-once guarantee for actions). A
        ``job_gen`` that is no longer active marks a straggler finishing
        after its job ended: its winner already merged (or the job
        failed), so the deltas are dropped, never double-counted."""
        if not deltas:
            return
        with self._acc_lock:
            if job_gen is None:
                job_gen = self._gen_of_stage.get(stage_id)
            if job_gen not in self._active_gens:
                return
            key = (job_gen, stage_id, task_id)
            if key in self._acc_applied:
                return
            self._acc_applied.add(key)
            accs = [(self._accs.get(acc_id), delta)
                    for acc_id, delta in deltas.items()]
        for acc, delta in accs:
            if acc is None:
                log.warning("dropping deltas for unknown accumulator "
                            "(created outside this engine?)")
            else:
                acc._merge(delta)

    def run(self, final: ResultStage) -> List[object]:
        """Execute the DAG rooted at ``final``; returns its tasks' values."""
        order = self._topo_order(final)
        registered: List[MapStage] = []
        with self._acc_lock:
            job_gen = next(self._job_gens)
            self._active_gens.add(job_gen)
            for s in [*order, final]:
                self._gen_of_stage[s.stage_id] = job_gen
        try:
            for stage in order:
                registered.append(stage)  # before running: a mid-stage
                # failure must still unregister the freshly-made shuffle
                self._run_map_stage(stage)
            with self.tracer.span("engine.stage", "engine",
                                  stage=final.stage_id,
                                  tasks=final.num_tasks):
                return self._run_stage_tasks(final)
        finally:
            # close this job's accumulator generation: its ledger entries
            # go, late stragglers carrying this gen are dropped at apply,
            # and a reused stage_id maps cleanly onto the next job's gen
            with self._acc_lock:
                self._active_gens.discard(job_gen)
                self._acc_applied = {k for k in self._acc_applied
                                     if k[0] != job_gen}
                for s in [*order, final]:
                    if self._gen_of_stage.get(s.stage_id) == job_gen:
                        del self._gen_of_stage[s.stage_id]
            for stage in registered:
                # a pinned stage that COMPLETED keeps its shuffle for
                # later jobs (rdd.persist); one that failed mid-run tears
                # down normally and re-registers on the next action
                if (stage.stage_id in self._pin_counts
                        and stage.stage_id in self._pinned_complete):
                    continue
                self._teardown_stage(stage)

    # -- scheduling ------------------------------------------------------

    def _topo_order(self, final) -> List[MapStage]:
        seen: Dict[int, MapStage] = {}
        order: List[MapStage] = []

        def visit(stage):
            for p in stage.parents:
                if p.stage_id in seen:
                    continue
                if (p.stage_id in self._pinned_complete
                        and p.stage_id in self._handles):
                    # pinned stage with live materialized outputs: skip it
                    # AND its whole producing sub-DAG (Spark's skipped
                    # stages); readers fetch the retained shuffle, and a
                    # lost output recovers via stage retry, not a re-run
                    continue
                seen[p.stage_id] = p
                visit(p)
                order.append(p)
        visit(final)
        return order

    def _live(self) -> List[object]:
        out = []
        members = None
        for ex in self.executors:
            if self._is_remote(ex):
                if members is None:
                    members = self.driver.native.driver.members()
                # a tombstoned member is dead regardless of what this
                # process's proxy has observed (its slot can't be resolved)
                if ex.alive and ex.manager_id in members:
                    out.append(ex)
            elif (ex.native.executor is not None
                  and not ex.native.executor.server.stopped):
                out.append(ex)
        return out

    @staticmethod
    def _is_remote(ex) -> bool:
        from sparkrdma_tpu_torch.tasks import RemoteExecutor

        return isinstance(ex, RemoteExecutor)

    def _slot_of(self, ex) -> int:
        """The executor's stable membership slot, or -1 if it has been
        tombstoned since the caller's liveness check (a racing loss must
        flow into the retry machinery, not raise ValueError)."""
        if self._is_remote(ex):
            members = self.driver.native.driver.members()
            try:
                return members.index(ex.manager_id)
            except ValueError:
                return -1
        return ex.native.executor.exec_index(timeout=1)

    def _unregister_on(self, ex, shuffle_id: int) -> None:
        if self._is_remote(ex):
            ex.unregister_shuffle(shuffle_id)
        else:
            ex.unregisterShuffle(shuffle_id)

    def _invalidate_on(self, ex, shuffle_id: int) -> None:
        if self._is_remote(ex):
            ex.invalidate_shuffle(shuffle_id)
        else:
            ex.native.executor.invalidate_shuffle(shuffle_id)

    def _run_map_stage(self, stage: MapStage) -> None:
        shuffle_id = next(_shuffle_ids)
        handle = self.driver.registerShuffle(shuffle_id, stage.num_tasks,
                                             stage.dep)
        self._handles[stage.stage_id] = handle
        self._stages[stage.stage_id] = stage
        with self._recover_lock:
            self._owners[stage.stage_id] = {}
        with self.tracer.span("engine.stage", "engine",
                              stage=stage.stage_id, shuffle=shuffle_id,
                              tasks=stage.num_tasks):
            self._run_stage_tasks(stage)
        # adaptive reduce planning (shuffle/planner.py): the map stage
        # just completed, so the driver's size histogram is full — build
        # + publish the plan NOW so the consuming stage's tasks place on
        # the executors already holding their bytes. No-op (returns
        # None) with adaptive_plan off.
        drv = self.driver.native.driver
        if drv is not None and self.driver.native.conf.adaptive_plan:
            drv.build_reduce_plan(shuffle_id, tracer=self.tracer)
        if stage.stage_id in self._pin_counts:
            self._pinned_complete.add(stage.stage_id)

    def _run_stage_tasks(self, stage) -> List[object]:
        """All of a stage's tasks, up to max_parallel_tasks in flight
        (ordered results)."""
        if self.max_parallel_tasks <= 1 or stage.num_tasks <= 1:
            return [self._run_task(stage, t, mgr=self._preferred(stage, t))
                    for t in range(stage.num_tasks)]
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(
            max_workers=min(self.max_parallel_tasks, stage.num_tasks),
            thread_name_prefix=f"stage-{stage.stage_id}")
        try:
            if self.speculation:
                return self._collect_speculative(stage, pool)
            futures = [pool.submit(self._run_task, stage, t,
                                   self._preferred(stage, t))
                       for t in range(stage.num_tasks)]
            return [f.result() for f in futures]
        except BaseException:
            # first failure aborts the stage: drop queued siblings now
            # instead of letting each burn its full retry budget
            # (already-running attempts finish their bounded retries in
            # the background; they can no longer affect the result)
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        finally:
            pool.shutdown(wait=False)

    def _collect_speculative(self, stage, pool) -> List[object]:
        """Await a stage's tasks, racing backups against stragglers.

        Straggle time is measured from when a task actually STARTS (a
        task queued behind the parallelism bound is waiting, not slow —
        Spark measures the same way). Backups go to a dedicated pool (a
        straggler may be occupying a primary slot) and avoid the
        primary's executor. The loser attempt's outcome is ignored — it
        finishes (or exhausts its retries) in the background.
        """
        import statistics
        import time as time_mod
        from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
        from concurrent.futures import wait as fwait

        n = stage.num_tasks
        start: Dict[int, float] = {}  # stamped at launch, worker-side

        def timed(t: int):
            start[t] = time_mod.monotonic()
            return self._run_task(stage, t, mgr=self._preferred(stage, t))

        meta = {pool.submit(timed, t): t for t in range(n)}
        speculated: set = set()  # tasks that got their ONE backup
        backups: set = set()     # backup futures (their win durations
        # would be measured from the PRIMARY's start — excluding them
        # keeps the median honest for later speculation thresholds)
        results: Dict[int, object] = {}
        durations: List[float] = []
        backup_pool = ThreadPoolExecutor(
            max_workers=n, thread_name_prefix=f"spec-{stage.stage_id}")
        try:
            while len(results) < n:
                done, _ = fwait(set(meta), timeout=0.05,
                                return_when=FIRST_COMPLETED)
                for f in done:
                    t = meta.pop(f)
                    if t in results:
                        continue  # the other attempt already won
                    try:
                        results[t] = f.result()
                        if f not in backups:
                            durations.append(time_mod.monotonic() - start[t])
                    except Exception:
                        # a sibling attempt may still win; only a task
                        # with NO attempt left fails the stage
                        if not any(mt == t for mt in meta.values()):
                            raise
                # enough evidence + a RUNNING straggler => ONE backup
                if len(durations) >= max(1, n // 2):
                    threshold = max(
                        0.25, self.speculation_multiplier
                        * statistics.median(durations))
                    now = time_mod.monotonic()
                    for t in range(n):
                        if (t in results or t in speculated
                                or t not in start
                                or now - start[t] <= threshold):
                            continue
                        speculated.add(t)
                        log.info("stage %d task %d: speculative copy "
                                 "after %.2fs (median %.2fs)",
                                 stage.stage_id, t, now - start[t],
                                 statistics.median(durations))
                        try:  # keep the backup off the primary's node —
                            # the owner-preferred executor when placement
                            # used one (dist mesh or plan locality), else
                            # the round-robin pick the primary got
                            avoid = (self._preferred(stage, t)
                                     or self._pick_live(t))
                        except RuntimeError:
                            avoid = None
                        b = backup_pool.submit(
                            self._run_task, stage, t, avoid_first=avoid)
                        backups.add(b)
                        meta[b] = t
            return [results[t] for t in range(n)]
        finally:
            backup_pool.shutdown(wait=False, cancel_futures=True)

    def _run_task(self, stage, task_id: int,
                  mgr: Optional[SparkCompatShuffleManager] = None,
                  avoid_first=None):
        """One task with FetchFailed-driven stage retry.

        The budget counts repeated failures per shuffle: one executor loss
        damaging several parent shuffles costs the task one recovery per
        parent (each makes forward progress), not its whole budget.
        ``avoid_first`` steers the initial pick away from an executor
        (speculative copies race on a different node than the primary).
        """
        from sparkrdma_tpu_torch.tasks import ExecutorLostError

        attempts_by_shuffle: Dict[int, int] = {}
        first = True
        avoid = avoid_first
        while True:
            target = mgr if mgr is not None and first else \
                self._pick_live(task_id, avoid=avoid)
            first = False
            try:
                with self.tracer.span("engine.task", "engine",
                                      stage=stage.stage_id, task=task_id,
                                      remote=self._is_remote(target)):
                    return self._attempt_task(stage, task_id, target)
            except _JobTornDownError:
                log.debug("stage %d task %d: attempt abandoned, job torn "
                          "down", stage.stage_id, task_id)
                return None
            except FetchFailedError as e:
                n = attempts_by_shuffle.get(e.shuffle_id, 0) + 1
                attempts_by_shuffle[e.shuffle_id] = n
                if n > self.max_stage_retries:
                    raise
                log.warning("stage %d task %d: %s; retrying (%d)",
                            stage.stage_id, task_id, e, n)
                try:
                    self._recover_shuffle(e)
                except _JobTornDownError:
                    log.debug("stage %d task %d: abandoned mid-recovery, "
                              "job torn down", stage.stage_id, task_id)
                    return None
            except ExecutorLostError as e:
                # delivery failure: nothing ran, so no shuffle to repair —
                # place the task on a DIFFERENT live executor (a timed-out
                # target stays alive, so round-robin alone would re-pick
                # it every attempt and burn the budget on one slow node)
                n = attempts_by_shuffle.get(-1, 0) + 1
                attempts_by_shuffle[-1] = n
                if n > self.max_stage_retries:
                    raise
                avoid = target
                log.warning("stage %d task %d: %s; re-placing (%d)",
                            stage.stage_id, task_id, e, n)

    def _pick_live(self, task_id: int, avoid=None):
        live = self._live()
        if avoid is not None and len(live) > 1:
            live = [ex for ex in live if ex is not avoid]
        # elastic membership: DRAINING slots still serve reads but take
        # no new tasks — placement steers around them unless they are
        # all that remains (parallel/membership.py; pre-elastic drivers
        # have an empty draining set, so this is a no-op there)
        draining = self._draining_slots()
        if draining and len(live) > 1:
            placeable = [ex for ex in live
                         if self._slot_of(ex) not in draining]
            if placeable:
                live = placeable
        if not live:
            raise RuntimeError("no live executors")
        return live[task_id % len(live)]

    def _draining_slots(self) -> set:
        drv = getattr(self.driver.native, "driver", None)
        if drv is None or not hasattr(drv, "membership"):
            return set()
        return drv.membership.draining_slots()

    def _attempt_task(self, stage, task_id: int, target):
        from dataclasses import replace

        # bind the accumulator generation NOW: an attempt abandoned by
        # its job but still running must carry the OLD gen, so its late
        # deltas drop instead of landing under a reused stage_id's new job
        with self._acc_lock:
            job_gen = self._gen_of_stage.get(stage.stage_id)

        # snapshot handles with .get: the job may tear down concurrently
        # (abandoned speculative losers / cancelled siblings) — a missing
        # handle means this attempt's outcome no longer matters
        handle = self._handles.get(stage.stage_id) \
            if isinstance(stage, MapStage) else None
        raw_parents = [self._handles.get(p.stage_id) for p in stage.parents]
        if (isinstance(stage, MapStage) and handle is None) \
                or any(h is None for h in raw_parents):
            raise _JobTornDownError(stage.stage_id)
        # read-side handles don't need the combiner closure (it can
        # capture large state); strip it so shipped descriptors stay small
        parent_handles = [replace(h, combiner=None) for h in raw_parents]
        if self._is_remote(target):
            if isinstance(stage, MapStage):
                _, deltas = target.run_map_task(
                    stage.task_fn, handle, parent_handles,
                    task_id)  # combiner rides the handle
                self._record_owner(stage.stage_id, task_id, target)
                self._apply_acc_deltas(stage.stage_id, task_id, deltas,
                                       job_gen)
                return None
            result, deltas = target.run_result_task(
                stage.task_fn, parent_handles, task_id)
            self._apply_acc_deltas(stage.stage_id, task_id, deltas, job_gen)
            return result
        ctx = TaskContext(self, target, stage, task_id)
        with shared_vars.collecting() as deltas:
            if isinstance(stage, MapStage):
                writer = target.getWriter(handle, task_id)  # combiner on handle
                try:
                    stage.task_fn(ctx, writer, task_id)
                except BaseException:
                    writer.stop(False)
                    raise
                writer.stop(True)
                self._record_owner(stage.stage_id, task_id, target)
                result = None
            else:
                result = stage.task_fn(ctx, task_id)
        self._apply_acc_deltas(stage.stage_id, task_id, deltas, job_gen)
        return result

    def _record_owner(self, stage_id: int, task_id: int, target) -> None:
        owners = self._owners.get(stage_id)
        if owners is not None:  # gone = job already torn down; late
            # publishes of an abandoned attempt are harmless (idempotent)
            owners[task_id] = self._slot_of(target)

    # -- mesh data plane (shuffle/mesh_service.py) -----------------------

    def _preferred(self, stage, task_id: int):
        """Task placement preference, strongest first: the dist-mesh
        owner (a local cache hit beats everything), else the adaptive
        reduce plan's locality pick (the executor already holding the
        largest share of the task's input bytes)."""
        return (self._dist_preferred(stage, task_id)
                or self._plan_preferred(stage, task_id))

    def _plan_preferred(self, stage, task_id: int):
        """The adaptive plan's placement for this reduce task's
        partition, mapped onto a live executor (shuffle/planner.py).
        None when no parent has a published plan (adaptive_plan off),
        the plan has no preference, or the slot is gone — the caller
        falls back to round-robin, so placement is advisory, never a
        correctness dependency."""
        drv = self.driver.native.driver
        if drv is None or not hasattr(drv, "reduce_plan"):
            return None
        for p in stage.parents:
            h = self._handles.get(p.stage_id)
            if h is None:
                continue
            plan = drv.reduce_plan(h.shuffle_id)
            if plan is None:
                continue
            slot = plan.placement_of(task_id)
            if slot < 0:
                continue
            for ex in self._live():
                if self._slot_of(ex) == slot:
                    return ex
        return None

    def _dist_preferred(self, stage, task_id: int):
        """The executor whose process received task_id's partition in the
        distributed mesh reduce, if any — placement there makes the
        reduce read a local cache hit instead of a TCP fetch."""
        if self.dist_mesh_axis is None:
            return None
        for p in stage.parents:
            h = self._handles.get(p.stage_id)
            if h is None:
                continue
            ex = self._dist_owner.get(h.shuffle_id, {}).get(task_id)
            if ex is not None and getattr(ex, "alive", True):
                return ex
        return None

    def _mesh_read(self, handle, partition: int) -> Optional[CompatReader]:
        """A reader over ``partition`` served from the collective reduce,
        or None when the stage rides the host dataplane (cost-model
        choice or a mid-stage degrade) — the caller falls back to the
        ordinary ``getReader`` fetch path."""
        from sparkrdma_tpu_torch.shuffle.mesh_service import CachedPartitionReader

        per_part = self._mesh_partitions(handle)
        if per_part is _HOST_PLANE:
            return None
        return CompatReader(CachedPartitionReader(
            per_part, partition, partition + 1, handle.row_payload_bytes))

    def _mesh_partitions(self, handle):
        """The parent shuffle's per-partition results (or the
        ``_HOST_PLANE`` marker when the stage rides the host dataplane),
        computing the ONE mesh reduce on first use. Raises
        FetchFailedError (feeding the ordinary stage-retry machinery)
        when a map output is on no live executor — the mesh-mode
        analogue of a failed remote fetch.

        Per-shuffle compute cells: ``_mesh_lock`` guards only the cache
        dict, so independent shuffles reduce concurrently and cache hits
        never wait behind another shuffle's first-touch compute."""
        sid = handle.shuffle_id
        with self._mesh_lock:
            cell = self._mesh_cache.get(sid)
            if cell is None:
                cell = _MeshCell()
                self._mesh_cache[sid] = cell
        with cell.lock:
            if cell.value is None:
                try:
                    cell.value = self._compute_mesh_partitions(handle)
                except BaseException:
                    # a failed compute must not wedge the cell: drop it so
                    # the retry (post-recovery) computes fresh
                    with self._mesh_lock:
                        if self._mesh_cache.get(sid) is cell:
                            del self._mesh_cache[sid]
                    raise
            return cell.value

    def _compute_mesh_partitions(self, handle):
        from sparkrdma_tpu_torch.shuffle.mesh_service import (
            run_mesh_reduce_fused,
            split_by_partition,
        )

        sid = handle.shuffle_id
        if sid in self._mesh_degraded:
            self.tracer.instant("exchange.select", "exchange",
                                shuffle=sid, plane="host",
                                reason=self._mesh_degraded[sid])
            return _HOST_PLANE
        mgrs = [ex.native for ex in self._live()]
        present: set = set()
        sizes: Dict[int, int] = {}
        for mgr in mgrs:
            if mgr.resolver is not None:
                for m, b in mgr.resolver.local_output_bytes(sid).items():
                    present.add(m)
                    sizes.setdefault(m, b)  # dedupe speculative copies
        missing = sorted(set(range(handle.num_maps)) - present)
        if missing:
            stage_id = next(
                (s for s, h in self._handles.items()
                 if h.shuffle_id == sid), None)
            if stage_id is None:
                raise _JobTornDownError(sid)
            slot = self._owners.get(stage_id, {}).get(missing[0], -1)
            self._mesh_degraded[sid] = "mid-stage executor loss"
            self.tracer.instant("exchange.degrade", "exchange",
                                shuffle=sid, reason="executor_loss",
                                map=missing[0])
            raise FetchFailedError(
                sid, missing[0], slot,
                "map output on no live executor (mesh staging)")
        # receive headroom: with P partitions on D devices only min(P, D)
        # devices receive at all, so a receiver's fair share is
        # ceil(D/min(P,D)) x the per-device send capacity — double that
        # for key skew (the caller-visible knob stays the host degrade)
        n_dev = self.mesh.num_shards
        fan_in = -(-n_dev // max(1, min(handle.num_partitions, n_dev)))
        out_factor = 2 * fan_in
        plan = self._select_plan(handle, sum(sizes.values()), out_factor)
        self.tracer.instant("exchange.select", "exchange", shuffle=sid,
                            plane=plan.plane, impl=plan.impl,
                            rows_per_round=plan.rows_per_round,
                            reason=plan.reason)
        if plan.plane not in ("device", "hierarchical"):
            return _HOST_PLANE
        # deprecated escape hatch: an explicit mesh_rows_per_round (ctor
        # arg or conf key) pins the round size over the budget-derived
        # auto-sizing — one deprecation warning per process
        conf = getattr(self.driver.native, "conf", None)
        legacy_rows = self.mesh_rows_per_round or (
            conf.mesh_rows_per_round if conf is not None else 0)
        if legacy_rows:
            from sparkrdma_tpu_torch.parallel.device_plane import (
                warn_mesh_rows_deprecated,
            )

            warn_mesh_rows_deprecated()
        rows_per_round = legacy_rows or plan.rows_per_round
        try:
            if plan.plane == "hierarchical":
                from sparkrdma_tpu_torch.shuffle.mesh_service import (
                    run_mesh_reduce_hier,
                )

                results = run_mesh_reduce_hier(
                    mgrs, handle, self.mesh, plan.topology,
                    impl=plan.impl,
                    rows_per_round=rows_per_round, out_factor=out_factor,
                    expect_maps=handle.num_maps, tracer=self.tracer)
            else:
                results = run_mesh_reduce_fused(
                    mgrs, handle, self.mesh,
                    impl=plan.impl, rows_per_round=rows_per_round,
                    out_factor=out_factor, expect_maps=handle.num_maps,
                    tracer=self.tracer)
        except OverflowError as e:
            # skew beat the headroom for this stage: degrade exactly
            # this stage to the host dataplane instead of failing
            self._mesh_degraded[sid] = "receive overflow"
            self.tracer.instant("exchange.degrade", "exchange",
                                shuffle=sid, reason="overflow")
            log.warning("mesh shuffle %d: %s; serving the stage from "
                        "the host dataplane", sid, e)
            return _HOST_PLANE
        except FetchFailedError:
            # an output vanished between the completeness check and the
            # staging read (executor dying mid-stage): after recovery,
            # the retry serves this stage from the host dataplane
            self._mesh_degraded[sid] = "mid-stage executor loss"
            self.tracer.instant("exchange.degrade", "exchange",
                                shuffle=sid, reason="executor_loss")
            raise
        return split_by_partition(results, handle.num_partitions,
                                  handle.row_payload_bytes)

    def _select_plan(self, handle, est_bytes: int, out_factor: int):
        """Ask the cost model which plane carries this stage; engine
        ctor args override conf keys override "auto". On a multi-slice
        topology (detected from the mesh / the ``slice_topology`` conf
        key, gated by ``hierarchical_exchange``) the model may answer
        HIERARCHICAL — per-slice ICI with a DCN residue — scored by the
        two-level link cost; single-slice meshes get the flat selector
        bit-for-bit."""
        from sparkrdma_tpu_torch.parallel import topology as topology_mod
        from sparkrdma_tpu_torch.parallel.device_plane import (
            StageProfile,
            select_dataplane,
        )
        from sparkrdma_tpu_torch.shuffle.mesh_service import device_row_words

        conf = getattr(self.driver.native, "conf", None)
        override = self.dataplane
        if override == "auto" and conf is not None:
            override = conf.device_plane
        budget = self.device_hbm_budget or (
            conf.device_hbm_budget if conf is not None else 64 << 20)
        # tenancy: device HBM is the scarcest shared resource — when
        # several tenants hold registered shuffles, each stage plans its
        # rounds against the tenant's slice (tenant_hbm_quota, or an
        # even share) so concurrent tenants' rounds can't sum past the
        # device. Single-tenant: n_tenants == 1 and the full budget
        # passes through untouched.
        if conf is not None and not self.device_hbm_budget:
            from sparkrdma_tpu_torch.shuffle import tenancy
            drv = getattr(self.driver.native, "driver", None)
            n_tenants = (drv.active_tenant_count()
                         if drv is not None else 1)
            budget = min(budget,
                         tenancy.effective_hbm_budget(conf, n_tenants))
        topo = None
        if self.mesh is not None and (conf is None
                                      or conf.hierarchical_exchange):
            topo = topology_mod.detect_topology(self.mesh, conf)
        row_bytes = 4 * device_row_words(handle.row_payload_bytes)
        profile = StageProfile(est_bytes=est_bytes, row_bytes=row_bytes,
                               resident=True, out_factor=out_factor)
        return select_dataplane(self.mesh, profile,
                                impl=self.mesh_impl, hbm_budget=budget,
                                override=override, topology=topo)

    # -- recovery (scala/RdmaShuffleFetcherIterator.scala:376-381) -------

    def _recover_shuffle(self, failure: FetchFailedError) -> None:
        """Recompute every map of the failed shuffle owned by the dead slot
        on surviving executors; positional republish repairs the table.
        Serialized: with parallel tasks, N readers tripping over one dead
        executor trigger ONE repair (later arrivals see it recorded and
        just retry)."""
        with self._recover_lock:
            key = (failure.shuffle_id, failure.exec_index)
            stage = self._stage_of_shuffle(failure.shuffle_id)
            if stage is None:
                # every in-tree reader goes through engine-registered
                # shuffles, so an unknown shuffle means run()'s finally
                # tore the job down while this (abandoned) attempt was
                # mid-fetch — exit quietly, don't burn retries
                raise _JobTornDownError(failure.shuffle_id)
            owners = self._owners.get(stage.stage_id, {}).values()
            # Skip only when this exact loss was repaired AND the repair
            # stuck (no map still owned by the dead/unknown slot). A
            # memo hit must never suppress a recovery the table still
            # needs — e.g. unpublished-map failures (exec_index -1) can
            # name different maps each time, so they always re-run.
            if (failure.exec_index >= 0 and key in self._recovered
                    and not any(slot == failure.exec_index or slot < 0
                                for slot in owners)):
                return
            self._recover_shuffle_locked(failure)
            if self.dist_mesh_axis is not None:
                # worker caches were invalidated by the recovery ship;
                # drop the driver's ownership memo too so the next stage
                # re-enters the collective over the repaired table
                self._dist_owner.pop(failure.shuffle_id, None)
            if failure.exec_index >= 0:
                self._recovered.add(key)

    def _stage_of_shuffle(self, shuffle_id: int):
        """The registered stage producing ``shuffle_id``, or None mid/post
        teardown (handles pop before stages in run()'s finally, so both
        maps are consulted defensively)."""
        for s in list(self._stages.values()):
            h = self._handles.get(s.stage_id)
            if h is not None and h.shuffle_id == shuffle_id:
                return s
        return None

    def _recover_shuffle_locked(self, failure: FetchFailedError) -> None:
        stage = self._stage_of_shuffle(failure.shuffle_id)
        if stage is None:
            raise _JobTornDownError(failure.shuffle_id)
        owners = self._owners.get(stage.stage_id, {})
        dead = failure.exec_index
        # slot < 0 = owner was tombstoned before its slot resolved: its
        # data is on a dead executor too, recompute alongside
        lost = [m for m, slot in owners.items() if slot == dead or slot < 0]
        if not lost and failure.map_id >= 0:
            lost = [failure.map_id]
        # push-merge re-point: maps fully covered by merged replicas on
        # surviving executors skip the recompute — reducers resolve them
        # merged-segment-first after the epoch bump re-syncs their caches
        drv = self.driver.native.driver
        # same guard as recovery.recover_lost_maps: a plan with
        # map-range-split tasks cannot consume merged segments, so a
        # re-point would strand those readers on the dead owner
        split_active = False
        if hasattr(drv, "reduce_plan"):
            plan = drv.reduce_plan(failure.shuffle_id)
            # stage.num_tasks IS the map count (registerShuffle uses it)
            split_active = plan is not None and any(
                t.is_split(stage.num_tasks) for t in plan.tasks)
        if lost and not split_active and hasattr(drv, "merged_covering"):
            covered = drv.merged_covering(failure.shuffle_id, lost,
                                          exclude_slot=dead)
            if covered:
                log.warning("recovering shuffle %d: re-pointing maps %s "
                            "to merged replicas (no re-execution)",
                            failure.shuffle_id, sorted(covered))
                lost = [m for m in lost if m not in covered]
        live = [m for m in self._live()
                if self._slot_of(m) not in (dead, -1)]
        # a DRAINING slot must not adopt recomputed maps (it is about to
        # leave and would immediately need to re-replicate them) unless
        # it is all that remains
        draining = self._draining_slots()
        if draining:
            placeable = [m for m in live
                         if self._slot_of(m) not in draining]
            if placeable:
                live = placeable
        if not live:
            raise RuntimeError("no surviving executors to recompute on")
        log.warning("recovering shuffle %d: recomputing maps %s lost with "
                    "slot %d", failure.shuffle_id, lost, dead)
        # a cached mesh reduce predates the loss; recompute then re-reduce
        with self._mesh_lock:
            self._mesh_cache.pop(failure.shuffle_id, None)
        for k, m in enumerate(lost):
            # recompute tasks read their parents through _run_task too, so
            # a grandparent loss recovers recursively within its own budget
            self._run_task(stage, m, mgr=live[k % len(live)])
        # publishes are one-sided (no ack) and don't change the publish
        # count, so the long-poll can't sync on a REPAIR — wait until the
        # driver table visibly stops naming the dead slot, else a retry
        # racing the in-flight republish reads the stale entry and burns
        # its budget on the same failure
        import time as time_mod

        deadline = time_mod.monotonic() + 5.0
        drv = self.driver.native.driver
        while time_mod.monotonic() < deadline:
            if not drv.has_shuffle(failure.shuffle_id):
                break  # table gone = concurrent unregister/teardown; the
                # torn-down signal handles the retry, don't hold
                # _recover_lock for the full budget
            entries = [drv.map_entry(failure.shuffle_id, m) for m in lost]
            # None here = entry not yet (re)published — keep waiting; it
            # is NOT the teardown case (has_shuffle covered that)
            if all(e is not None and e[1] != dead for e in entries):
                break
            time_mod.sleep(0.005)
        else:
            log.warning("repair publishes for shuffle %d maps %s not "
                        "visible within 5s; retries may re-fail",
                        failure.shuffle_id, lost)
        for ex in self._live():
            try:
                self._invalidate_on(ex, failure.shuffle_id)
            except Exception:  # noqa: BLE001 — a second executor dying
                # during recovery must not crash the job; its stale cache
                # only matters if it serves again, which its own failure
                # path handles
                log.warning("cache invalidation failed on an executor "
                            "during recovery", exc_info=True)
