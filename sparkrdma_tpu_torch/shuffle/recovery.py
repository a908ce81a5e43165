"""Stage retry: recompute lost map outputs on surviving executors.

The reference's whole fault story is "surface ``FetchFailedException`` and
let the engine recompute the producing stage"
(scala/RdmaShuffleFetcherIterator.scala:376-381; executor loss observed via
``SparkListenerBlockManagerRemoved``, scala/RdmaShuffleManager.scala:155-165).
A standalone framework needs that engine half too: this module provides the
recompute loop — deterministic map tasks re-run on surviving executors, the
re-publish overwrites the dead slot's driver-table entry (publishes are
idempotent positional writes), and reducers retry.

On a TPU mesh the same concern appears as "a failed participant stalls the
collective"; the recovery mirrors the reference's: drop the dead member
(tombstone), re-form, re-run the round (SURVEY.md §7 hard part #4).

:func:`run_planned_reduce` is the adaptive-planner execution loop
(shuffle/planner.py): it drives a driver-published :class:`ReducePlan`
across the cluster and RE-PLANS mid-stage on executor loss — completed
tasks keep their results and exact ranges, only orphaned tasks are
re-assigned to survivors under a bumped plan epoch, so a loss costs the
orphans plus the recompute, never a duplicate or lost row.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

from sparkrdma_tpu_torch.parallel.driver_client import DriverUnreachableError
from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError
from sparkrdma_tpu_torch.shuffle.manager import ShuffleHandle, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.writer import WriteFailedError

log = logging.getLogger(__name__)

T = TypeVar("T")

# map_fn(writer, map_id): writes the (deterministic) records of map task m.
MapTask = Callable[[object, int], None]
# reduce_fn(manager, handle) -> result: builds + drains a reader.
ReduceTask = Callable[[TpuShuffleManager, ShuffleHandle], T]


def run_map_stage(executors: Sequence[TpuShuffleManager],
                  handle: ShuffleHandle, map_fn: MapTask,
                  map_ids: Sequence[int] = (),
                  placement: Dict[int, int] = None,
                  slot_loads: Optional[Dict[int, float]] = None,
                  exclude_slots: Sequence[int] = ()
                  ) -> Dict[int, int]:
    """Run map tasks round-robin (or per ``placement``); returns the
    executor index that ran each map.

    A :class:`WriteFailedError` — the attempt failed its DISK writes
    cleanly (spill retries and fallback dirs exhausted, merge/commit
    error, dead spill worker; every tmp/spill file already reaped) — is
    the write-side twin of a lost peer: the map re-places on the
    LEAST-LOADED live executor (not blindly the next slot), up to one
    attempt per live executor. Load = ``slot_loads`` (the caller's view
    of bytes already owned per slot — recovery feeds the planner's size
    stats here) plus the bytes this call has placed so far, so a burst
    of re-placements spreads instead of piling onto one lucky
    survivor. ``exclude_slots`` names MEMBERSHIP slots (not executor
    list indexes) that must take no new maps — the elastic plane's
    DRAINING members — unless excluding them would leave nobody."""
    live = [i for i, ex in enumerate(executors)
            if ex.executor is not None and not ex.executor.server.stopped]
    if exclude_slots:
        banned = set(exclude_slots)

        def _member_slot(i: int) -> int:
            try:
                return executors[i].executor.exec_index(timeout=0.5)
            except KeyError:
                return -1

        keep = [i for i in live if _member_slot(i) not in banned]
        if keep:
            live = keep
    loads: Dict[int, float] = {s: 0.0 for s in live}
    if slot_loads:
        for s, v in slot_loads.items():
            if s in loads:
                loads[s] += float(v)
    ran: Dict[int, int] = {}
    ids = list(map_ids) if map_ids else list(range(handle.num_maps))
    for k, m in enumerate(ids):
        first = (placement or {}).get(m, live[k % len(live)])
        # candidate order: the planned slot, then every other live slot
        # least-loaded first (deterministic: ties break on slot index)
        candidates = [first] + sorted(
            (s for s in live if s != first),
            key=lambda s: (loads.get(s, 0.0), s))
        last_err: Optional[WriteFailedError] = None
        for slot in candidates:
            writer = executors[slot].get_writer(handle, m)
            try:
                map_fn(writer, m)
                writer.close()
                ran[m] = slot
                try:
                    written = int(writer.metrics.get("bytes_written", 0))
                except (AttributeError, TypeError):
                    written = 0
                loads[slot] = loads.get(slot, 0.0) + max(1, written)
                last_err = None
                break
            except WriteFailedError as e:
                last_err = e
                log.warning("map %d write attempt failed on executor slot "
                            "%d (%s); re-placing on the least-loaded "
                            "survivor", m, slot, e)
                if not getattr(writer, "closed", True):
                    # the failure came from write_batch: abort the
                    # attempt so nothing of it survives on disk
                    try:
                        writer.close(success=False)
                    except Exception:  # noqa: BLE001 — abort best-effort
                        pass
        if last_err is not None:
            raise last_err
    return ran


def _tombstone_slot(driver: object, dead_slot: int) -> None:
    """Mark the failed slot lost at the driver (no-op without a driver
    handle, on an unknown slot, or on a slot already tombstoned —
    remove_member converges).

    A FetchFailedError names a slot, but exhausted TRANSIENT retries
    against an overloaded-yet-alive peer produce the same exception as a
    real death — and a tombstone is permanent (the slot becomes
    unroutable for every shuffle). Corroborate with one cheap dial probe
    before evicting: refused/timed-out means gone (tombstone), accepted
    means alive (the recompute alone repairs this reduce)."""
    if driver is None or dead_slot < 0:
        return
    endpoint = getattr(driver, "driver", driver)  # manager or endpoint
    if endpoint is None or not hasattr(endpoint, "remove_member"):
        return
    from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
    members = endpoint.members()
    if dead_slot >= len(members) or members[dead_slot] == TOMBSTONE:
        return
    dead = members[dead_slot]
    import socket
    try:
        probe = socket.create_connection((dead.rpc_host, dead.rpc_port),
                                         timeout=1.0)
        probe.close()
        log.warning("slot %d (%s:%s) still accepts connections; not "
                    "tombstoning a live executor over a transient failure",
                    dead_slot, dead.rpc_host, dead.rpc_port)
        return
    except OSError:
        pass
    endpoint.remove_member(dead)


def _recovery_slot_loads(table, num_maps: int, hist=None) -> Dict[int, float]:
    """Per-slot load view for recompute placement: bytes each slot
    already owns when the size histogram has them (the planner's stats),
    else a map count — the same stats the planner places with."""
    loads: Dict[int, float] = {}
    for m in range(num_maps):
        entry = table.entry(m)
        if entry is None:
            continue
        weight = 1.0
        if hist is not None:
            weight = float(hist.map_bytes(m, 0, hist.num_partitions)) or 1.0
        loads[entry[1]] = loads.get(entry[1], 0.0) + weight
    return loads


def recover_lost_maps(executors: Sequence[TpuShuffleManager],
                      handle: ShuffleHandle, map_fn: MapTask,
                      failure: FetchFailedError, endpoint,
                      driver: object = None, attempt: int = 1) -> int:
    """The shared recompute step behind every reduce retry: identify the
    maps lost with (or corrupted on) the blamed slot, recompute them on
    survivors — placed least-loaded using the same size stats the
    planner keeps — and wait for the repair publishes to become visible.
    ``endpoint`` is the recovering reducer's ExecutorEndpoint (table
    reads + cache invalidation go through it). Returns the dead slot
    (-1 for a corrupt-output verdict, where the owner stays live)."""
    dead_slot = failure.exec_index
    corrupt = getattr(failure, "verdict", "peer_lost") == "corrupt_output"
    table = endpoint.get_driver_table(handle.shuffle_id, 0, timeout=5)
    if corrupt and failure.map_id >= 0:
        # the owner is ALIVE — its committed output for THIS map
        # failed at-rest verification (and is quarantined on the
        # owner). Re-execute just that map; never tombstone a
        # live peer over bit-rot, and don't recompute its healthy
        # outputs
        lost_maps: List[int] = [failure.map_id]
        log.warning("stage retry %d: re-executing map %d of "
                    "shuffle %d (committed output corrupt on "
                    "slot %d)", attempt, failure.map_id,
                    handle.shuffle_id, dead_slot)
    else:
        # every map currently owned by the failed slot must be
        # recomputed, not just the one that tripped the fetch
        _tombstone_slot(driver, dead_slot)
        lost_maps = []
        for m in range(handle.num_maps):
            entry = table.entry(m)
            if entry is None or entry[1] == dead_slot:
                lost_maps.append(m)
        if not lost_maps and failure.map_id >= 0:
            lost_maps = [failure.map_id]
        conf = getattr(endpoint, "conf", None)
        if conf is not None and bool(getattr(conf, "cold_tier", False)):
            # cold-tier fleets: maps owned by ALREADY-tombstoned slots
            # (a prior fleet) are as lost as the blamed slot's — fold
            # them in now so one stage retry re-points (or recomputes)
            # the whole set instead of burning a retry per map
            from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
            members = endpoint.members()
            for m in range(handle.num_maps):
                if m in lost_maps:
                    continue
                entry = table.entry(m)
                if (entry is not None and entry[1] < len(members)
                        and members[entry[1]] == TOMBSTONE):
                    lost_maps.append(m)
            lost_maps.sort()
        # push-merge RE-POINT: a lost map whose EVERY reduce partition
        # is held by a merged replica on a surviving executor needs no
        # re-execution — the reducers' merged-segment-first resolution
        # serves it from the replica, so recovery just drops it from
        # the recompute set (the location-table flip: the tombstone
        # already pruned the dead slot's entries from the directory,
        # and the epoch bump makes every reducer re-sync it)
        drv_ep = getattr(driver, "driver", driver)
        # re-point only when the retrying readers can actually consume
        # merged segments: a plan with map-range-SPLIT tasks cannot (a
        # segment holds every covered map's rows — it cannot be sliced
        # to a map subset, so the fetcher bypasses merged resolution
        # for split tasks and a re-point would leave them refetching
        # the tombstoned owner forever)
        split_active = False
        if drv_ep is not None and hasattr(drv_ep, "reduce_plan"):
            plan = drv_ep.reduce_plan(handle.shuffle_id)
            split_active = plan is not None and any(
                t.is_split(handle.num_maps) for t in plan.tasks)
        if (lost_maps and not split_active and drv_ep is not None
                and hasattr(drv_ep, "merged_covering")):
            covered = drv_ep.merged_covering(handle.shuffle_id,
                                             lost_maps,
                                             exclude_slot=dead_slot)
            if covered:
                endpoint.tracer.instant(
                    "recovery.repoint", "fault",
                    shuffle=handle.shuffle_id, count=len(covered),
                    dead_slot=dead_slot)
                log.warning("stage retry %d: re-pointing maps %s of "
                            "shuffle %d to merged replicas (no "
                            "re-execution)", attempt, sorted(covered),
                            handle.shuffle_id)
                lost_maps = [m for m in lost_maps if m not in covered]
        # COLD-TIER RE-POINT: same contract one rung down — a lost map
        # whose every partition is covered by tiered blobs needs no
        # re-execution either; the reducers' TIERED rung restores it
        # from the blob store (which has no slot to die, so there is no
        # exclude_slot). The split gate applies identically: a blob
        # holds every covered map's rows and cannot serve a map-subset
        # task.
        if (lost_maps and not split_active and drv_ep is not None
                and hasattr(drv_ep, "tiered_covering")):
            cold = set(drv_ep.tiered_covering(handle.shuffle_id,
                                              lost_maps))
            if getattr(failure, "verdict", "") == "cold_unusable":
                # the blamed map's blobs already failed restore-side
                # verification — re-pointing it at the same entries
                # would loop; re-execute it (the repair publish drops
                # the bad entries at the driver)
                cold.discard(failure.map_id)
            if cold:
                endpoint.tracer.instant(
                    "recovery.repoint_cold", "fault",
                    shuffle=handle.shuffle_id, count=len(cold),
                    dead_slot=dead_slot)
                log.warning("stage retry %d: re-pointing maps %s of "
                            "shuffle %d to the cold tier (no "
                            "re-execution)", attempt, sorted(cold),
                            handle.shuffle_id)
                lost_maps = [m for m in lost_maps if m not in cold]
        if not lost_maps:
            # the whole loss re-points: invalidate so the retry
            # re-syncs table + merged directory, and return — there
            # are no repair publishes to wait for
            endpoint.invalidate_shuffle(handle.shuffle_id)
            return dead_slot
        log.warning("stage retry %d: recomputing maps %s lost with "
                    "executor slot %d", attempt, lost_maps,
                    dead_slot)
    # the entries being replaced, so the repair-visibility poll
    # below can tell an overwrite from the stale original even
    # when the new owner is the SAME slot (corrupt verdict)
    old_entries = {m: table.entry(m) for m in lost_maps}
    # survivors = executors whose endpoint slot is not the dead
    # one AND whose server is still up: with TWO dead executors,
    # the first repair must not place recomputes on the second
    # (its resolver would happily write, its publishes would
    # advertise an unreachable owner, and the reduce would burn a
    # whole extra stage retry discovering it). For a corrupt
    # verdict the blamed slot is alive and eligible — a
    # re-execution there replaces the quarantined file in place.
    # elastic membership: DRAINING slots are about to leave — they must
    # not adopt recomputed maps (the drain would immediately have to
    # re-replicate them), unless they are all that remains
    draining: set = set()
    drv_ep0 = getattr(driver, "driver", driver)
    if drv_ep0 is not None and hasattr(drv_ep0, "membership"):
        draining = drv_ep0.membership.draining_slots()
    survivors = []
    draining_survivors = []
    for i, ex in enumerate(executors):
        if ex.executor is None or ex.executor.server.stopped:
            continue
        try:
            slot = ex.executor.exec_index(timeout=1)
        except KeyError:
            continue
        if corrupt or slot != dead_slot:
            (draining_survivors if slot in draining
             else survivors).append(i)
    if not survivors:
        survivors = draining_survivors
    if not survivors:
        raise failure
    placement = {m: survivors[k % len(survivors)]
                 for k, m in enumerate(lost_maps)}
    # recompute placement prefers the least-loaded survivor, weighed by
    # the planner's size stats when the driver keeps them (satellite of
    # the adaptive planner: re-placement uses the same byte view)
    hist = None
    drv_ep = getattr(driver, "driver", driver)
    if drv_ep is not None and hasattr(drv_ep, "size_histogram"):
        hist = drv_ep.size_histogram(handle.shuffle_id)
    loads = _recovery_slot_loads(table, handle.num_maps, hist)
    run_map_stage(executors, handle, map_fn, lost_maps, placement,
                  slot_loads=loads, exclude_slots=draining)
    # publishes are one-sided (no ack) and a repair OVERWRITE
    # doesn't change the publish count, so the long-poll can't
    # sync on it: poll until the table visibly stops naming the
    # dead slot, else the next attempt races the in-flight
    # republish, reads the stale entry, and burns a whole stage
    # retry on the same failure (engine.py's recovery waits the
    # same way)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        endpoint.invalidate_shuffle(handle.shuffle_id)
        table = endpoint.get_driver_table(handle.shuffle_id, 0, timeout=5)
        entries = {m: table.entry(m) for m in lost_maps}
        if corrupt:
            # the re-execution may land on the SAME slot (new
            # token, new fence): visible = the entry CHANGED
            done = all(ent is not None and ent != old_entries[m]
                       for m, ent in entries.items())
        else:
            done = all(ent is not None and ent[1] != dead_slot
                       for ent in entries.values())
        if done:
            break
        time.sleep(0.005)
    else:
        log.warning("repair publishes for shuffle %d maps %s not "
                    "visible within 5s; the retry may re-fail",
                    handle.shuffle_id, lost_maps)
    # the repaired table must be re-read, not served from cache
    endpoint.invalidate_shuffle(handle.shuffle_id)
    return -1 if corrupt else dead_slot


def run_reduce_with_retry(executors: Sequence[TpuShuffleManager],
                          handle: ShuffleHandle, map_fn: MapTask,
                          reduce_fn: ReduceTask, reducer_index: int,
                          max_stage_retries: int = 2,
                          driver: object = None) -> T:
    """Reduce; on FetchFailed, recompute the lost maps elsewhere and retry.

    The failed map is identified from the exception; since publishes are
    positional overwrites, recomputing on any surviving executor atomically
    repairs the driver table — stragglers fetching concurrently see either
    the old (dead) or new (live) owner, and the dead one fails them into
    this same retry path.

    ``driver`` (a ``TpuShuffleManager`` driver role or ``DriverEndpoint``),
    when given, is told about the dead slot before the recompute: the
    tombstone announce makes every OTHER reducer's ``member_at`` fail fast
    on that slot instead of each independently burning a heartbeat/connect
    budget discovering the same death.
    """
    attempt = 0
    driver_waits = 0
    while True:
        try:
            return reduce_fn(executors[reducer_index], handle)
        except DriverUnreachableError as e:
            # the CONTROL PLANE is electing (driver failover), the data
            # plane is fine: no peer is dead, no map is lost. Retry the
            # sync against the (re-pointed) driver — never tombstone a
            # peer or recompute anything over it. Each wait already
            # spanned a full request_deadline_ms envelope inside
            # DriverClient, sized to ride out one driver_lease_ms
            # failover, so the bound here is a couple of envelopes.
            driver_waits += 1
            if driver_waits > max_stage_retries + 1:
                raise
            log.warning("reduce sync hit an unreachable driver (%s); "
                        "retrying against the new primary (wait %d)",
                        e, driver_waits)
        except FetchFailedError as e:
            attempt += 1
            if attempt > max_stage_retries:
                raise
            try:
                recover_lost_maps(executors, handle, map_fn, e,
                                  executors[reducer_index].executor,
                                  driver=driver, attempt=attempt)
            except DriverUnreachableError as de:
                # recovery's own driver sync died mid-failover: don't
                # charge the STAGE retry budget for a control-plane
                # blink — un-charge it and re-enter through the reduce
                driver_waits += 1
                if driver_waits > max_stage_retries + 1:
                    raise
                attempt -= 1
                log.warning("recovery sync hit an unreachable driver "
                            "(%s); retrying (wait %d)", de, driver_waits)


@dataclass
class PlannedReduceResult:
    """What :func:`run_planned_reduce` hands back: the stage's rows in
    deterministic task order, plus the plan state for audits/tests."""

    keys: np.ndarray
    payload: np.ndarray
    plan: object                      # the FINAL ReducePlan executed
    task_slots: Dict[int, int] = field(default_factory=dict)
    replans: int = 0
    tasks_rerun: int = 0              # tasks executed more than once (0 =
    #                                   every completed range was kept)


def _live_slot_managers(executors: Sequence[TpuShuffleManager]
                        ) -> Dict[int, TpuShuffleManager]:
    out: Dict[int, TpuShuffleManager] = {}
    for ex in executors:
        if ex.executor is None or ex.executor.server.stopped:
            continue
        try:
            out[ex.executor.exec_index(timeout=1)] = ex
        except KeyError:
            continue
    return out


def run_planned_reduce(executors: Sequence[TpuShuffleManager],
                       handle: ShuffleHandle, map_fn: MapTask,
                       driver: object, max_stage_retries: int = 2,
                       on_task_done=None) -> PlannedReduceResult:
    """Execute the shuffle's adaptive :class:`ReducePlan` across the
    cluster, re-planning mid-stage on executor loss.

    Resolution is cache-first against the driver's published plan; with
    no plan (adaptive planning off, mixed-version cluster) the identity
    plan runs — one reducer per partition, exactly today's behavior.
    Each task reads its ``[start_partition, end_partition)`` x
    ``[map_start, map_end)`` slice on its placed executor (falling back
    round-robin over live slots when the placement is gone).

    On ``FetchFailedError`` the lost maps recompute on survivors
    (:func:`recover_lost_maps`), then the driver RE-PLANS: completed
    tasks keep their results and exact ranges, only orphaned tasks are
    re-assigned under a bumped plan epoch — zero duplicate and zero
    lost rows, asserted by the chaos matrix. ``on_task_done(task,
    slot)`` is the chaos hook (scenarios kill executors between tasks).

    Returns rows concatenated in deterministic task order (sorted by
    ``(start_partition, map_start)`` — split slices merge in map order).
    """
    from sparkrdma_tpu_torch.shuffle.planner import identity_plan

    endpoint = getattr(driver, "driver", driver)
    plan = None
    if endpoint is not None and hasattr(endpoint, "reduce_plan"):
        plan = endpoint.reduce_plan(handle.shuffle_id)
        if plan is None:
            plan = endpoint.build_reduce_plan(handle.shuffle_id)
    if plan is None:
        plan = identity_plan(handle.shuffle_id, handle.num_maps,
                             handle.num_partitions)
    completed: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    result = PlannedReduceResult(np.zeros(0, dtype=np.uint64),
                                 np.zeros((0, handle.row_payload_bytes),
                                          dtype=np.uint8), plan)
    executions: Dict[int, int] = {}
    replans = 0
    attempt = 0
    driver_waits = 0
    while True:
        pending = [t for t in plan.tasks if t.task_id not in completed]
        if not pending:
            break
        try:
            for i, task in enumerate(pending):
                slot_mgrs = _live_slot_managers(executors)
                if not slot_mgrs:
                    raise RuntimeError("no live executors")
                live_sorted = sorted(slot_mgrs)
                slot = (task.placement if task.placement in slot_mgrs
                        else live_sorted[i % len(live_sorted)])
                mgr = slot_mgrs[slot]
                reader = mgr.get_reader(
                    handle, task.start_partition, task.end_partition,
                    map_range=(task.map_start, task.map_end))
                keys, payload = reader.read_all()
                executions[task.task_id] = \
                    executions.get(task.task_id, 0) + 1
                completed[task.task_id] = (keys, payload)
                result.task_slots[task.task_id] = slot
                if on_task_done is not None:
                    on_task_done(task, slot)
        except DriverUnreachableError as e:
            # failover window: completed tasks keep their results; the
            # next pass re-syncs against the new primary. No recompute,
            # no tombstone — the peers are fine.
            driver_waits += 1
            if driver_waits > max_stage_retries + 1:
                raise
            log.warning("planned reduce hit an unreachable driver (%s); "
                        "retrying against the new primary (wait %d)",
                        e, driver_waits)
            continue
        except FetchFailedError as e:
            attempt += 1
            if attempt > max_stage_retries:
                raise
            slot_mgrs = _live_slot_managers(executors)
            if not slot_mgrs:
                raise
            recover_ep = next(iter(slot_mgrs.values())).executor
            try:
                dead_slot = recover_lost_maps(executors, handle, map_fn, e,
                                              recover_ep, driver=driver,
                                              attempt=attempt)
            except DriverUnreachableError as de:
                driver_waits += 1
                if driver_waits > max_stage_retries + 1:
                    raise
                attempt -= 1  # a control-plane blink is not a stage retry
                log.warning("planned-reduce recovery hit an unreachable "
                            "driver (%s); retrying (wait %d)", de,
                            driver_waits)
                continue
            if endpoint is not None and hasattr(endpoint, "replan_reduce"):
                new_plan = endpoint.replan_reduce(
                    handle.shuffle_id, set(completed),
                    dead_slot=dead_slot)
                if new_plan is not None:
                    plan = new_plan
                    replans += 1
    result.plan = plan
    result.replans = replans
    result.tasks_rerun = sum(1 for n in executions.values() if n > 1)
    # deterministic merge: coalesced runs in partition order, split
    # slices of one partition in map order
    order = sorted(plan.tasks, key=lambda t: (t.start_partition,
                                              t.map_start,
                                              t.end_partition))
    keys_parts = [completed[t.task_id][0] for t in order]
    payload_parts = [completed[t.task_id][1] for t in order]
    if keys_parts:
        result.keys = np.concatenate(keys_parts)
        result.payload = np.concatenate(payload_parts)
    return result
