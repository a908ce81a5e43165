"""Adaptive skew-aware reduce planner: size-driven coalesce/split/placement.

The address-table design means the driver already holds every map's
per-partition byte sizes at the stage boundary — ``MapTaskOutput`` keeps
a 16-byte ``(offset, length, buf)`` entry per reduce partition
(shuffle/map_output.py), and the streaming writer knows its partition
lengths at commit time, so each ``PublishMsg`` can carry them to the
driver for free (P * 4 bytes riding a message that already exists). This
module spends that information:

* :class:`SizeHistogram` — the driver's per-shuffle aggregation of those
  publishes: one u64 row of per-partition bytes per map, overwritten
  positionally on repair publishes exactly like the driver table itself.
* :class:`ReducePlanner` — at map-stage completion, turns the histogram
  into an epoch-stamped :class:`ReducePlan`:

  - **coalesce**: runs of contiguous tiny partitions (run total <=
    ``coalesce_target_bytes``) become ONE reducer task over the whole
    run — served as one wider vectored fetch on the coalesced dataplane
    (a coalesced reducer is just a wider ``[start, end)`` range; PR 3's
    cross-map vectored reads already batch it into a handful of frames);
  - **split**: a hot partition (> ``split_threshold_bytes``) splits
    across several reducer tasks BY MAP-RANGE — each task reads the same
    partition from a disjoint ``[map_lo, map_hi)`` slice of the map
    space, boundaries placed on the histogram's per-map prefix sums so
    the slices carry near-equal bytes. The final merge is deterministic:
    split tasks of one partition concatenate in map order. The
    by-map-range recipe is the one-pass redistribution idea of
    "Memory-efficient array redistribution through portable collective
    communication" (PAPERS.md) applied to the reduce side;
  - **placement**: each task prefers the executor already holding the
    largest share of its input bytes (``locality_placement``), subject
    to a balance cap so locality can never pile the whole stage onto the
    executor that happened to write everything.

* The plan is a one-sided, driver-published artifact ("RPC Considered
  Harmful", PAPERS.md): versioned by ``plan_epoch``, pushed on the
  announce/epoch broadcast channel (``ReducePlanMsg``), resolved
  cache-first by reducers (:class:`~.location_plane.LocationPlane` holds
  it), never negotiated. **Mid-stage re-planning** after an executor
  loss keeps every completed task's ranges; only orphaned tasks are
  re-assigned to survivors under a bumped plan epoch
  (:meth:`ReducePlanner.replan`; driven by
  ``recovery.run_planned_reduce``).

Plan epochs move independently of PR 6's location epochs: a location
epoch bump says "where the bytes live changed", a plan epoch bump says
"how the reduce work is carved up changed". Warm read-cache entries are
invalidated on either (``dist_cache.on_plan_epoch``), so a re-plan can
never serve a stale coalesced range.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# wire geometry (docs/CONFIG.md "Reduce planning"): header + fixed tasks
_PLAN_HEAD = struct.Struct("<iqiiI")    # shuffle, plan_epoch, maps, parts, n
_PLAN_TASK = struct.Struct("<iiiiii")   # id, p_lo, p_hi, m_lo, m_hi, slot


class SizeHistogram:
    """Driver-side per-shuffle aggregation of per-partition byte sizes.

    One u64 row per map, written positionally when the map's publish
    arrives (``PublishMsg`` grew an optional lengths vector) — a repair
    publish OVERWRITES the row the way it overwrites the driver-table
    entry, so the histogram tracks the live outputs exactly. All methods
    are thread-safe: publishes land from connection reader threads while
    the planner reads at the stage boundary.
    """

    def __init__(self, num_maps: int, num_partitions: int = 0):
        self.num_maps = num_maps
        self.num_partitions = num_partitions
        self._rows: Dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def add(self, map_id: int, lengths: Sequence[int]) -> None:
        """Record (or overwrite) one map's per-partition byte sizes."""
        row = np.asarray(lengths, dtype=np.uint64)
        with self._lock:
            if self.num_partitions == 0:
                self.num_partitions = len(row)
            if len(row) != self.num_partitions:
                return  # malformed publish: ignore, the plan degrades soft
            self._rows[map_id] = row

    @property
    def maps_recorded(self) -> int:
        with self._lock:
            return len(self._rows)

    def partition_totals(self) -> np.ndarray:
        """u64[P]: total bytes per reduce partition across recorded maps."""
        with self._lock:
            if not self._rows:
                return np.zeros(self.num_partitions, dtype=np.uint64)
            return np.sum(list(self._rows.values()), axis=0,
                          dtype=np.uint64)

    def total_bytes(self) -> int:
        return int(self.partition_totals().sum())

    def map_bytes(self, map_id: int, start: int, end: int) -> int:
        """Bytes map ``map_id`` contributed to partitions [start, end)."""
        with self._lock:
            row = self._rows.get(map_id)
        return int(row[start:end].sum()) if row is not None else 0

    def split_bounds(self, partition: int,
                     pieces: int) -> List[Tuple[int, int]]:
        """Partition the map space [0, num_maps) into up to ``pieces``
        contiguous ``[map_lo, map_hi)`` ranges of near-equal bytes for
        one hot partition, using the per-map prefix sums. Deterministic;
        ranges are never empty and always cover every map (zero-byte
        maps ride with a neighbor so no publish is ever orphaned)."""
        with self._lock:
            per_map = np.array([int(self._rows[m][partition])
                                if m in self._rows else 0
                                for m in range(self.num_maps)],
                               dtype=np.int64)
        total = int(per_map.sum())
        pieces = max(1, min(pieces, self.num_maps))
        if pieces == 1 or total == 0:
            return [(0, self.num_maps)]
        target = -(-total // pieces)  # ceil
        bounds: List[Tuple[int, int]] = []
        lo = 0
        acc = 0
        for m in range(self.num_maps):
            acc += int(per_map[m])
            remaining_cuts = pieces - len(bounds) - 1
            if remaining_cuts <= 0:
                break  # the last slice runs to num_maps below
            maps_left = self.num_maps - (m + 1)
            # cut once the slice carries its share — and FORCE a cut
            # when the maps left are exactly the remaining cuts, or the
            # tail could never be divided into non-empty slices
            if acc >= target or maps_left == remaining_cuts:
                bounds.append((lo, m + 1))
                lo, acc = m + 1, 0
        bounds.append((lo, self.num_maps))
        return bounds

    def snapshot(self) -> dict:
        totals = self.partition_totals()
        return {
            "maps_recorded": self.maps_recorded,
            "num_partitions": self.num_partitions,
            "total_bytes": int(totals.sum()),
            "max_partition_bytes": int(totals.max()) if len(totals) else 0,
        }


@dataclass(frozen=True)
class PlanTask:
    """One reducer task of a :class:`ReducePlan`.

    ``[start_partition, end_partition)`` is the partition range (one
    coalesced run, or a single hot partition), ``[map_start, map_end)``
    the map slice (the full map space except for split tasks), and
    ``placement`` the preferred executor slot (-1 = no preference)."""

    task_id: int
    start_partition: int
    end_partition: int
    map_start: int
    map_end: int
    placement: int = -1

    def is_split(self, num_maps: int) -> bool:
        return not (self.map_start == 0 and self.map_end == num_maps)

    def covers(self, partition: int) -> bool:
        return self.start_partition <= partition < self.end_partition


@dataclass(frozen=True)
class ReducePlan:
    """An epoch-stamped carve-up of one shuffle's reduce stage.

    A driver-published artifact: built once at map-stage completion,
    pushed as ``ReducePlanMsg`` on the broadcast channel, cached by
    reducers under ``plan_epoch``. Tasks are ordered by
    ``(start_partition, map_start)`` — the deterministic merge order for
    split partitions — and their ranges tile the
    ``(partition, map)`` space exactly (asserted by tests): every row is
    read by exactly one task, so re-plans can move placement without
    ever duplicating or losing a row."""

    shuffle_id: int
    plan_epoch: int
    num_maps: int
    num_partitions: int
    tasks: Tuple[PlanTask, ...]

    @property
    def is_identity(self) -> bool:
        """True iff this plan is exactly today's static plan: one task
        per partition over the full map space (placement aside)."""
        if len(self.tasks) != self.num_partitions:
            return False
        return all(t.start_partition == i and t.end_partition == i + 1
                   and not t.is_split(self.num_maps)
                   for i, t in enumerate(self.tasks))

    def tasks_for_partition(self, partition: int) -> List[PlanTask]:
        return [t for t in self.tasks if t.covers(partition)]

    def placement_of(self, partition: int) -> int:
        """The preferred slot for ``partition`` (the first covering
        task's placement; -1 when the plan has no preference)."""
        for t in self.tasks:
            if t.covers(partition):
                return t.placement
        return -1

    def counts(self) -> dict:
        """Plan-shape audit: how many tasks coalesce runs, how many
        split hot partitions."""
        coalesced = sum(1 for t in self.tasks
                        if t.end_partition - t.start_partition > 1)
        split_parts = len({t.start_partition for t in self.tasks
                           if t.is_split(self.num_maps)})
        return {"tasks": len(self.tasks), "coalesced_runs": coalesced,
                "split_partitions": split_parts}

    def to_bytes(self) -> bytes:
        out = [_PLAN_HEAD.pack(self.shuffle_id, self.plan_epoch,
                               self.num_maps, self.num_partitions,
                               len(self.tasks))]
        out += [_PLAN_TASK.pack(t.task_id, t.start_partition,
                                t.end_partition, t.map_start, t.map_end,
                                t.placement) for t in self.tasks]
        return b"".join(out)

    @staticmethod
    def from_bytes(payload: bytes) -> "ReducePlan":
        sid, epoch, maps, parts, n = _PLAN_HEAD.unpack_from(payload, 0)
        tasks = []
        off = _PLAN_HEAD.size
        for _ in range(n):
            tasks.append(PlanTask(*_PLAN_TASK.unpack_from(payload, off)))
            off += _PLAN_TASK.size
        return ReducePlan(sid, epoch, maps, parts, tuple(tasks))


def identity_plan(shuffle_id: int, num_maps: int, num_partitions: int,
                  plan_epoch: int = 1) -> ReducePlan:
    """Today's static plan, as a plan object: one reducer per partition,
    full map range, no placement preference."""
    tasks = tuple(PlanTask(p, p, p + 1, 0, num_maps)
                  for p in range(num_partitions))
    return ReducePlan(shuffle_id, plan_epoch, num_maps, num_partitions,
                      tasks)


def slice_aligned_partition_map(part_bytes_by_slice, topology,
                                num_devices: int) -> np.ndarray:
    """The link-cost-aware partition->device layout (``i32[P]``): each
    partition lands in the slice that PRODUCED most of its bytes, so the
    bytes that must cross the DCN seam are minimized by construction —
    the hierarchical reduce's replacement for the flat ``p % D``
    placement (which interleaves partitions across slices and makes
    ~``1 - sum((|s|/D)^2)`` of every stage's bytes cross-slice no matter
    where they were produced).

    ``part_bytes_by_slice: i64[S, P]`` is the per-slice byte histogram
    (the same size column the adaptive planner consumes, summed by the
    producing executor's home slice). Greedy, deterministic, balanced:
    partitions place byte-descending into their best-producing slice
    (ties: lower slice) unless that slice's assigned bytes already
    exceed ``BALANCE_FACTOR`` x its devices-proportional share — then
    the least-normalized-loaded slice; within a slice, the
    least-loaded device (ties: fewest partitions, lower id). A flat
    topology reproduces ``p % D`` bit-for-bit."""
    hist = np.asarray(part_bytes_by_slice, dtype=np.int64)
    num_parts = hist.shape[1] if hist.ndim == 2 else 0
    if (topology is None or topology.is_flat or num_devices <= 0
            or hist.ndim != 2):
        return (np.arange(max(0, num_parts), dtype=np.int32)
                % max(1, num_devices))
    n_slices = hist.shape[0]
    totals = hist.sum(axis=0)
    total = int(totals.sum())
    share = np.array([topology.slice_sizes[s] / max(1, num_devices)
                      for s in range(n_slices)])
    cap = ReducePlanner.BALANCE_FACTOR * total * share
    slice_load = np.zeros(n_slices, dtype=np.int64)
    dev_lo = [topology.slice_bounds(s)[0] for s in range(n_slices)]
    dev_hi = [topology.slice_bounds(s)[1] for s in range(n_slices)]
    dev_load = np.zeros(num_devices, dtype=np.int64)
    dev_count = np.zeros(num_devices, dtype=np.int64)
    out = np.zeros(num_parts, dtype=np.int32)
    order = sorted(range(num_parts), key=lambda p: (-int(totals[p]), p))
    for p in order:
        best = max(range(n_slices),
                   key=lambda s: (int(hist[s, p]), -int(slice_load[s]), -s))
        if total and slice_load[best] >= cap[best]:
            # the producing slice already carries its fair share: spill
            # to the least-normalized-loaded slice (same existing-load
            # gate as the planner's locality placement)
            best = min(range(n_slices),
                       key=lambda s: (slice_load[s] / max(share[s], 1e-9),
                                      s))
        devs = range(dev_lo[best], dev_hi[best])
        d = min(devs, key=lambda i: (int(dev_load[i]), int(dev_count[i]),
                                     i))
        out[p] = d
        slice_load[best] += int(totals[p])
        dev_load[d] += int(totals[p])
        dev_count[d] += 1
    return out


class ReducePlanner:
    """Size-driven plan construction + mid-stage re-planning.

    Pure and deterministic: the same histogram, ownership, live-slot
    list, and config produce the identical plan (tested across seeds) —
    determinism is what lets a re-published plan be compared by epoch
    alone, and a replayed chaos seed reproduce the same task layout."""

    # locality may not load one slot past this multiple of the even share
    BALANCE_FACTOR = 1.5

    def __init__(self, conf):
        self.coalesce_target = int(conf.coalesce_target_bytes)
        self.split_threshold = int(conf.split_threshold_bytes)
        self.locality = bool(conf.locality_placement)
        # slot topology for link-cost placement: the slice_topology spec
        # partitions executor SLOTS the way it partitions devices; a
        # flat result (the default) keeps placement purely byte-driven
        self._conf = conf

    def _slot_topology(self, num_slots: int):
        """The executor-slot view of the two-level topology (None /
        flat = pre-topology placement, bit-for-bit)."""
        from sparkrdma_tpu_torch.parallel.topology import topology_for_slots

        topo = topology_for_slots(self._conf, num_slots)
        return None if topo.is_flat else topo

    @staticmethod
    def _link_cost(per_slot: Dict[int, int], slot: int, slot_slice,
                   topo) -> float:
        """Seconds to move one task's input bytes to ``slot`` under the
        two-level link coefficients: co-located bytes are free, same-
        slice bytes ride ICI, cross-slice bytes pay the DCN price — the
        planner's placement generalized from "most bytes here" to
        "cheapest link bill"."""
        gb = 1 << 30
        here = slot_slice(slot)
        cost = 0.0
        for o, b in per_slot.items():
            if o == slot:
                continue
            bw = topo.ici_gbps if slot_slice(o) == here else topo.dcn_gbps
            cost += b / (bw * gb)
        return cost

    # -- plan construction ------------------------------------------------

    def plan(self, shuffle_id: int, hist: SizeHistogram,
             owners: Dict[int, int], live_slots: Sequence[int],
             plan_epoch: int = 1, tracer=None,
             avoid_slots: Sequence[int] = ()) -> ReducePlan:
        """Build the plan for one shuffle at map-stage completion.

        ``owners`` maps map_id -> executor slot (the driver table's
        entries); ``live_slots`` the non-tombstoned membership slots.
        ``avoid_slots`` names members that still SERVE but must take no
        new reduce work (DRAINING under the elastic membership plane) —
        their bytes keep counting for locality/balance accounting, the
        placement just steers around them. Emits ``plan.coalesce`` /
        ``plan.split`` trace instants per decision so skew handling is
        visible per stage."""
        num_maps = hist.num_maps
        num_partitions = hist.num_partitions
        totals = hist.partition_totals()
        if len(totals) < num_partitions:
            totals = np.zeros(num_partitions, dtype=np.uint64)
        ranges: List[Tuple[int, int, int, int]] = []
        run_start = -1
        run_bytes = 0

        def seal_run(end: int) -> None:
            nonlocal run_start, run_bytes
            if run_start >= 0:
                ranges.append((run_start, end, 0, num_maps))
                run_start, run_bytes = -1, 0

        # split pieces target the MEAN partition size: the goal is tasks
        # near the balanced share, not tasks near the trigger threshold
        # (threshold-sized pieces would leave each split still ~3x the
        # mean and the stage still straggling on them)
        mean_bytes = max(1, int(totals.mean())) if num_partitions else 1
        for p in range(num_partitions):
            b = int(totals[p])
            if b > self.split_threshold and num_maps > 1:
                seal_run(p)
                pieces = min(num_maps,
                             -(-b // mean_bytes),
                             max(1, len(live_slots)) * 2)
                bounds = hist.split_bounds(p, pieces)
                if len(bounds) > 1:
                    if tracer is not None:
                        tracer.instant("plan.split", "plan",
                                       shuffle=shuffle_id, partition=p,
                                       pieces=len(bounds), bytes=b)
                    for lo, hi in bounds:
                        ranges.append((p, p + 1, lo, hi))
                    continue
                ranges.append((p, p + 1, 0, num_maps))
                continue
            if run_start < 0:
                run_start, run_bytes = p, b
            elif run_bytes + b <= self.coalesce_target:
                run_bytes += b
            else:
                seal_run(p)
                run_start, run_bytes = p, b
        seal_run(num_partitions)
        tasks = tuple(PlanTask(i, *r) for i, r in enumerate(ranges))
        if tracer is not None:
            for t in tasks:
                if t.end_partition - t.start_partition > 1:
                    tracer.instant(
                        "plan.coalesce", "plan", shuffle=shuffle_id,
                        start=t.start_partition, end=t.end_partition)
        plan = ReducePlan(shuffle_id, plan_epoch, num_maps,
                          num_partitions, tasks)
        return self._place(plan, hist, owners,
                           self._placeable(live_slots, avoid_slots))

    @staticmethod
    def _placeable(live_slots: Sequence[int],
                   avoid_slots: Sequence[int]) -> List[int]:
        """Placement candidates: live minus avoided (draining) slots —
        unless that empties the list, in which case avoidance yields
        (placing on a draining slot beats placing nowhere; the drain
        coordinator's coverage wait still protects the bytes)."""
        avoid = set(avoid_slots)
        keep = [s for s in live_slots if s not in avoid]
        return keep if keep else list(live_slots)

    # -- placement --------------------------------------------------------

    def _task_slot_bytes(self, task: PlanTask, hist: SizeHistogram,
                         owners: Dict[int, int]) -> Dict[int, int]:
        per_slot: Dict[int, int] = {}
        for m in range(task.map_start, task.map_end):
            slot = owners.get(m)
            if slot is None:
                continue
            nbytes = hist.map_bytes(m, task.start_partition,
                                    task.end_partition)
            per_slot[slot] = per_slot.get(slot, 0) + nbytes
        return per_slot

    def _place(self, plan: ReducePlan, hist: SizeHistogram,
               owners: Dict[int, int],
               live_slots: List[int]) -> ReducePlan:
        """Greedy locality placement under a balance cap: each task (in
        byte-descending order, so the big rocks place first) goes to the
        live slot holding the largest share of its input — or, on a
        multi-slice slot topology, the slot with the LOWEST two-level
        link bill (co-located bytes free, same-slice at ICI, cross-slice
        at DCN: ``_link_cost``), so reduce ranges land slice-aligned —
        unless that slot's assigned bytes already exceed BALANCE_FACTOR
        x the even share — then the least-loaded live slot.
        Deterministic: ties break on the lower slot index."""
        if not self.locality or not live_slots:
            return plan
        # one histogram pass per task: the slot-byte dicts feed both the
        # byte totals and the placement loop (recomputing them doubles
        # an O(tasks x maps) lock-taking walk on the stage boundary)
        slot_bytes = {t.task_id: self._task_slot_bytes(t, hist, owners)
                      for t in plan.tasks}
        task_bytes = {tid: sum(d.values()) for tid, d in slot_bytes.items()}
        total = sum(task_bytes.values())
        cap = ((total / max(1, len(live_slots))) * self.BALANCE_FACTOR
               if total else float("inf"))
        num_slots = 1 + max([*live_slots,
                             *(o for o in owners.values()
                               if o is not None and o >= 0), 0])
        topo = self._slot_topology(num_slots)
        slot_slice = ((lambda s: topo.slice_of_slot(s, num_slots))
                      if topo is not None else None)
        assigned: Dict[int, int] = {s: 0 for s in live_slots}
        placement: Dict[int, int] = {}
        order = sorted(plan.tasks,
                       key=lambda t: (-task_bytes[t.task_id], t.task_id))
        for t in order:
            per_slot = slot_bytes[t.task_id]
            if topo is not None:
                best = min(
                    (s for s in live_slots),
                    key=lambda s: (self._link_cost(per_slot, s,
                                                   slot_slice, topo),
                                   assigned[s], s))
            else:
                best = max(
                    (s for s in live_slots),
                    key=lambda s: (per_slot.get(s, 0), -assigned[s], -s))
            if assigned[best] >= cap:
                # the locality slot already carries its fair share:
                # spill to the least-loaded (the gate is on EXISTING
                # load, so one task bigger than the cap still keeps
                # its locality — moving it wouldn't rebalance anything)
                best = min(live_slots, key=lambda s: (assigned[s], s))
            placement[t.task_id] = best
            assigned[best] += task_bytes[t.task_id]
        tasks = tuple(
            PlanTask(t.task_id, t.start_partition, t.end_partition,
                     t.map_start, t.map_end, placement[t.task_id])
            for t in plan.tasks)
        return ReducePlan(plan.shuffle_id, plan.plan_epoch, plan.num_maps,
                          plan.num_partitions, tasks)

    # -- mid-stage re-planning -------------------------------------------

    def replan(self, plan: ReducePlan, hist: SizeHistogram,
               owners: Dict[int, int], live_slots: Sequence[int],
               completed_task_ids: Iterable[int],
               tracer=None, avoid_slots: Sequence[int] = ()) -> ReducePlan:
        """Re-assign ORPHANED tasks after an executor loss, under a
        bumped plan epoch. Task ranges never change — completed tasks
        keep their results, incomplete tasks keep their exact
        ``(partition, map)`` slices — only the placement of incomplete
        tasks whose slot is no longer live moves, to the live slot
        holding the largest share of their input (the lost executor's
        recomputed maps have new owners by now), least-loaded on ties.
        ``avoid_slots`` (DRAINING members) stay valid homes for tasks
        already placed there — they still serve — but orphans never
        re-home onto them. Emits one ``plan.replan`` instant naming the
        orphan count."""
        live = list(live_slots)
        # orphanhood is judged against EVERY live slot (a task on a
        # draining member is not orphaned — the member still serves);
        # re-homing candidates exclude the draining set
        candidates = self._placeable(live_slots, avoid_slots)
        completed = set(completed_task_ids)
        assigned: Dict[int, int] = {s: 0 for s in live}
        orphans: List[PlanTask] = []
        keep: Dict[int, int] = {}
        for t in plan.tasks:
            if t.task_id not in completed and t.placement not in assigned:
                orphans.append(t)
            else:
                keep[t.task_id] = t.placement
                if t.placement in assigned:
                    assigned[t.placement] += 1
        num_slots = 1 + max([*live,
                             *(o for o in owners.values()
                               if o is not None and o >= 0), 0])
        topo = self._slot_topology(num_slots)
        slot_slice = ((lambda s: topo.slice_of_slot(s, num_slots))
                      if topo is not None else None)
        new_place: Dict[int, int] = dict(keep)
        for t in orphans:
            per_slot = self._task_slot_bytes(t, hist, owners)
            if topo is not None:
                # link-cost scoring: orphans re-home to the cheapest
                # slot under the two-level coefficients, same as _place
                live_sorted = sorted(
                    candidates, key=lambda s: (self._link_cost(
                        per_slot, s, slot_slice, topo), assigned[s], s))
            else:
                live_sorted = sorted(
                    candidates, key=lambda s: (-per_slot.get(s, 0),
                                               assigned[s], s))
            best = live_sorted[0] if live_sorted else -1
            new_place[t.task_id] = best
            if best in assigned:
                assigned[best] += 1
        if tracer is not None:
            tracer.instant("plan.replan", "plan", shuffle=plan.shuffle_id,
                           epoch=plan.plan_epoch + 1,
                           orphans=len(orphans))
        tasks = tuple(
            PlanTask(t.task_id, t.start_partition, t.end_partition,
                     t.map_start, t.map_end,
                     new_place.get(t.task_id, t.placement))
            for t in plan.tasks)
        return ReducePlan(plan.shuffle_id, plan.plan_epoch + 1,
                          plan.num_maps, plan.num_partitions, tasks)


def reduce_balance(task_bytes: Sequence[int]) -> float:
    """The skew gauge: max/mean bytes per reducer task (1.0 = perfectly
    balanced; the static plan on a zipfian stage reads >> 1)."""
    arr = [b for b in task_bytes if b >= 0]
    if not arr:
        return 0.0
    mean = sum(arr) / len(arr)
    return float(max(arr) / mean) if mean else 0.0
