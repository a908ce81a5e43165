"""Planned-push receive path: staged reduce inputs, resolved first.

The sender-driven half of the shuffle ("RPC Considered Harmful",
PAPERS.md): once the driver's ReducePlan names a reducer slot for a
partition, the map stage PUSHES that partition's committed bytes to the
slot instead of waiting for the reduce stage to pull them. This module
is the receiving side — a MergeStore sibling that stages pushed ranges
per ``(partition, map)`` until the local reducer consumes them:

* **Double fence.** Every push carries the committing attempt's fencing
  token AND the plan epoch the sender routed by. A stale attempt's push
  is rejected (newer fence supersedes, exactly the merge-ledger
  discipline); a stale PLAN's push is rejected, and when a re-plan
  lands (:meth:`on_plan`) every staged range stamped with an older
  epoch is released — a mid-stage re-plan supersedes stale pushes, and
  the orphaned tasks re-pull over the ordinary dataplanes. The
  ``push_vs_replan`` / ``push_vs_tombstone`` model-check scenarios
  (analysis/modelcheck.py) pin these invariants over every interleaving.
* **Staging budget** (NP-RDMA's dynamic-registration discipline,
  PAPERS.md): ranges stage in BufferPool leases up to
  ``push_staging_budget``; past it they spill to
  ``<spill_dir>/pushed/``, charged to the owning tenant's spill quota.
  A range neither budget admits is SHED — never an error, the
  partitions simply stay pull-fetched.
* **Consume.** The fetcher resolves pushed ranges FIRST — before merged
  segments, before per-map pull — via :meth:`take`, which serves only
  ranges stamped with the consuming reducer's exact plan epoch. A
  reducer whose inputs all arrived starts with zero metadata RPCs and
  zero data RPCs; any hole falls back byte-identically.
* **Lifecycle.** State is TTL'd with the shuffle: unregister / location
  epoch death drops everything (leases freed, disk charges repaid per
  tenant, files unlinked) and leaves a tombstone so a racing push can't
  park bytes nothing will ever release; any location-epoch ADVANCE
  conservatively drops the shuffle's staged rows (a repaired map's
  re-push re-stages them) while keeping the plan epoch.

Unlike :class:`~sparkrdma_tpu_torch.shuffle.push_merge.MergeStore`, staging
stays under the store lock: push bodies are small (one map x one plan
task's partition run), there is no pwrite fan-out worth overlapping,
and the lock is leaf-ordered (store -> pool / ledger only).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from sparkrdma_tpu_torch.parallel import messages as M

log = logging.getLogger(__name__)


class _PushedRange:
    """One staged ``(partition, map)`` range: bytes in memory (pool
    lease held as the charge token) or spilled to ``path`` (tenant's
    disk ledger charged)."""

    __slots__ = ("fence", "plan_epoch", "nbytes", "data", "lease",
                 "path", "tenant")

    def __init__(self, fence: int, plan_epoch: int, nbytes: int,
                 data: Optional[bytes], lease, path: Optional[str],
                 tenant: int):
        self.fence = fence
        self.plan_epoch = plan_epoch
        self.nbytes = nbytes
        self.data = data
        self.lease = lease
        self.path = path
        self.tenant = tenant


class _PushedShuffle:
    """One shuffle's staged state on a planned-push target."""

    __slots__ = ("plan_epoch", "rows", "charged", "seq")

    def __init__(self):
        self.plan_epoch = 0
        # (partition, map_id) -> _PushedRange
        self.rows: Dict[Tuple[int, int], _PushedRange] = {}
        # disk-ledger charges BY TENANT (same repay-exactly discipline
        # as MergeStore._ShuffleSegments.charged)
        self.charged: Dict[int, int] = {}
        self.seq = 0  # uniquifies spill file names across supersessions


class PushedInputStore:
    """Executor-side planned-push target: stages pushed reduce inputs
    until the local reducer consumes them (or a fence supersedes them).

    Spill files live under ``<spill_dir>/pushed/`` so they share the
    storage-health namespace without colliding with committed-output or
    merge-segment naming; cleanup rides :meth:`drop_shuffle`, driven by
    unregister / epoch death."""

    def __init__(self, resolver, conf, pool=None, tracer=None):
        from sparkrdma_tpu_torch.utils import trace as trace_mod
        from sparkrdma_tpu_torch.utils.tombstones import TombstoneCache
        self.resolver = resolver
        self.conf = conf
        self.pool = pool
        self.tracer = tracer or trace_mod.NULL
        self.dir = os.path.join(resolver.spill_dir, "pushed")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._shuffles: Dict[int, _PushedShuffle] = {}
        self._dropped = TombstoneCache(ttl_s=30.0, cap=1024)
        self.budget = int(conf.push_staging_budget)
        self._mem_bytes = 0  # store-wide lease-staged bytes
        # audit counters
        self.pushes_accepted = 0
        self.pushes_rejected = 0
        self.pushes_superseded = 0
        self.ranges_shed = 0
        self.spilled_bytes = 0
        self.takes_served = 0

    # -- push side -------------------------------------------------------

    def _spill_path(self, shuffle_id: int, partition: int, map_id: int,
                    seq: int) -> str:
        return os.path.join(
            self.dir, f"push_{shuffle_id}_{partition}_{map_id}.{seq}.bin")

    def _free_row_locked(self, row: _PushedRange) -> None:
        """Release one staged range's resources (lock held). Lease and
        ledger releases are leaf calls; the unlink is best-effort."""
        if row.lease is not None:
            row.lease.free()
            self._mem_bytes -= row.nbytes
        elif row.data is not None:
            self._mem_bytes -= row.nbytes
        if row.path is not None:
            if row.nbytes > 0:
                self.resolver.disk_ledger.release(row.tenant, row.nbytes)
            try:
                os.unlink(row.path)
            except OSError:
                pass

    def _stage_locked(self, state: _PushedShuffle, shuffle_id: int,
                      partition: int, map_id: int, seg: memoryview,
                      tenant: int) -> Optional[_PushedRange]:
        """Stage one range's bytes (lock held): lease-backed memory
        inside the budget, else tenant-charged disk spill, else None
        (shed). The lease is a pure charge/backpressure token — the
        bytes themselves are kept as-is, never copied into the view."""
        size = len(seg)
        if self.budget > 0 and self._mem_bytes + size <= self.budget:
            lease = None
            if self.pool is not None and size > 0:
                from sparkrdma_tpu_torch.shuffle.tenancy import TenantQuotaError
                try:
                    lease = self.pool.get(size, tenant=tenant)
                except (TenantQuotaError, MemoryError):
                    lease = None  # degrade to disk below
            if lease is not None or self.pool is None or size == 0:
                self._mem_bytes += size
                return _PushedRange(0, 0, size, bytes(seg), lease, None,
                                    tenant)
        # spill: charge the tenant's disk quota, then write
        try:
            # analysis: leak-ok(staged rows transfer to state.charged-equivalent; _free_row_locked repays per tenant)
            if size > 0:
                self.resolver.disk_ledger.charge(tenant, size)
        except Exception:
            return None  # over quota: shed
        path = self._spill_path(shuffle_id, partition, map_id, state.seq)
        state.seq += 1
        try:
            with open(path, "wb") as f:
                f.write(seg)
        except OSError as e:
            log.warning("pushed-range spill to %s failed: %s", path, e)
            if size > 0:
                self.resolver.disk_ledger.release(tenant, size)
            return None
        self.spilled_bytes += size
        return _PushedRange(0, 0, size, None, None, path, tenant)

    def push(self, shuffle_id: int, map_id: int, fence: int,
             plan_epoch: int, start_partition: int,
             sizes: Sequence[int], data: bytes) -> Tuple[int, bytes]:
        """Stage one map's bytes for partitions [start, start+len);
        returns ``(status, accepted)`` — one byte per pushed partition.

        Acceptance mirrors ``PushedStoreModel`` (analysis/modelcheck.py)
        exactly: a push stamped older than the store's plan epoch is
        rejected wholesale; a NEWER stamp adopts the epoch first (the
        push beat the plan broadcast here — both ride async channels),
        superseding every staged range of the older epoch; per
        ``(partition, map)`` the newest attempt fence wins and the
        superseded range's charge is released in the same lock block,
        so the ledger can never leak across the swap."""
        accepted = bytearray(len(sizes))
        view = memoryview(data)
        segs = []
        pos = 0
        for size in sizes:
            segs.append(view[pos:pos + size])
            pos += size
        with self._lock:
            if shuffle_id in self._dropped:
                # unregister already dropped this shuffle here: accepting
                # would park bytes no drop will ever release. FINALIZED
                # stops the pusher for good (same contract as MergeStore).
                self.pushes_rejected += len(sizes)
                return M.STATUS_FINALIZED, bytes(accepted)
            state = self._shuffles.get(shuffle_id)
            if state is None:
                state = _PushedShuffle()
                self._shuffles[shuffle_id] = state
            if plan_epoch < state.plan_epoch:
                self.pushes_rejected += len(sizes)
                return M.STATUS_OK, bytes(accepted)  # stale plan: shed all
            if plan_epoch > state.plan_epoch:
                self._adopt_epoch_locked(shuffle_id, state, plan_epoch)
            for i, size in enumerate(sizes):
                p = start_partition + i
                prev = state.rows.get((p, map_id))
                if prev is not None:
                    if fence <= prev.fence:
                        self.pushes_rejected += 1
                        continue  # duplicate or stale attempt's push
                    self._free_row_locked(prev)
                    del state.rows[(p, map_id)]
                    self.pushes_superseded += 1
                row = self._stage_locked(state, shuffle_id, p, map_id,
                                         segs[i], self.resolver.tenant_of(
                                             shuffle_id))
                if row is None:
                    self.ranges_shed += 1
                    self.pushes_rejected += 1
                    continue  # over both budgets: stays pull-fetched
                row.fence = fence
                row.plan_epoch = plan_epoch
                state.rows[(p, map_id)] = row
                accepted[i] = 1
                self.pushes_accepted += 1
        return M.STATUS_OK, bytes(accepted)

    # -- plan / epoch discipline -----------------------------------------

    def _adopt_epoch_locked(self, shuffle_id: int, state: _PushedShuffle,
                            plan_epoch: int) -> None:
        state.plan_epoch = plan_epoch
        stale = [k for k, r in state.rows.items()
                 if r.plan_epoch < plan_epoch]
        for k in stale:
            self._free_row_locked(state.rows.pop(k))
        if stale:
            self.pushes_superseded += len(stale)
            self.tracer.instant("push.superseded", "push",
                                shuffle=shuffle_id, epoch=plan_epoch,
                                ranges=len(stale))

    def on_plan(self, shuffle_id: int, plan_epoch: int) -> None:
        """A ReducePlan landed (broadcast or fetched): adopt its epoch,
        releasing every staged range stamped older — the re-plan moved
        those partitions' placement, and their new slots are being
        pushed by the senders' replay. Also authoritative evidence the
        id is live (re-arms a tombstone, like MergeStore)."""
        with self._lock:
            self._dropped.discard(shuffle_id)
            state = self._shuffles.get(shuffle_id)
            if state is None:
                state = _PushedShuffle()
                self._shuffles[shuffle_id] = state
            if plan_epoch > state.plan_epoch:
                self._adopt_epoch_locked(shuffle_id, state, plan_epoch)

    def note_registered(self, shuffle_id: int) -> None:
        """Re-arm a dropped id on any registration push (TenantMapMsg /
        ShardMapMsg / pushed plan) — the id was reused for a NEW
        shuffle."""
        with self._lock:
            self._dropped.discard(shuffle_id)

    def on_location_epoch(self, shuffle_id: int, epoch: int) -> None:
        """A location-epoch advance names a recovery event (executor
        loss, repair republish): conservatively release the shuffle's
        staged rows — a corrupt-output repair may rewrite bytes, and
        re-pushes re-stage under their new fences — keeping the plan
        epoch (the plan only changes via :meth:`on_plan`)."""
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            if state is None:
                return
            for row in state.rows.values():
                self._free_row_locked(row)
            state.rows.clear()

    # -- consume side ----------------------------------------------------

    def maps_staged(self, shuffle_id: int, partition: int,
                    plan_epoch: int) -> List[int]:
        """Which maps have a staged range for ``partition`` at exactly
        ``plan_epoch`` — the fetcher's coverage probe (no bytes read)."""
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            if state is None or state.plan_epoch != plan_epoch:
                return []
            return sorted(m for (p, m), r in state.rows.items()
                          if p == partition
                          and r.plan_epoch == plan_epoch)

    def take(self, shuffle_id: int, partition: int, plan_epoch: int
             ) -> Dict[int, bytes]:
        """The staged bytes for ``partition``, keyed by map — serving
        ONLY ranges stamped with the consuming reducer's exact plan
        epoch (the ``push_vs_replan`` invariant: a stale-plan push is
        never consumed). Ranges stay staged after a take (warm
        iterative re-reads hit them again); they are released by
        supersession or :meth:`drop_shuffle`. Disk reads happen outside
        the lock; a failed read yields a hole the caller pull-fills."""
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            if state is None or state.plan_epoch != plan_epoch:
                return {}
            mem: Dict[int, bytes] = {}
            spilled: List[Tuple[int, str, int]] = []
            for (p, m), row in state.rows.items():
                if p != partition or row.plan_epoch != plan_epoch:
                    continue
                if row.data is not None:
                    mem[m] = row.data
                elif row.path is not None:
                    spilled.append((m, row.path, row.nbytes))
        for m, path, nbytes in spilled:
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                log.warning("pushed-range read of %s failed: %s", path, e)
                continue
            if len(blob) == nbytes:
                mem[m] = blob
        if mem:
            self.takes_served += 1
        return mem

    # -- lifecycle -------------------------------------------------------

    def drop_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            state = self._shuffles.pop(shuffle_id, None)
            self._dropped.add(shuffle_id)
            if state is None:
                return
            for row in state.rows.values():
                self._free_row_locked(row)
            state.rows.clear()

    def stop(self) -> None:
        with self._lock:
            sids = list(self._shuffles)
        for sid in sids:
            self.drop_shuffle(sid)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "shuffles": len(self._shuffles),
                "staged_ranges": sum(len(s.rows)
                                     for s in self._shuffles.values()),
                "mem_bytes": self._mem_bytes,
                "spilled_bytes": self.spilled_bytes,
                "pushes_accepted": self.pushes_accepted,
                "pushes_rejected": self.pushes_rejected,
                "pushes_superseded": self.pushes_superseded,
                "ranges_shed": self.ranges_shed,
                "takes_served": self.takes_served,
            }
