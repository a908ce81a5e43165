"""Multi-tenant shuffle service primitives: quotas, fair-share
scheduling, and admission control.

ROADMAP item 1 ("the clearest production gap"): everything below this
module used to assume ONE job at a time. Three small, shared primitives
make concurrent jobs first-class without touching the data planes'
byte-moving code:

* :class:`TenantLedger` — a per-tenant byte ledger for ONE scarce shared
  resource (``BufferPool`` leases, spill-dir bytes, ``dist_cache``
  bytes, merged-segment disk). Charging past the tenant's quota raises
  :class:`TenantQuotaError` — the resource owner sheds that tenant's
  load cleanly instead of letting one job OOM the host every tenant
  shares. Quota 0 = unbounded (single-tenant deployments pay nothing).

* :class:`DeficitRoundRobin` — the byte-cost fair queue both serve
  paths schedule from (the Python serve loop in
  ``parallel/endpoints.py`` and — the same discipline re-implemented in
  C — the native ``csrc/blockserver.cpp`` request queue). Classic DRR:
  each tenant keeps a deficit counter replenished by ``quantum`` bytes
  per round, and a request is dispatched only when its byte cost fits
  the deficit, so one tenant's 128-way fan-in of wide vectored reads
  cannot starve another tenant's latency-sensitive small fetch. Per
  Tiara (PAPERS.md) the per-request server work is constant-time
  (PR 11), which is exactly what makes fairness enforceable HERE — at
  the scheduler — instead of inside the data path.

* :class:`AdmissionController` — the driver-side gate on
  ``registerShuffle``: per-tenant in-flight shuffle caps with a bounded
  FIFO wait queue. Past the cap a registration parks (``admit.queue``)
  until an unregister frees a slot; past the queue depth — or the park
  deadline — it is REJECTED with a retry-after hint
  (:class:`AdmissionRejected`), so sustained overload degrades into
  backpressure the caller can act on, never into an OOM.

Tenant ids are small non-negative ints minted by the caller at
``registerShuffle``; ``DEFAULT_TENANT`` (0) is what every pre-tenancy
code path maps to, and a deployment that never passes a tenant id sees
bit-identical behavior everywhere.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

DEFAULT_TENANT = 0


class TenantQuotaError(RuntimeError):
    """A tenant's charge against a shared resource exceeded its quota.

    Deliberately NOT an OSError/MemoryError subclass: quota exhaustion
    is an admission decision, not a hardware fault, and must never be
    retried by the transient-disk/fetch envelopes."""

    def __init__(self, resource: str, tenant: int, used: int, need: int,
                 quota: int):
        super().__init__(
            f"tenant {tenant} over {resource} quota: "
            f"{used} + {need} > {quota}")
        self.resource = resource
        self.tenant = tenant
        self.used = used
        self.need = need
        self.quota = quota


class TenantLedger:
    """Thread-safe per-tenant byte accounting for one shared resource.

    ``quota`` bounds EACH tenant (0 = unbounded). ``charge`` is atomic
    check-then-add; ``release`` floors at zero so a double-release from
    a teardown race can never corrupt a later admission decision."""

    def __init__(self, resource: str, quota: int = 0):
        self.resource = resource
        self.quota = int(quota)
        self._lock = threading.Lock()
        self._used: Dict[int, int] = {}
        self.rejections = 0  # charges refused by quota, monotone

    def charge(self, tenant: int, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            used = self._used.get(tenant, 0)
            if self.quota and used + nbytes > self.quota:
                self.rejections += 1
                raise TenantQuotaError(self.resource, tenant, used,
                                       nbytes, self.quota)
            self._used[tenant] = used + nbytes

    def release(self, tenant: int, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            left = self._used.get(tenant, 0) - nbytes
            if left > 0:
                self._used[tenant] = left
            else:
                self._used.pop(tenant, None)

    def usage(self, tenant: int) -> int:
        with self._lock:
            return self._used.get(tenant, 0)

    def snapshot(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._used)


class DeficitRoundRobin:
    """Deficit-round-robin queue over per-tenant FIFO sub-queues.

    ``push(tenant, cost, item)`` enqueues; ``pop()`` returns the next
    item under DRR ordering (None when empty). Costs are bytes; the
    ``quantum`` is how many bytes each tenant may dispatch per round.
    A tenant whose queue drains forfeits its leftover deficit (the
    classic rule — an idle tenant can't bank credit and later burst).

    With a single active tenant the dispatch order IS arrival order, so
    fair-share mode degenerates to FIFO exactly for the one-job case.
    """

    def __init__(self, quantum: int = 256 << 10):
        self.quantum = max(1, int(quantum))
        self._lock = threading.Lock()
        # tenant -> deque[(cost, item)]; OrderedDict preserves the
        # round-robin visit order (new tenants join at the tail)
        self._queues: "OrderedDict[int, deque]" = OrderedDict()
        self._deficits: Dict[int, int] = {}
        self._len = 0
        self.pushed = 0   # items ever queued, monotone
        self.reordered = 0  # pops that jumped an earlier-arrived item
        self._arrival = 0  # arrival stamper for the reorder audit

    def __len__(self) -> int:
        with self._lock:
            return self._len

    def push(self, tenant: int, cost: int, item: Any) -> None:
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                q = deque()
                self._queues[tenant] = q
                self._deficits.setdefault(tenant, 0)
            self._arrival += 1
            q.append((max(0, int(cost)), item, self._arrival))
            self._len += 1
            self.pushed += 1

    def pop(self) -> Optional[Any]:
        with self._lock:
            if self._len == 0:
                return None
            # DRR: visit tenants in round-robin order; the first whose
            # head-of-queue cost fits its deficit dispatches. Each full
            # pass replenishes every visited tenant by one quantum, so
            # the loop provably terminates (cost is finite).
            while True:
                for tenant in list(self._queues):
                    q = self._queues[tenant]
                    cost, item, stamp = q[0]
                    if cost <= self._deficits[tenant]:
                        q.popleft()
                        self._len -= 1
                        if q:
                            self._deficits[tenant] -= cost
                            # move to the tail: the next round visits
                            # the other tenants first
                            self._queues.move_to_end(tenant)
                        else:
                            # drained: forfeit the leftover deficit
                            del self._queues[tenant]
                            del self._deficits[tenant]
                        # each queue is FIFO, so its HEAD carries its
                        # minimum stamp: the earlier-arrival audit scans
                        # O(tenants), not O(queued items) — pop is on
                        # the serve hot path under this lock
                        if any(dq[0][2] < stamp
                               for dq in self._queues.values()):
                            self.reordered += 1
                        return item
                    self._deficits[tenant] += self.quantum
                    self._queues.move_to_end(tenant)

    def drain(self) -> List[Any]:
        """Pop everything in DRR order (teardown / tests)."""
        out = []
        while True:
            item = self.pop()
            if item is None:
                return out
            out.append(item)


class AdmissionRejected(RuntimeError):
    """``registerShuffle`` refused: the tenant is at its in-flight cap
    and the admission queue is full (or the queued wait expired).
    ``retry_after_ms`` is the backoff hint the caller should honor."""

    def __init__(self, tenant: int, inflight: int, cap: int,
                 retry_after_ms: int):
        super().__init__(
            f"tenant {tenant} admission rejected: {inflight} shuffles "
            f"in flight (cap {cap}); retry after {retry_after_ms}ms")
        self.tenant = tenant
        self.retry_after_ms = retry_after_ms


class AdmissionController:
    """Driver-side per-tenant in-flight shuffle caps with a bounded
    FIFO wait queue (queue-or-reject with a retry-after hint).

    ``max_inflight`` 0 disables admission entirely (every pre-tenancy
    deployment). A registration over the cap parks up to
    ``retry_after_ms`` waiting for an ``on_unregister`` to free a slot;
    a full queue (``queue_depth``) or an expired park raises
    :class:`AdmissionRejected`. FIFO among waiters of the SAME tenant;
    tenants don't queue against each other's caps."""

    def __init__(self, max_inflight: int = 0, queue_depth: int = 16,
                 retry_after_ms: int = 1000):
        self.max_inflight = int(max_inflight)
        self.queue_depth = max(0, int(queue_depth))
        self.retry_after_ms = max(1, int(retry_after_ms))
        self._cond = threading.Condition()
        self._inflight: Dict[int, set] = {}    # tenant -> shuffle ids
        self._queued: Dict[int, int] = {}      # tenant -> waiter count
        self._turn: Dict[int, int] = {}        # FIFO ticket being served
        self._next_ticket: Dict[int, int] = {}
        # elastic fleet scaling (parallel/membership.py): capacity hints
        # track LIVE membership, not the startup slot count — the cap
        # and the retry-after hint scale by live/baseline, so a drained
        # fleet sheds honestly and a grown fleet admits more. (0, 0) =
        # no scaling (the static pre-elastic behavior).
        self._fleet_live = 0
        self._fleet_baseline = 0
        self.accepted = 0
        self.queued_total = 0
        self.rejected = 0

    def inflight(self, tenant: int) -> int:
        with self._cond:
            return len(self._inflight.get(tenant, ()))

    # -- elastic fleet capacity (parallel/membership.py) -----------------

    def set_fleet(self, live: int, baseline: int) -> None:
        """Teach the controller the current live executor count and the
        startup baseline it was sized for. The driver calls this on
        every membership change (join, drain begin, retire, tombstone);
        queued waiters re-evaluate against the new cap immediately."""
        with self._cond:
            self._fleet_live = max(0, int(live))
            self._fleet_baseline = max(0, int(baseline))
            self._cond.notify_all()

    def _fleet_scale_locked(self) -> float:
        if self._fleet_baseline <= 0 or self._fleet_live <= 0:
            return 1.0
        return self._fleet_live / self._fleet_baseline

    def effective_max_inflight(self) -> int:
        """The per-tenant in-flight cap under CURRENT membership (0 =
        admission off)."""
        with self._cond:
            return self._effective_cap_locked()

    def _effective_cap_locked(self) -> int:
        if self.max_inflight <= 0:
            return 0
        return max(1, int(round(self.max_inflight
                                * self._fleet_scale_locked())))

    def effective_retry_after_ms(self) -> int:
        """The retry-after hint under CURRENT membership: a drained
        fleet hands out proportionally LONGER backoff (capacity shrank,
        so retries should too), a grown fleet keeps the configured
        hint — shortening it would just synchronize retry storms."""
        with self._cond:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> int:
        scale = self._fleet_scale_locked()
        if scale >= 1.0:
            return self.retry_after_ms
        return max(1, int(round(self.retry_after_ms / max(scale, 1e-9))))

    def admit(self, tenant: int, shuffle_id: int,
              on_event: Optional[Callable[[str, int, int], None]] = None
              ) -> None:
        """Block until the tenant has a free slot, or raise
        :class:`AdmissionRejected`. ``on_event(kind, tenant, waited_ms)``
        observes 'accept' / 'queue' / 'reject' transitions (the driver
        wires trace instants here)."""
        if self.max_inflight <= 0:
            return

        def note(kind: str, waited_ms: int = 0) -> None:
            if on_event is not None:
                on_event(kind, tenant, waited_ms)

        with self._cond:
            mine = self._inflight.setdefault(tenant, set())
            if shuffle_id in mine:
                return  # idempotent re-register
            # the cap tracks LIVE membership (set_fleet), not the
            # startup slot count: a drained fleet admits less, a grown
            # fleet more, and the rejection hint stretches as capacity
            # shrinks
            if len(mine) < self._effective_cap_locked() and \
                    self._queued.get(tenant, 0) == 0:
                mine.add(shuffle_id)
                self.accepted += 1
                note("accept")
                return
            if self._queued.get(tenant, 0) >= self.queue_depth:
                self.rejected += 1
                note("reject")
                raise AdmissionRejected(tenant, len(mine),
                                        self._effective_cap_locked(),
                                        self._retry_after_locked())
            # park FIFO: tickets order same-tenant waiters
            ticket = self._next_ticket.get(tenant, 0)
            self._next_ticket[tenant] = ticket + 1
            self._queued[tenant] = self._queued.get(tenant, 0) + 1
            self.queued_total += 1
            note("queue")
            deadline = time.monotonic() + self.retry_after_ms / 1000
            try:
                while True:
                    mine = self._inflight.setdefault(tenant, set())
                    if (len(mine) < self._effective_cap_locked()
                            and self._turn.get(tenant, 0) == ticket):
                        mine.add(shuffle_id)
                        self.accepted += 1
                        note("accept", int((time.monotonic() - deadline
                                            + self.retry_after_ms / 1000)
                                           * 1000))
                        return
                    left = deadline - time.monotonic()
                    if left <= 0:
                        self.rejected += 1
                        # trace the SAME fleet-scaled hint the exception
                        # carries, or dashboards disagree with clients
                        note("reject", self._retry_after_locked())
                        raise AdmissionRejected(tenant, len(mine),
                                                self._effective_cap_locked(),
                                                self._retry_after_locked())
                    self._cond.wait(min(left, 0.5))
            finally:
                self._queued[tenant] -= 1
                if self._queued[tenant] <= 0:
                    del self._queued[tenant]
                # pass the turn whether we were admitted or expired —
                # a dead waiter must not wedge the FIFO
                self._turn[tenant] = ticket + 1
                self._cond.notify_all()

    def on_unregister(self, tenant: int, shuffle_id: int) -> None:
        with self._cond:
            mine = self._inflight.get(tenant)
            if mine is not None:
                mine.discard(shuffle_id)
                if not mine:
                    del self._inflight[tenant]
            self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "inflight": {t: len(s) for t, s in self._inflight.items()},
                "queued": dict(self._queued),
                "accepted": self.accepted,
                "queued_total": self.queued_total,
                "rejected": self.rejected,
                "fleet": (self._fleet_live, self._fleet_baseline),
                "effective_cap": self._effective_cap_locked(),
            }


def effective_hbm_budget(conf, active_tenants: int) -> int:
    """The per-tenant slice of ``device_hbm_budget`` one stage may plan
    rounds against: the explicit ``tenant_hbm_quota`` when set, else the
    global budget split evenly across the tenants currently holding
    registered shuffles — device HBM is the scarcest shared resource
    (PR 9's cost model), so a second tenant arriving halves the round
    sizing instead of letting two stages' rounds sum past the device.
    Single-tenant (or pre-tenancy) deployments see the full budget."""
    budget = conf.device_hbm_budget
    quota = conf.tenant_hbm_quota
    if quota:
        return min(budget, quota)
    return budget // max(1, int(active_tenants))
