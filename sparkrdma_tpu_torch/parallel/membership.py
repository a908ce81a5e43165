"""Epoch-versioned executor membership: mid-job join, graceful drain,
and the autoscaler loop (ROADMAP item 2).

The driver's member list used to be a static slot array where
loss-tombstoning was the only state change. This module makes membership
a versioned plane of its own:

* :class:`MembershipPlane` — the driver-side source of truth: an
  append-only slot list (indices stay stable forever, the property every
  driver-table entry depends on) plus a per-slot STATE
  (``SLOT_LIVE`` / ``SLOT_DRAINING`` / ``SLOT_DEAD``) and ONE monotone
  membership epoch. Every change — join, drain begin, retire, tombstone
  — bumps the epoch; the driver pushes the new state vector as a
  ``MembershipBumpMsg`` on the existing announce broadcast channel, so
  planners, pushers and health monitors recompute from live membership
  instead of the startup snapshot. Old peers that don't know the frame
  simply keep the announce-only view (static-membership behavior — the
  mixed-version degrade is tested).

* :func:`drain_slot` — the graceful decommission protocol, PR 10's
  repair machinery run as a PLANNED operation: mark the slot DRAINING
  (planner placement, merge-target choice and admission capacity drop it
  immediately), ask the drainee to push-merge its committed outputs to
  surviving peers (``DrainReq`` — duplicate pushes dedupe on the ledger
  fence, so a fleet whose background replication already covered
  everything pays nothing), re-finalize the merge targets so the new
  segments publish into the driver's merged directory, and wait until
  every map the drainee owns is servable WITHOUT it (a live owner
  elsewhere, or a merged replica the reducers' merged-first resolution
  selects). Then the slot retires under a bumped location epoch with
  ZERO re-executions — recovery's ``merged_covering`` re-point answers
  any straggler that still held cached locations. A drainee that dies
  mid-drain (or a deadline expiry) falls back to the ordinary tombstone
  path: same epoch bump, re-execution on demand — strictly the
  pre-drain behavior, never worse.

* :class:`Autoscaler` — the resize loop: watches per-tenant admission
  backlog, a queue-depth gauge and the ``reduce_balance`` skew gauge,
  and resizes within ``[min_executors, max_executors]`` — growth calls
  the installed ``scale_up`` hook (the embedding harness owns process
  creation), shrink picks the highest live slot (LIFO, deterministic)
  and drains it via :func:`drain_slot`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from sparkrdma_tpu_torch.utils.ids import ShuffleManagerId

log = logging.getLogger(__name__)

# Per-slot membership states. The dead state exists in the members list
# itself (the TOMBSTONE sentinel keeps indices stable); it is mirrored
# here so ONE vector answers "may I place/push/admit against this slot".
SLOT_LIVE = 0
SLOT_DRAINING = 1
SLOT_DEAD = 2


class MembershipPlane:
    """Driver-side epoch-versioned membership state.

    Thread-safe; every mutation returns the ``(members, states, epoch)``
    snapshot it produced so the caller can broadcast exactly what it
    committed (announce + membership bump) without re-reading racing
    state."""

    def __init__(self, tombstone: Optional[ShuffleManagerId] = None):
        if tombstone is None:
            from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
            tombstone = TOMBSTONE
        self._tombstone = tombstone
        self._lock = threading.Lock()
        self._members: List[ShuffleManagerId] = []
        self._states: List[int] = []
        self._epoch = 0
        # the fleet size capacity hints were tuned for: frozen at the
        # first registerShuffle (the fleet that existed when work
        # started) so admission caps scale as live/baseline afterwards
        self._baseline = 0
        self.joins = 0       # audit: members appended after the baseline
        self.drains_begun = 0

    # -- reads -----------------------------------------------------------

    def members(self) -> List[ShuffleManagerId]:
        with self._lock:
            return list(self._members)

    def states(self) -> List[int]:
        with self._lock:
            return list(self._states)

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def restore(self, members: List[ShuffleManagerId], states: List[int],
                epoch: int) -> None:
        """Install a replicated snapshot wholesale (driver failover
        restore). The epoch only ratchets up — a stale snapshot behind
        ops already replayed must not rewind the version the rebased
        re-announce is built on."""
        with self._lock:
            self._members = list(members)
            self._states = list(states)
            if epoch > self._epoch:
                self._epoch = epoch

    def rebase_epoch(self, min_epoch: int) -> int:
        """Raise the epoch floor (never lowers it) and return the result.

        A promoted driver rebases the replayed plane into its own
        incarnation's epoch space so its first re-announce dominates
        every broadcast the dead primary ever sent — receivers keep the
        highest epoch, so a stale in-flight announce from the old
        incarnation loses at every executor without any extra fencing.
        """
        with self._lock:
            if min_epoch > self._epoch:
                self._epoch = min_epoch
            return self._epoch

    def snapshot(self) -> Tuple[List[ShuffleManagerId], List[int], int]:
        with self._lock:
            return list(self._members), list(self._states), self._epoch

    def live_slots(self, include_draining: bool = False) -> List[int]:
        """Slots that may carry work: LIVE, plus DRAINING when asked
        (draining slots still SERVE — they just take no new work)."""
        ok = ((SLOT_LIVE, SLOT_DRAINING) if include_draining
              else (SLOT_LIVE,))
        with self._lock:
            return [i for i, s in enumerate(self._states) if s in ok]

    def draining_slots(self) -> Set[int]:
        with self._lock:
            return {i for i, s in enumerate(self._states)
                    if s == SLOT_DRAINING}

    def state_of(self, slot: int) -> int:
        with self._lock:
            if not 0 <= slot < len(self._states):
                return SLOT_DEAD
            return self._states[slot]

    def baseline(self) -> int:
        """The frozen startup fleet size (0 = not frozen yet: callers
        treat the current live count as the baseline)."""
        with self._lock:
            return self._baseline or len(
                [s for s in self._states if s == SLOT_LIVE])

    def freeze_baseline(self) -> int:
        """Pin the capacity baseline to the current live count (no-op
        once frozen). The driver calls this at the first
        registerShuffle — that is the fleet admission was sized for."""
        with self._lock:
            if self._baseline == 0:
                self._baseline = len(
                    [s for s in self._states if s == SLOT_LIVE])
            return self._baseline

    # -- mutations (each returns the snapshot it committed) --------------

    def join(self, manager_id: ShuffleManagerId
             ) -> Tuple[List[ShuffleManagerId], List[int], int, bool]:
        """Append (or re-greet) a member; epoch always bumps — a
        re-hello after a restart must still re-announce. Returns
        ``(members, states, epoch, is_new)``."""
        with self._lock:
            is_new = manager_id not in self._members
            if is_new:
                self._members.append(manager_id)
                self._states.append(SLOT_LIVE)
                if self._baseline:
                    self.joins += 1
            self._epoch += 1
            return (list(self._members), list(self._states), self._epoch,
                    is_new)

    def begin_drain(self, slot: int
                    ) -> Optional[Tuple[List[ShuffleManagerId],
                                        List[int], int]]:
        """LIVE -> DRAINING (None if the slot is not currently LIVE)."""
        with self._lock:
            if not 0 <= slot < len(self._states) \
                    or self._states[slot] != SLOT_LIVE:
                return None
            self._states[slot] = SLOT_DRAINING
            self._epoch += 1
            self.drains_begun += 1
            return list(self._members), list(self._states), self._epoch

    def abort_drain(self, slot: int
                    ) -> Optional[Tuple[List[ShuffleManagerId],
                                        List[int], int]]:
        """DRAINING -> LIVE (the operator changed their mind and the
        drainee is still healthy)."""
        with self._lock:
            if not 0 <= slot < len(self._states) \
                    or self._states[slot] != SLOT_DRAINING:
                return None
            self._states[slot] = SLOT_LIVE
            self._epoch += 1
            return list(self._members), list(self._states), self._epoch

    def retire(self, slot: int
               ) -> Optional[Tuple[List[ShuffleManagerId], List[int],
                                   int]]:
        """DRAINING/LIVE -> DEAD: the slot's entry becomes the tombstone
        sentinel (unroutable, index preserved)."""
        with self._lock:
            if not 0 <= slot < len(self._states) \
                    or self._states[slot] == SLOT_DEAD:
                return None
            self._members[slot] = self._tombstone
            self._states[slot] = SLOT_DEAD
            self._epoch += 1
            return list(self._members), list(self._states), self._epoch

    def tombstone(self, manager_id: ShuffleManagerId
                  ) -> Optional[Tuple[List[ShuffleManagerId], List[int],
                                      int, int]]:
        """Failure-path eviction by identity; converges (None when the
        member is unknown or already dead). Returns
        ``(members, states, epoch, dead_slot)``."""
        with self._lock:
            if manager_id not in self._members \
                    or manager_id == self._tombstone:
                return None
            slot = self._members.index(manager_id)
            self._members[slot] = self._tombstone
            self._states[slot] = SLOT_DEAD
            self._epoch += 1
            return (list(self._members), list(self._states), self._epoch,
                    slot)


# -- the graceful decommission protocol ------------------------------------

def drain_slot(driver, slot: int,
               deadline_ms: Optional[int] = None) -> Dict[str, object]:
    """Gracefully decommission one executor slot at ``driver`` (a
    :class:`~sparkrdma_tpu_torch.parallel.endpoints.DriverEndpoint`).

    Protocol (PR 10's repair path as a planned operation):

    1. mark the slot DRAINING under a bumped membership epoch (pushed on
       the broadcast channel: planner placement, merge-target choice and
       admission capacity recompute from live membership immediately);
    2. ask the drainee to replicate — ``DrainReq`` makes it re-push
       every committed map output (ledger fences dedupe what background
       push-merge already delivered) and hand off the merged-segment
       rows it HOSTS for other executors' maps to surviving targets;
    3. re-finalize merge targets of completed shuffles so the drain
       pushes publish into the merged directory;
    4. wait (bounded by ``drain_deadline_ms``) until every map of every
       registered shuffle is servable WITHOUT the drainee, then retire
       the slot: tombstone + location epoch bumps, zero re-executions —
       the maps the drainee owned re-point to merged replicas exactly
       like :func:`~sparkrdma_tpu_torch.shuffle.recovery.recover_lost_maps`'
       repoint path, with nothing to recompute.

    A drainee that dies mid-drain, a transport failure, or a deadline
    expiry FALLS BACK to the ordinary tombstone: the retire still
    happens (the operator asked for the slot back), recovery re-executes
    what no replica covers, and the result is byte-identical — strictly
    the pre-drain failure behavior.

    Returns ``{"status": "drained"|"fallback"|"unknown", "slot", ...}``
    with the re-point/re-push accounting.
    """
    from sparkrdma_tpu_torch.parallel import messages as M
    from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
    from sparkrdma_tpu_torch.parallel.transport import TransportError

    conf = driver.conf
    deadline_ms = deadline_ms or conf.drain_deadline_ms
    result: Dict[str, object] = {"status": "unknown", "slot": slot,
                                 "maps_pushed": 0, "bytes_handed_off": 0,
                                 "repointed": 0, "unservable": []}
    members = driver.members()
    if not 0 <= slot < len(members) or members[slot] == TOMBSTONE:
        return result
    from sparkrdma_tpu_torch.shuffle.ha import DRAIN_BEGIN
    begun = driver.drain_transition(slot, DRAIN_BEGIN)
    if begun is None:
        return result  # already draining or dead
    snapshot, states, epoch = begun
    driver.publish_membership(snapshot, states, epoch)
    driver.tracer.instant("member.drain", "member", slot=slot,
                          epoch=epoch, deadline_ms=deadline_ms)
    log.info("driver: draining executor slot %d (membership epoch %d, "
             "deadline %dms)", slot, epoch, deadline_ms)
    deadline = time.monotonic() + deadline_ms / 1000

    # 2) drainee replication (best-effort: existing merged coverage may
    # already suffice, and a dead drainee is exactly the fallback case)
    drainee = members[slot]
    drain_ok = False
    try:
        conn = driver.client_conn(drainee)
        remaining_ms = max(1, int((deadline - time.monotonic()) * 1000))
        resp = conn.request(
            M.DrainReq(conn.next_req_id(), slot, remaining_ms),
            timeout=deadline - time.monotonic() + 5.0)
        if isinstance(resp, M.DrainResp):
            result["drain_resp_status"] = resp.status
            result["maps_pushed"] = resp.maps_pushed
            result["bytes_handed_off"] = resp.bytes_pushed
            drain_ok = resp.status == M.STATUS_OK
            if not drain_ok:
                log.warning("driver: drainee slot %d answered status %d "
                            "(partial replication); the coverage check "
                            "decides", slot, resp.status)
    except (TransportError, TimeoutError, OSError) as e:
        result["drain_req_error"] = f"{type(e).__name__}: {e}"[:120]
        log.warning("driver: drain request to slot %d failed (%s); "
                    "relying on existing replica coverage", slot, e)

    # 3) re-finalize completed shuffles so drain pushes publish; 4) wait
    # for the retire-safety invariant
    sids = driver.live_shuffles()
    for sid in sids:
        driver.refinalize_merge(sid)
    unservable: Dict[int, List[int]] = {}
    while True:
        unservable = {sid: maps for sid in driver.live_shuffles()
                      if (maps := driver.unservable_without(sid, slot))}
        if not unservable or time.monotonic() > deadline:
            break
        time.sleep(0.02)

    repointed = sum(len(driver.maps_owned_by(sid, slot))
                    for sid in driver.live_shuffles())
    from sparkrdma_tpu_torch.shuffle.ha import DRAIN_RETIRE
    retired = driver.drain_transition(slot, DRAIN_RETIRE)
    if retired is not None:
        driver.publish_membership(*retired)
        driver.on_slot_dead(slot)
    if unservable:
        # deadline expired (drainee died mid-drain, pushes shed, targets
        # over their segment caps, ...): ordinary tombstone recovery owns
        # the rest — re-execution on demand, byte-identical
        result["status"] = "fallback"
        result["unservable"] = sorted(
            (sid, m) for sid, maps in unservable.items() for m in maps)
        driver.drain_fallbacks += 1
        driver.tracer.instant("member.drain_fallback", "member",
                              slot=slot, drain_ok=int(drain_ok),
                              unservable=len(result["unservable"]))
        log.warning("driver: drain of slot %d fell back to tombstone "
                    "recovery (%d map(s) not yet covered)", slot,
                    len(result["unservable"]))
    else:
        result["status"] = "drained"
        result["repointed"] = repointed
        driver.drains_completed += 1
        driver.tracer.instant("member.retire", "member", slot=slot,
                              repointed=repointed)
        log.info("driver: slot %d retired cleanly (%d owned map(s) now "
                 "served from merged replicas; zero re-executions)",
                 slot, repointed)
    return result


# -- the autoscaler loop ---------------------------------------------------

class Autoscaler:
    """Watches load gauges and resizes the fleet within
    ``[min_executors, max_executors]``.

    Signals (``gauges()``): per-tenant admission backlog (queued
    ``registerShuffle`` waiters at the driver), a ``queue_depth`` gauge
    (pending work units — the embedding harness supplies it via
    ``load_fn``, e.g. undispatched tasks), and ``reduce_balance``
    (max/mean reduce-task bytes — sustained skew means more slots to
    split hot partitions across). Policy, deterministic for tests:

    * scale UP when admission backlog is non-zero, queue depth exceeds
      2x the live count, or reduce_balance exceeds 2.0 — target
      ``live + max(1, backlog)``, clamped to ``max_executors``;
    * scale DOWN one slot after two consecutive idle ticks (no backlog,
      queue depth under half the live count), clamped to
      ``min_executors`` — the HIGHEST live slot drains first (LIFO:
      joiners leave before the founding fleet, which keeps shard hosts
      and long-lived merge targets stable).

    ``scale_up(n)`` is the harness's spawn hook (the driver cannot fork
    executors); ``scale_down(slot)`` defaults to
    :func:`drain_slot` via ``driver.decommission_slot``. ``start()``
    runs ``tick()`` every ``autoscale_interval_ms``; tests call
    ``tick()`` directly with an injected ``load_fn``.
    """

    def __init__(self, driver, conf=None,
                 scale_up: Optional[Callable[[int], None]] = None,
                 scale_down: Optional[Callable[[int], None]] = None,
                 load_fn: Optional[Callable[[], Dict[str, float]]] = None):
        self.driver = driver
        self.conf = conf or driver.conf
        self.scale_up = scale_up
        self.scale_down = (scale_down if scale_down is not None
                           else lambda slot: driver.decommission_slot(slot))
        self.load_fn = load_fn
        self.resizes = 0  # audit: actions taken
        self._idle_ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def gauges(self) -> Dict[str, float]:
        snap = self.driver.admission.snapshot()
        g: Dict[str, float] = {
            "admission_backlog": float(sum(snap["queued"].values())),
            "inflight_shuffles": float(sum(snap["inflight"].values())
                                       or len(self.driver.live_shuffles())),
            "queue_depth": 0.0,
            "reduce_balance": 1.0,
        }
        if self.load_fn is not None:
            try:
                g.update(self.load_fn() or {})
            except Exception:  # noqa: BLE001 — a broken gauge must not
                # kill the loop; the defaults above are the safe answer
                log.exception("autoscaler load_fn failed")
        return g

    def desired_size(self, live: int, g: Dict[str, float]) -> int:
        lo = max(1, int(self.conf.min_executors))
        # 0 = unbounded (the config contract): the ceiling must NOT
        # collapse to the current live count, or scale-up could never
        # fire on a default config no matter the backlog
        hi = int(self.conf.max_executors) or (1 << 20)
        hi = max(hi, lo)
        backlog = int(g.get("admission_backlog", 0))
        depth = float(g.get("queue_depth", 0.0))
        balance = float(g.get("reduce_balance", 1.0))
        if backlog > 0 or depth > 2.0 * live or balance > 2.0:
            self._idle_ticks = 0
            return min(hi, live + max(1, backlog))
        if backlog == 0 and depth < max(1.0, 0.5 * live):
            self._idle_ticks += 1
            if self._idle_ticks >= 2:
                return max(lo, live - 1)
            return max(lo, min(hi, live))
        self._idle_ticks = 0
        return max(lo, min(hi, live))

    def tick(self) -> Optional[Tuple[str, int]]:
        """One evaluation: returns ``("up", n)`` / ``("down", slot)`` /
        None (no resize)."""
        live_slots = self.driver.membership.live_slots()
        live = len(live_slots)
        if live == 0:
            return None
        target = self.desired_size(live, self.gauges())
        if target > live and self.scale_up is not None:
            n = target - live
            self.resizes += 1
            self._idle_ticks = 0
            self.driver.tracer.instant("autoscale.resize", "member",
                                       direction="up", count=n, live=live)
            log.info("autoscaler: scaling UP by %d (live %d)", n, live)
            self.scale_up(n)
            return ("up", n)
        if target < live:
            slot = max(live_slots)
            self.resizes += 1
            self._idle_ticks = 0
            self.driver.tracer.instant("autoscale.resize", "member",
                                       direction="down", count=1,
                                       live=live)
            log.info("autoscaler: draining slot %d (live %d)", slot, live)
            self.scale_down(slot)
            return ("down", slot)
        return None

    def start(self) -> None:
        if self._thread is not None:
            return
        interval = self.conf.autoscale_interval_ms / 1000
        if interval <= 0:
            return

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the loop must live
                    log.exception("autoscaler tick failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
