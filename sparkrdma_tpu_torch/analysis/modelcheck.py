"""Pass 5 — distributed-invariant model checker.

The one-sided design's correctness lives in protocol invariants, not
request/reply pairing (PAPER §0-1; "RPC Considered Harmful",
PAPERS.md): epoch-stamped location/plan/membership state and fence-CAS
commits must stay consistent under ANY message-delivery order. This
pass runs the small cluster scenarios those invariants protect —
publish vs tombstone vs epoch-bump, fence loser-commits-late,
finalize-beats-first-push, drain vs concurrent kill, TTL-sweep vs late
fetch — over the REAL protocol classes (``LocationPlane``,
``DriverTable``, ``MembershipPlane``, ``MergedDirectory``,
``TenantLedger``), under systematically enumerated schedules
(``analysis/scheduler.py``: bounded DFS with partial-order reduction,
plus seeded random walks), asserting the machine-checked safety
invariants after every fired step:

* **epoch-monotone** — per observer, the observed location / plan /
  membership epochs never regress, and a DEAD shuffle stays dead: no
  cached view (table, locations, merged directory, plan) may serve
  at-or-after the observer processed its ``EPOCH_DEAD``.
* **fence-winner** — the driver-table commit CAS admits one winner per
  (map, executor): once fence f applied, no publish with fence < f
  from the same executor may apply (zombie speculative attempts).
* **no-dead-location** — no observer-cached table stamped at-or-after
  a slot's tombstone epoch names the DEAD slot.
* **merged-live** — the driver's merged directory holds at most one
  entry per (partition, slot) and never an entry naming a tombstoned
  slot (zombie finalize publishes).
* **member-legal** — driver membership transitions follow
  LIVE→DRAINING, DRAINING→LIVE, {LIVE,DRAINING}→DEAD only; DEAD is
  terminal; the membership epoch strictly increases with every vector
  change.
* **ledger-conserve** — per tenant, TenantLedger usage equals charges
  minus releases of live state exactly (a double-release or a leaked
  charge breaks the equality) and is never negative.
* **lease-single-holder** — the driver lease CAS (shuffle/ha.py)
  admits exactly one holder per term, ever: two standbys racing the
  same takeover resolve to one promotion.
* **no-resurrect** — once an observer processed ``EPOCH_DEAD`` (and
  nothing re-registered the id), no later step — including a promoted
  standby's re-broadcast — may hand it a positive epoch again: a new
  primary must re-derive the TTL sweep from replicated register times
  instead of trusting the unregister op to have been replicated.

The driver-death scenarios (``driver_failover_mid_publish``,
``split_brain_two_leases``, ``zombie_primary_publish``,
``failover_vs_ttl_sweep``) additionally check epoch monotonicity
ACROSS driver incarnations (``ha.compose_epoch`` puts the incarnation
in the high bits, so every existing keep-highest comparison fences a
zombie old primary's writes), fence idempotency of publishes re-sent
to the new primary, op-stream fencing by ``(incarnation, seq)``, and
ledger conservation through log replay.

Driver-side glue that lives inside ``parallel/endpoints.py`` (tombstone
→ directory prune + epoch bump; merged-publish admission) is mirrored
here as small ``World`` methods with the mirrored call sites named, so
the checked semantics track the production ones; everything below that
glue is the production class itself.
"""

from __future__ import annotations

import inspect
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.analysis.core import Finding, rel, repo_root
from sparkrdma_tpu_torch.analysis.scheduler import (Run, VirtualScheduler,
                                              explore_dfs, random_walks,
                                              replay)
from sparkrdma_tpu_torch.shuffle import shard_plane
from sparkrdma_tpu_torch.shuffle.ha import (OP_BUMP, OP_REGISTER, OP_UNREGISTER,
                                      OP_WIRE, SHARD_OP_PUBLISH,
                                      InMemoryLeaseStore, OpLog, OpRecord,
                                      compose_epoch, incarnation_of,
                                      pack_shard_publish, rebase_epoch)
from sparkrdma_tpu_torch.shuffle.location_plane import EPOCH_DEAD, LocationPlane
from sparkrdma_tpu_torch.shuffle.map_output import DriverTable
from sparkrdma_tpu_torch.shuffle.push_merge import MergedDirectory, MergedEntry
from sparkrdma_tpu_torch.shuffle.tenancy import TenantLedger
from sparkrdma_tpu_torch.parallel.membership import (SLOT_DEAD, SLOT_DRAINING,
                                               SLOT_LIVE, MembershipPlane)
from sparkrdma_tpu_torch.utils.ids import ExecutorId, ShuffleManagerId

PASS = "modelcheck"

_LEGAL_MEMBER_STEPS = {
    (SLOT_LIVE, SLOT_DRAINING),
    (SLOT_DRAINING, SLOT_LIVE),
    (SLOT_LIVE, SLOT_DEAD),
    (SLOT_DRAINING, SLOT_DEAD),
}


def _mid(i: int) -> ShuffleManagerId:
    return ShuffleManagerId(ExecutorId(str(i), f"mc{i}", 7000 + i),
                            f"mc{i}", 9000 + i, i)


class World:
    """One scenario's cluster state: real protocol components plus the
    bookkeeping the invariants compare against."""

    def __init__(self, num_observers: int = 2, num_maps: int = 2,
                 sid: int = 7):
        self.sid = sid
        self.num_maps = num_maps
        self.table = DriverTable(num_maps)
        self.epochs: Dict[int, int] = {sid: 1}
        self.merged = MergedDirectory()
        self.tombstone_sentinel = object()
        self.membership = MembershipPlane(
            tombstone=self.tombstone_sentinel)
        self.observers = [LocationPlane() for _ in range(num_observers)]
        self.ledger = TenantLedger("modelcheck", quota=0)
        # -- invariant bookkeeping
        self.applied_fences: Dict[Tuple[int, int], int] = {}
        self.tombstoned: Dict[int, int] = {}   # slot -> location epoch
        self.dead_shuffles: Dict[int, int] = {}
        self.obs_dead: List[set] = [set() for _ in range(num_observers)]
        self.obs_epochs: List[Dict[int, int]] = [
            {} for _ in range(num_observers)]
        self.obs_member_epoch: List[int] = [-1] * num_observers
        self.expected_usage: Dict[int, int] = {}
        self.member_history: List[Tuple[List[int], int]] = [
            (self.membership.states(), self.membership.epoch())]
        self.problem: Optional[str] = None
        # -- driver HA mirrors (shuffle/ha.py; the oplog glue lives in
        # endpoints._log_op / DriverStandby): the REAL lease store and
        # OpLog stamping, with per-standby replication bookkeeping
        self.lease = InMemoryLeaseStore()
        self.lease_holders: Dict[int, set] = {}
        self.incarnation = 0
        self.oplogs: Dict[int, OpLog] = {}
        self.ops: List[Tuple[OpRecord, Tuple]] = []
        self.replicated: Dict[str, List[Tuple[OpRecord, Tuple]]] = {}
        self.repl_last: Dict[str, Tuple[int, int]] = {}
        self.promote_term: Dict[str, int] = {}
        self.ttl_expired = False
        # -- partitioned metadata ownership mirrors (shuffle/shard_plane
        # + the endpoints._owner_publish / _on_shard_handoff glue): REAL
        # ShardOwnerStore per named host; the standby stream keyed by
        # (owner, shard) carries the real packed op payloads
        self.shard_owners: Dict[str, shard_plane.ShardOwnerStore] = {}
        self.shard_streams: Dict[Tuple[str, int],
                                 List[Tuple[int, bytes]]] = {}
        # highest fence ACKed at an owner per (map, exec) — every ACKed
        # write must stay visible in the driver table (the shard-converge
        # invariant); plus sealed-segment completeness obligations
        self.shard_acked: Dict[Tuple[int, int], int] = {}
        self.handoff_obligations: List[Tuple[str, int, Dict[int, bytes]]] \
            = []

    # -- driver glue mirrors ---------------------------------------------

    def publish(self, map_id: int, token: int, exec_index: int,
                fence: int, table: Optional[DriverTable] = None) -> None:
        """Fenced driver-table publish (endpoints._on_publish →
        DriverTable.publish). Records the CAS outcome the fence-winner
        invariant checks. ``table`` lets a re-sent publish land on a
        promoted standby's restored table — the fence bookkeeping is
        logical (per map, executor), shared across incarnations, so an
        idempotent re-send (equal fence) stays legal and a regression
        does not."""
        tbl = self.table if table is None else table
        applied = tbl.publish(map_id, token, exec_index, fence)
        key = (map_id, exec_index)
        prev = self.applied_fences.get(key)
        if applied:
            if prev is not None and fence < prev:
                self.problem = (
                    f"fence-winner: map {map_id} exec {exec_index} "
                    f"applied fence {fence} after fence {prev}")
            self.applied_fences[key] = max(prev or 0, fence)

    def kill_slot(self, slot: int) -> None:
        """Failure tombstone: membership DEAD + merged-directory prune +
        location epoch bump (endpoints.remove_member/on_slot_dead)."""
        members = self.membership.members()
        if slot < len(members):
            self.membership.tombstone(members[slot])
        self.record_member_change()
        self.merged.drop_slot(slot)
        self.epochs[self.sid] = self.epochs.get(self.sid, 1) + 1
        self.tombstoned[slot] = self.epochs[self.sid]

    def apply_merged_publish(self, entry: MergedEntry) -> None:
        """Merged-publish admission (endpoints._on_merged_publish):
        publishes from a DEAD slot are dropped — a zombie finalize
        landing after the tombstone prune must not resurrect the
        entry."""
        if entry.slot in self.tombstoned or \
                self.membership.state_of(entry.slot) == SLOT_DEAD:
            return
        self.merged.apply(entry)

    def unregister(self) -> None:
        """TTL sweep / explicit unregister: the shuffle dies under a
        terminal EPOCH_DEAD (endpoints._gc_sweep → bump_epoch DEAD)."""
        self.dead_shuffles[self.sid] = self.epochs.get(self.sid, 1)

    def record_member_change(self) -> None:
        self.member_history.append(
            (self.membership.states(), self.membership.epoch()))

    # -- ledger bookkeeping (the conservation invariant's ground truth) --

    def charge(self, tenant: int, nbytes: int) -> None:
        self.ledger.charge(tenant, nbytes)
        self.expected_usage[tenant] = \
            self.expected_usage.get(tenant, 0) + nbytes

    def release(self, tenant: int, nbytes: int) -> None:
        self.ledger.release(tenant, nbytes)
        self.expected_usage[tenant] = \
            self.expected_usage.get(tenant, 0) - nbytes

    # -- observer deliveries ---------------------------------------------

    def deliver_dead(self, obs: int) -> None:
        self.observers[obs].note_epoch(self.sid, EPOCH_DEAD)
        self.obs_dead[obs].add(self.sid)

    # -- driver HA mirrors (shuffle/ha.py + endpoints oplog glue) --------

    def lease_acquire(self, holder: str, term: int, now: float,
                      ttl_s: float = 10.0) -> bool:
        """Standby takeover CAS (DriverStandby._watch_lease →
        LeaseStore.try_acquire). Every successful acquire is recorded so
        the lease-single-holder invariant can see a double grant."""
        ok = self.lease.try_acquire(holder, term, ttl_s, now=now)
        if ok:
            self.lease_holders.setdefault(term, set()).add(holder)
        return ok

    def lease_renew(self, holder: str, term: int, now: float,
                    ttl_s: float = 10.0) -> bool:
        """Primary heartbeat renew (endpoints._lease_loop). A renew that
        succeeds after a HIGHER term was granted means the store let a
        zombie extend a fenced lease — the failure `renew` exists to
        surface."""
        ok = self.lease.renew(holder, term, ttl_s, now=now)
        if ok and any(t > term for t in self.lease_holders):
            self.problem = (
                f"lease-single-holder: {holder} renewed term {term} "
                f"after term {max(self.lease_holders)} was granted")
        return ok

    def primary_log(self, sem: Tuple, incarnation: int = 0
                    ) -> Tuple[OpRecord, Tuple]:
        """Primary-side op append (endpoints._log_op): the writer's
        OpLog stamps (incarnation, seq); ``sem`` is the semantic payload
        the replay interprets."""
        kinds = {"publish": OP_WIRE, "charge": OP_WIRE,
                 "release": OP_WIRE, "bump": OP_BUMP,
                 "register": OP_REGISTER, "unregister": OP_UNREGISTER}
        oplog = self.oplogs.setdefault(
            incarnation, OpLog(incarnation=incarnation))
        rec = oplog.append(kinds[sem[0]], b"")
        self.ops.append((rec, sem))
        return rec, sem

    def standby_deliver(self, name: str, rec: OpRecord,
                        sem: Tuple) -> None:
        """Standby stream ingest (DriverStandby._handle OpLogAppendMsg):
        accept only strictly forward (incarnation, seq) — the fence that
        keeps a zombie primary's appends out of the replicated log."""
        last = self.repl_last.get(name, (0, 0))
        if (rec.incarnation, rec.seq) <= last:
            return
        term = self.promote_term.get(name)
        if term is not None and rec.incarnation < term:
            # unreachable while the guard above holds (promotion set
            # repl_last to (term, 0)); a tripwire, not a code path
            self.problem = (
                f"ha-fence: standby {name} (promoted at term {term}) "
                f"admitted an incarnation-{rec.incarnation} op")
            return
        self.replicated.setdefault(name, []).append((rec, sem))
        self.repl_last[name] = (rec.incarnation, rec.seq)

    def takeover(self, name: str, term: int, now: float) -> Dict:
        """Promotion replay (DriverStandby.promote → DriverEndpoint
        restore): rebuild the tables from the replicated prefix with
        REAL classes, re-apply the wire-shaped ops a second time to
        prove replay idempotency, conserve the ledger through the
        replay, re-derive the TTL sweep from replicated register times,
        and rebase the epoch under the won term's incarnation."""
        del now
        self.promote_term[name] = term
        self.incarnation = term
        self.repl_last[name] = max(self.repl_last.get(name, (0, 0)),
                                   (term, 0))
        table = DriverTable(self.num_maps)
        ledger = TenantLedger("modelcheck-replay", quota=0)
        expected: Dict[int, int] = {}
        fences: Dict[Tuple[int, int], int] = {}
        live, bumps = True, 0
        prefix = list(self.replicated.get(name, []))
        for _rec, sem in prefix:
            kind = sem[0]
            if kind == "publish":
                _k, map_id, token, exec_index, fence = sem
                if table.publish(map_id, token, exec_index, fence):
                    prev = fences.get((map_id, exec_index))
                    if prev is not None and fence < prev:
                        self.problem = (
                            f"fence-winner: replay at {name} applied "
                            f"fence {fence} after {prev}")
                    fences[(map_id, exec_index)] = max(prev or 0, fence)
            elif kind == "charge":
                ledger.charge(sem[1], sem[2])
                expected[sem[1]] = expected.get(sem[1], 0) + sem[2]
            elif kind == "release":
                ledger.release(sem[1], sem[2])
                expected[sem[1]] = expected.get(sem[1], 0) - sem[2]
            elif kind == "bump":
                bumps += 1
            elif kind == "unregister":
                live = False
        # replay idempotency: applying every wire-shaped op a second
        # time against the restored table must be a no-op (fence floors
        # re-admit equal fences without changing state)
        snap = table.to_bytes()
        for _rec, sem in prefix:
            if sem[0] == "publish":
                table.publish(sem[1], sem[2], sem[3], sem[4])
        if table.to_bytes() != snap:
            self.problem = (f"ha-replay: second application of the "
                            f"replicated prefix changed {name}'s table")
        # ledger conservation through replay
        for tenant, exp in expected.items():
            if exp < 0 or ledger.usage(tenant) != exp:
                self.problem = (
                    f"ledger-conserve: replay at {name} rebuilt tenant "
                    f"{tenant} usage {ledger.usage(tenant)} != live "
                    f"charges {exp}")
        # re-derived TTL sweep: the register time rode the log, so an
        # expired shuffle dies here whether or not the primary's
        # unregister op was ever replicated
        if live and self.ttl_expired:
            live = False
        if not live:
            self.dead_shuffles.setdefault(
                self.sid, self.epochs.get(self.sid, 1))
        return {"table": table, "live": live,
                "epoch": rebase_epoch(1 + bumps, term)}

    # -- partitioned ownership mirrors (shuffle/shard_plane.py + the
    # endpoints._owner_publish / _on_shard_handoff glue) ----------------

    def shard_owner(self, name: str) -> shard_plane.ShardOwnerStore:
        return self.shard_owners.setdefault(
            name, shard_plane.ShardOwnerStore())

    def shard_publish(self, name: str, shard: int, map_id: int,
                      token: int, exec_index: int, fence: int,
                      gen: int) -> int:
        """One direct-to-owner publish (endpoints._owner_publish): the
        owner runs the real fence CAS; APPLIED writes stream to the
        standby and converge into the driver table (the ShardBatchMsg
        echo, replayed through the same fenced ``publish``); anything
        else bounces to the driver-direct path — one extra hop, never a
        lost write."""
        import struct as _struct
        entry = _struct.pack("<qi", token, exec_index)
        store = self.shard_owner(name)
        status, _rec = store.publish(self.sid, shard, map_id, entry,
                                     fence, gen)
        if status == shard_plane.APPLIED:
            key = (map_id, exec_index)
            self.shard_acked[key] = max(self.shard_acked.get(key, 0),
                                        fence)
            self.shard_streams.setdefault((name, shard), []).append(
                (SHARD_OP_PUBLISH,
                 pack_shard_publish(map_id, fence, entry)))
            self.publish(map_id, token, exec_index, fence)
        elif status != shard_plane.FENCED:
            # SEALED / STALE_GEN / NOT_OWNER: forward the original to
            # the driver (endpoints._on_shard_publish fallback)
            self.publish(map_id, token, exec_index, fence)
        return status

    def shard_seal(self, name: str, shard: int) -> None:
        """Outgoing-owner half of a handoff (ShardHandoffMsg at the old
        owner): seal, and record the completeness OBLIGATION — whoever
        ends up owning the shard must hold every sealed entry."""
        store = self.shard_owner(name)
        sealed = store.entries_of(self.sid, shard)
        store.seal(self.sid, shard)
        self.handoff_obligations.append((name, shard, sealed))

    def shard_adopt(self, name: str, shard: int, lo: int, hi: int,
                    gen: int, replay_from: Optional[str] = None) -> bool:
        """Incoming-owner half (endpoints._on_shard_assignment +
        _on_shard_handoff): adopt forward-only at ``gen``, replaying the
        standby stream buffered from ``replay_from``'s op stream."""
        replay = list(self.shard_streams.get((replay_from, shard), [])) \
            if replay_from is not None else None
        return self.shard_owner(name).adopt(
            self.sid, shard, lo, hi, self.num_maps, gen, replay=replay)


class MergeTargetModel:
    """One merge target's ledger discipline — the in-memory mirror of
    ``push_merge.MergeStore`` push/finalize/drop semantics (fence
    dedupe, finalized tombstone, dropped tombstone, charge-on-accept /
    release-on-drop) with a real :class:`TenantLedger` underneath."""

    def __init__(self, world: World, tenant: int = 0):
        self.world = world
        self.tenant = tenant
        self.rows: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.finalized = False
        self.dropped = False

    def push(self, partition: int, map_id: int, fence: int,
             nbytes: int, reopen: bool = False) -> bool:
        if self.dropped:
            # MergeStore keeps a dropped-shuffle tombstone so a push
            # racing the unregister broadcast cannot re-charge disk
            # nothing will ever release (push_merge.MergeStore.push)
            return False
        if self.finalized and not reopen:
            return False
        newest = self.rows.get((partition, map_id))
        if newest is not None and fence <= newest[0]:
            return False  # duplicate or stale attempt's push
        self.world.charge(self.tenant, nbytes)
        self.rows[(partition, map_id)] = (fence, nbytes)
        return True

    def finalize(self) -> None:
        self.finalized = True

    def drop(self) -> None:
        if self.dropped:
            return
        self.dropped = True
        for _fence, nbytes in self.rows.values():
            self.world.release(self.tenant, nbytes)
        self.rows.clear()


class PushedStoreModel:
    """One planned-push target's staging discipline — the in-memory
    mirror of ``pushed_store.PushedInputStore`` semantics (plan-epoch
    fence acceptance, per-(partition, map) attempt-fence dedupe,
    charge-on-accept / release-on-supersede / release-on-drop, dropped
    tombstone) with a real :class:`TenantLedger` underneath.

    The two safety properties the ``push_vs_*`` scenarios enumerate
    schedules against:

    * a push stamped with a plan epoch OLDER than one the store has
      adopted is rejected (and once a newer epoch is adopted, every
      staged range of an older epoch is superseded — released and
      unavailable), so a reducer can NEVER consume a stale-plan range;
    * a push racing the drop broadcast must not leak a ledger charge
      nothing will ever release (checked by ledger-conserve).
    """

    def __init__(self, world: World, tenant: int = 0):
        self.world = world
        self.tenant = tenant
        self.plan_epoch = 0
        # (partition, map) -> (fence, plan_epoch, nbytes)
        self.rows: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        self.dropped = False

    def push(self, partition: int, map_id: int, fence: int,
             plan_epoch: int, nbytes: int) -> bool:
        if self.dropped:
            # dropped tombstone: a push racing the unregister broadcast
            # must not re-charge staging nothing will ever release
            return False
        if plan_epoch < self.plan_epoch:
            return False  # stale-plan push: the re-plan superseded it
        if plan_epoch > self.plan_epoch:
            self.on_plan(plan_epoch)  # pushes may beat the broadcast
        prev = self.rows.get((partition, map_id))
        if prev is not None:
            if fence <= prev[0]:
                return False  # duplicate or stale attempt's push
            self.world.release(self.tenant, prev[2])
        self.world.charge(self.tenant, nbytes)
        self.rows[(partition, map_id)] = (fence, plan_epoch, nbytes)
        return True

    def on_plan(self, plan_epoch: int) -> None:
        """A (re-)plan landed: adopt the newer epoch and supersede every
        staged range of an older one — released exactly once."""
        if self.dropped or plan_epoch <= self.plan_epoch:
            return
        self.plan_epoch = plan_epoch
        stale = [k for k, v in self.rows.items() if v[1] < plan_epoch]
        for k in stale:
            self.world.release(self.tenant, self.rows.pop(k)[2])

    def consume(self, partition: int) -> Dict[int, int]:
        """The reducer's pushed-first read: every served range must be
        stamped with the store's CURRENT plan epoch — anything else is
        the stale-push consumption the plan fence exists to prevent."""
        if self.dropped:
            return {}
        out = {}
        for (p, m), (_fence, epoch, nbytes) in self.rows.items():
            if p != partition:
                continue
            if epoch != self.plan_epoch:
                self.world.problem = (
                    f"pushed-fence: consumed partition {p} map {m} "
                    f"range at plan epoch {epoch} != store epoch "
                    f"{self.plan_epoch} (stale-plan push served)")
            out[m] = nbytes
        return out

    def drop(self) -> None:
        if self.dropped:
            return
        self.dropped = True
        for _fence, _epoch, nbytes in self.rows.values():
            self.world.release(self.tenant, nbytes)
        self.rows.clear()


class ColdTierModel:
    """One tiering executor + the driver's TieredDirectory admission —
    the in-memory mirror of ``cold_tier.TieringService`` (tombstone
    refusal, charge-on-upload, reap-and-repay on drop) composed with
    the ``endpoints`` glue: ``_on_tiered_publish``'s supersession drop,
    the repair-publish prune (``TieredDirectory.drop_map`` + the
    ``_tiered_superseded`` tombstone), and the unregister reap — with a
    real :class:`TenantLedger` underneath via the world bookkeeping.

    The two safety properties the ``tier_vs_*`` scenarios enumerate
    schedules against:

    * a blob whose upload raced a repair publish carries the REPLACED
      attempt's bytes and must never become resolvable — whether its
      publish beats the prune (``drop_map`` eats the entry) or loses
      to it (the supersession tombstone drops the late publish);
    * an upload racing the shuffle's death must not leak a disk-ledger
      charge nothing will repay (tombstone refusal before the PUT,
      reap-and-repay after it), and nothing may serve from a dead
      shuffle's directory.
    """

    def __init__(self, world: World, tenant: int = 0):
        self.world = world
        self.tenant = tenant
        self.blobs: Dict[str, int] = {}         # key -> charged bytes
        # key -> (partition, covered maps, nbytes): the directory
        self.directory: Dict[str, Tuple[int, frozenset, int]] = {}
        self.superseded: set = set()            # repair-pruned map ids
        self.dropped = False                    # shuffle-dead tombstone

    def put(self, key: str, nbytes: int) -> bool:
        """TieringService upload (PUT + tenant disk charge). A drop
        that already landed refuses the upload outright — no blob, no
        charge (cold_tier.TieringService._worker tombstone check)."""
        if self.dropped:
            return False
        self.world.charge(self.tenant, nbytes)
        self.blobs[key] = nbytes
        return True

    def publish(self, key: str, partition: int, covered) -> None:
        """The one-sided TieredPublishMsg landing at the driver
        (endpoints._on_tiered_publish), posted AFTER its put on the
        tiering executor's own FIFO channel."""
        nbytes = self.blobs.get(key)
        if nbytes is None:
            return  # the upload was refused or already reaped
        if self.dropped:
            # unknown shuffle at the driver: the service reaps its own
            # blob and repays the charge (upload-races-unregister)
            self.world.release(self.tenant, self.blobs.pop(key))
            return
        if any(m in self.superseded for m in covered):
            # the blob holds a repair-superseded attempt's bytes — the
            # supersession tombstone closes the mid-upload window
            return
        self.directory[key] = (partition, frozenset(covered), nbytes)

    def repair(self, map_id: int) -> None:
        """Repair-publish prune at the driver: drop every directory
        entry covering the replaced map, then tombstone the map id so
        a still-in-flight publish of its old bytes cannot land."""
        for key in [k for k, v in self.directory.items()
                    if map_id in v[1]]:
            del self.directory[key]  # blob orphaned; reaped at drop
        self.superseded.add(map_id)

    def resolve(self, partition: int) -> set:
        """The reducer's LAST resolve rung: whatever the directory
        serves for ``partition`` must never name a superseded map or a
        dead shuffle — that is the stale-blob consumption the prune and
        tombstone exist to prevent."""
        served = set()
        for key, (p, covered, _nbytes) in self.directory.items():
            if p != partition:
                continue
            if self.dropped:
                self.world.problem = (
                    "tiered-stale: dead shuffle's directory served "
                    f"blob {key}")
            for m in covered:
                if m in self.superseded:
                    self.world.problem = (
                        f"tiered-stale: partition {p} resolved "
                        f"superseded map {m} from blob {key}")
                served.add(m)
        return served

    def drop(self) -> None:
        """Unregister / TTL / EPOCH_DEAD: tombstone the shuffle, reap
        its blobs, repay the tenant charges exactly once."""
        if self.dropped:
            return
        self.dropped = True
        for nbytes in self.blobs.values():
            self.world.release(self.tenant, nbytes)
        self.blobs.clear()
        self.directory.clear()



# ------------------------------------------------------------- invariants

def check_invariants(world: World,
                     sched: VirtualScheduler) -> Optional[str]:
    """All safety invariants over one world, called after every fired
    step. Returns the first violation's description or None."""
    del sched
    if world.problem is not None:
        return world.problem

    # epoch-monotone: observed location epochs never regress; membership
    # epoch never regresses
    for i, plane in enumerate(world.observers):
        for sid in list(world.obs_epochs[i]) + [world.sid]:
            e = plane.known_epoch(sid)
            prev = world.obs_epochs[i].get(sid)
            if e is not None:
                if prev is not None and e < prev:
                    return (f"epoch-monotone: observer {i} regressed "
                            f"shuffle {sid} epoch {prev} -> {e}")
                world.obs_epochs[i][sid] = max(prev or 0, e)
        me, _states = plane.membership()
        if me < world.obs_member_epoch[i]:
            return (f"epoch-monotone: observer {i} membership epoch "
                    f"{world.obs_member_epoch[i]} -> {me}")
        world.obs_member_epoch[i] = me

    # dead shuffle stays dead: once the observer processed EPOCH_DEAD,
    # no cached view may serve again
    for i, plane in enumerate(world.observers):
        for sid in world.obs_dead[i]:
            if plane.table(sid) is not None:
                return (f"epoch-monotone: observer {i} serves a cached "
                        f"table for DEAD shuffle {sid}")
            if plane.merged(sid) is not None:
                return (f"epoch-monotone: observer {i} serves a merged "
                        f"directory for DEAD shuffle {sid}")
            if plane.plan(sid) is not None:
                return (f"epoch-monotone: observer {i} serves a plan "
                        f"for DEAD shuffle {sid}")
            if plane.locations(sid, 0, 0, world.num_maps) is not None:
                return (f"epoch-monotone: observer {i} serves cached "
                        f"locations for DEAD shuffle {sid}")

    # no-dead-location: a cached table stamped at-or-after a slot's
    # tombstone epoch must not name the dead slot
    for slot, tomb_epoch in world.tombstoned.items():
        for i, plane in enumerate(world.observers):
            cached = plane.table(world.sid)
            if cached is None:
                continue
            table, epoch = cached
            if epoch < tomb_epoch:
                continue  # legitimately stale view, epoch says so
            for m in range(table.num_maps):
                e = table.entry(m)
                if e is not None and e[1] == slot:
                    return (f"no-dead-location: observer {i} resolves "
                            f"map {m} to DEAD slot {slot} at epoch "
                            f"{epoch} >= tombstone epoch {tomb_epoch}")

    # merged-live: one entry per (partition, slot) is structural in
    # MergedDirectory; what can break is a DEAD slot re-entering
    for partition in world.merged.partitions():
        for entry in world.merged.entries(partition):
            if entry.slot in world.tombstoned:
                return (f"merged-live: directory names DEAD slot "
                        f"{entry.slot} for partition {partition}")

    # member-legal: driver-side transitions + strictly increasing epoch.
    # Every recorded commit pair is re-validated (the history is tiny);
    # a mutation that skipped record_member_change is appended here so
    # it can't hide.
    states, epoch = (world.membership.states(),
                     world.membership.epoch())
    hist = world.member_history
    if (states, epoch) != hist[-1]:
        hist.append((states, epoch))
    for (s0, e0), (s1, e1) in zip(hist, hist[1:]):
        if s1 == s0 and e1 == e0:
            continue
        if e1 <= e0:
            return (f"member-legal: vector changed without an epoch "
                    f"bump ({e0} -> {e1})")
        for slot, (a, b) in enumerate(zip(s0, s1)):
            if a != b and (a, b) not in _LEGAL_MEMBER_STEPS:
                return (f"member-legal: slot {slot} illegal transition "
                        f"{a} -> {b}")
        for slot in range(len(s0), len(s1)):
            if s1[slot] != SLOT_LIVE:
                return (f"member-legal: slot {slot} joined in state "
                        f"{s1[slot]} (joiners must start LIVE)")

    # lease-single-holder: the CAS admits exactly one winner per term
    for term, holders in world.lease_holders.items():
        if len(holders) > 1:
            return (f"lease-single-holder: term {term} granted to "
                    f"{sorted(holders)}")

    # no-resurrect: once an observer processed EPOCH_DEAD (and nothing
    # re-registered the id in the model), no later step — including a
    # promoted standby's re-broadcast — may re-arm it with a positive
    # epoch
    for i, plane in enumerate(world.observers):
        for sid in world.obs_dead[i]:
            e = plane.known_epoch(sid)
            if e is not None and e > 0:
                return (f"no-resurrect: observer {i} re-armed DEAD "
                        f"shuffle {sid} at epoch {e}")

    # shard-converge: every write an owner ACKed (applied under its
    # generation) stays visible in the driver-authoritative fence
    # floors — a handoff may re-route or re-send a write, never lose it
    for (map_id, exec_index), fence in world.shard_acked.items():
        applied = world.applied_fences.get((map_id, exec_index))
        if applied is None or applied < fence:
            return (f"shard-converge: owner-ACKed publish map {map_id} "
                    f"exec {exec_index} fence {fence} never reached the "
                    f"driver table (floor {applied})")

    # shard-handoff-complete: sealing a shard must never LOSE a write —
    # every entry of the sealed segment stays published in the
    # driver-authoritative table (the batch echo converged it before or
    # at the seal; the successor's replay and the publisher republish
    # backstop only ever re-send, and fences make re-sends idempotent)
    for sealed_name, shard, sealed_entries in world.handoff_obligations:
        for map_id in sealed_entries:
            if world.table.entry(map_id) is None:
                return (f"shard-handoff-complete: sealed map {map_id} of "
                        f"shard {shard} (old owner {sealed_name}) was "
                        f"lost from the driver table")

    # shard-single-writer: at most one UNSEALED owner per (shard,
    # generation) — two hosts accepting writes for the same range under
    # the same generation would split the fence-CAS authority
    owners_by_gen: Dict[Tuple[int, int], List[str]] = {}
    for name, store in world.shard_owners.items():
        for sh in store.owned_shards(world.sid):
            if store.owns(world.sid, sh):
                g = store.gen_of(world.sid, sh) or 0
                owners_by_gen.setdefault((sh, g), []).append(name)
    for (sh, g), names in owners_by_gen.items():
        if len(names) > 1:
            return (f"shard-single-writer: shard {sh} generation {g} "
                    f"owned unsealed by {sorted(names)}")

    # ledger-conserve: usage == charges - releases of live state, >= 0
    for tenant, expected in world.expected_usage.items():
        usage = world.ledger.usage(tenant)
        if expected < 0:
            return (f"ledger-conserve: tenant {tenant} released more "
                    f"than it charged ({expected})")
        if usage != expected:
            return (f"ledger-conserve: tenant {tenant} ledger usage "
                    f"{usage} != live charges {expected} "
                    f"(double-release or leaked charge)")
    return None


# --------------------------------------------------------------- scenarios

@dataclass
class Scenario:
    name: str
    build: Callable[[VirtualScheduler], World]
    doc: str = ""


_CATALOG: List[Scenario] = []


def scenario(name: str, doc: str = ""):
    def deco(fn):
        _CATALOG.append(Scenario(name, fn, doc))
        return fn
    return deco


def catalog() -> List[Scenario]:
    return list(_CATALOG)


def _push_bump(sched: VirtualScheduler, world: World,
               epoch: int) -> None:
    """Queue the driver's epoch-bump push to every observer — each on
    its own push channel (FIFO with other pushes to that observer,
    concurrent with its response stream)."""
    for i in range(len(world.observers)):
        def deliver(s, i=i, epoch=epoch):
            del s
            world.observers[i].note_epoch(world.sid, epoch)
        sched.post(f"bump.e{epoch}->obs{i}", deliver,
                   chan=f"obs{i}.push", touches={f"obs{i}"})


@scenario("pub_tomb_bump",
          "publish vs tombstone vs epoch bump: stale table responses "
          "race the repair's bump push to two observers")
def _build_pub_tomb_bump(sched: VirtualScheduler) -> World:
    world = World(num_observers=2, num_maps=2)
    sid = world.sid
    # pre-history: both maps committed and published (slot0 owns map0)
    world.publish(0, token=101, exec_index=0, fence=1)
    world.publish(1, token=102, exec_index=1, fence=1)
    stale = DriverTable.from_bytes(world.table.to_bytes())

    # two stale epoch-1 table responses already in flight, one per
    # observer's request/response stream
    for i in range(2):
        def resp(s, i=i, stale=stale):
            del s
            world.observers[i].put_table(sid, stale, 1)
        sched.post(f"resp.e1->obs{i}", resp, chan=f"obs{i}.resp",
                   touches={f"obs{i}"})

    def tombstone(s):
        # slot0 dies: repair republishes map0 from slot1 (recovery's
        # re-execution), the directory prunes, the epoch bumps, and the
        # bump pushes + a fresh post-repair response go out
        world.kill_slot(0)
        world.publish(0, token=201, exec_index=1, fence=2)
        repaired = DriverTable.from_bytes(world.table.to_bytes())
        epoch = world.epochs[sid]
        _push_bump(s, world, epoch)
        for i in range(2):
            def resp2(s2, i=i, repaired=repaired, epoch=epoch):
                del s2
                world.observers[i].put_table(sid, repaired, epoch)
            s.post(f"resp.e{epoch}->obs{i}", resp2,
                   chan=f"obs{i}.resp", touches={f"obs{i}"})
    # touches covers the bump/response follow-ups it posts (the POR
    # contract): it must not be reduced against observer deliveries
    sched.post("driver.tombstone0", tombstone,
               touches={"driver", "obs0", "obs1"})
    return world


@scenario("fence_loser",
          "fence loser commits late: a zombie speculative attempt's "
          "publish races the winner's, plus a re-delivery")
def _build_fence_loser(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    # speculative attempts of map0 on exec0 (fences 1 and 2), a zombie
    # re-delivery, a cross-executor recovery publish, and map1's
    # publishes — each rides its own task thread, so delivery order is
    # unconstrained (all touch the one driver table: no reduction)
    sched.post("pub.m0.exec0.f2",
               lambda s: world.publish(0, 300, 0, fence=2),
               touches={"table"})
    sched.post("pub.m0.exec0.f1",
               lambda s: world.publish(0, 299, 0, fence=1),
               touches={"table"})
    sched.post("repub.m0.exec0.f1",
               lambda s: world.publish(0, 299, 0, fence=1),
               touches={"table"})
    sched.post("pub.m0.exec1.f1",
               lambda s: world.publish(0, 400, 1, fence=1),
               touches={"table"})
    sched.post("pub.m1.exec1.f1",
               lambda s: world.publish(1, 401, 1, fence=1),
               touches={"table"})
    sched.post("pub.m1.exec1.f2",
               lambda s: world.publish(1, 402, 1, fence=2),
               touches={"table"})
    return world


@scenario("finalize_vs_push",
          "finalize beats first push: pushes race the finalize and "
          "unregister broadcasts; the ledger must conserve")
def _build_finalize_vs_push(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    target = MergeTargetModel(world, tenant=3)
    # two pushers (their own connections), a duplicate re-push, and a
    # superseding re-execution push
    sched.post("push.m0.f1",
               lambda s: target.push(0, 0, fence=1, nbytes=100),
               chan="pusher0", touches={"target"})
    sched.post("repush.m0.f1",
               lambda s: target.push(0, 0, fence=1, nbytes=100),
               chan="pusher0", touches={"target"})
    sched.post("push.m1.f1.p0",
               lambda s: target.push(1, 1, fence=1, nbytes=60),
               chan="pusher0", touches={"target"})
    sched.post("push.m0.f2",
               lambda s: target.push(0, 0, fence=2, nbytes=120),
               chan="pusher1", touches={"target"})
    sched.post("push.m1.f1",
               lambda s: target.push(1, 1, fence=1, nbytes=80),
               chan="pusher1", touches={"target"})
    # finalize then unregister ride the same driver broadcast channel
    # (FIFO between themselves, concurrent with every pusher)
    sched.post("bcast.finalize", lambda s: target.finalize(),
               chan="drv.bcast", touches={"target"})
    sched.post("bcast.drop", lambda s: target.drop(),
               chan="drv.bcast", touches={"target"})
    return world


@scenario("drain_vs_kill",
          "graceful drain races a concurrent failure kill of the same "
          "slot; membership transitions must stay legal everywhere")
def _build_drain_vs_kill(sched: VirtualScheduler) -> World:
    world = World(num_observers=2, num_maps=2)
    for i in range(3):
        world.membership.join(_mid(i))
    world.record_member_change()

    def push_member(s) -> None:
        states, epoch = (world.membership.states(),
                         world.membership.epoch())
        for i in range(len(world.observers)):
            def deliver(s2, i=i, states=list(states), epoch=epoch):
                del s2
                world.observers[i].note_membership(epoch, states)
            s.post(f"mbump.e{epoch}->obs{i}", deliver,
                   chan=f"obs{i}.push", touches={f"obs{i}"})

    def begin_drain(s):
        if world.membership.begin_drain(1) is not None:
            world.record_member_change()
            push_member(s)
    # driver ops fan out membership bumps: touches covers the
    # observer follow-ups (the POR contract)
    _mtouch = {"member", "obs0", "obs1"}
    sched.post("drain.begin1", begin_drain, touches=_mtouch)

    def kill(s):
        world.kill_slot(1)
        push_member(s)
    sched.post("kill.slot1", kill, touches=_mtouch)

    def abort(s):
        if world.membership.abort_drain(1) is not None:
            world.record_member_change()
            push_member(s)
    sched.post("drain.abort1", abort, chan="drain", touches=_mtouch)

    def retire(s):
        if world.membership.retire(1) is not None:
            world.record_member_change()
            push_member(s)
    sched.post("drain.retire1", retire, chan="drain", touches=_mtouch)
    return world


@scenario("ttl_vs_late_fetch",
          "TTL sweep unregisters while table responses are in flight; "
          "nothing may resurrect a DEAD shuffle's cached views")
def _build_ttl_vs_late_fetch(sched: VirtualScheduler) -> World:
    world = World(num_observers=2, num_maps=2)
    sid = world.sid
    world.publish(0, 500, 0, fence=1)
    world.publish(1, 501, 1, fence=1)
    snap = DriverTable.from_bytes(world.table.to_bytes())
    world.merged.apply(MergedEntry(0, 1, 600, 64, 0, b"\x03", [(0, 64)]))
    merged_snap = MergedDirectory.from_bytes(world.merged.to_bytes())

    # two in-flight responses per observer: the table and the merged
    # directory, both stamped with the pre-death epoch
    for i in range(2):
        def resp_table(s, i=i):
            del s
            world.observers[i].put_table(sid, snap, 1)
        sched.post(f"resp.table->obs{i}", resp_table,
                   chan=f"obs{i}.resp", touches={f"obs{i}"})

        def resp_merged(s, i=i):
            del s
            world.observers[i].put_merged(sid, merged_snap, 1)
        sched.post(f"resp.merged->obs{i}", resp_merged,
                   chan=f"obs{i}.resp", touches={f"obs{i}"})

    def sweep(s):
        world.unregister()
        for i in range(len(world.observers)):
            s.post(f"dead->obs{i}",
                   lambda s2, i=i: world.deliver_dead(i),
                   chan=f"obs{i}.push", touches={f"obs{i}"})
    # touches covers the EPOCH_DEAD pushes it fans out (POR contract)
    sched.post("ttl.sweep", sweep, touches={"driver", "obs0", "obs1"})
    return world


@scenario("push_vs_replan",
          "planned pushes race a mid-stage re-plan: a stale-plan-epoch "
          "push must never be consumed, and supersession must release "
          "staged charges exactly once")
def _build_push_vs_replan(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    store = PushedStoreModel(world, tenant=5)
    store.on_plan(1)
    # epoch-1 planned pushes from two map executors (own connections),
    # including a duplicate re-delivery and a late straggler that can
    # land after the re-plan broadcast
    sched.post("push.m0.e1",
               lambda s: store.push(0, 0, fence=1, plan_epoch=1,
                                    nbytes=100),
               chan="pusher0", touches={"pushed"})
    sched.post("repush.m0.e1",
               lambda s: store.push(0, 0, fence=1, plan_epoch=1,
                                    nbytes=100),
               chan="pusher0", touches={"pushed"})
    sched.post("push.m1.e1",
               lambda s: store.push(0, 1, fence=1, plan_epoch=1,
                                    nbytes=60),
               chan="pusher1", touches={"pushed"})
    # the driver's re-plan rides the broadcast channel; the re-pushed
    # epoch-2 ranges ride the pushers' own channels and may arrive
    # BEFORE the broadcast (the store adopts the newer epoch either way)
    sched.post("bcast.replan.e2", lambda s: store.on_plan(2),
               chan="drv.bcast", touches={"pushed"})
    sched.post("push.m0.e2",
               lambda s: store.push(0, 0, fence=2, plan_epoch=2,
                                    nbytes=120),
               chan="pusher0", touches={"pushed"})
    sched.post("push.m1.e2",
               lambda s: store.push(0, 1, fence=2, plan_epoch=2,
                                    nbytes=80),
               chan="pusher1", touches={"pushed"})
    # the reducer's pushed-first resolution can fire at any point in the
    # race; whatever it sees must be stamped with the store's current
    # plan epoch (the consume() check sets world.problem otherwise)
    sched.post("reduce.consume.p0", lambda s: store.consume(0),
               chan="reducer", touches={"pushed"})
    return world


@scenario("push_vs_tombstone",
          "planned pushes race the shuffle's drop broadcast: when the "
          "drop wins, a late push must not leak a staging charge, and "
          "nothing may serve from the dropped store")
def _build_push_vs_tombstone(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    store = PushedStoreModel(world, tenant=6)
    store.on_plan(1)
    sched.post("push.m0.f1",
               lambda s: store.push(0, 0, fence=1, plan_epoch=1,
                                    nbytes=100),
               chan="pusher0", touches={"pushed"})
    sched.post("push.m1.f1",
               lambda s: store.push(0, 1, fence=1, plan_epoch=1,
                                    nbytes=60),
               chan="pusher0", touches={"pushed"})
    # a re-executed attempt's superseding push on its own connection
    sched.post("push.m0.f2",
               lambda s: store.push(0, 0, fence=2, plan_epoch=1,
                                    nbytes=120),
               chan="pusher1", touches={"pushed"})
    # TTL sweep / unregister: the drop broadcast then the EPOCH_DEAD
    # delivery ride the driver's FIFO broadcast channel
    def drop(s):
        world.unregister()
        store.drop()
        s.post("dead->obs0", lambda s2: world.deliver_dead(0),
               chan="obs0.push", touches={"obs0"})
    sched.post("bcast.drop", drop, chan="drv.bcast",
               touches={"pushed", "obs0"})
    # a straggler push that can land AFTER the drop (must not charge)
    # and a post-drop consume (must serve nothing)
    sched.post("push.m1.f1.late",
               lambda s: store.push(0, 1, fence=1, plan_epoch=1,
                                    nbytes=60),
               chan="pusher1", touches={"pushed"})
    def consume(s):
        if store.consume(0) and store.dropped:
            world.problem = ("pushed-fence: dropped store served "
                            "staged ranges")
    sched.post("reduce.consume.p0", consume, chan="reducer",
               touches={"pushed"})
    return world


@scenario("tier_vs_replan",
          "a repair publish supersedes a merged segment mid-upload: "
          "the stale blob must never resolve, whether its publish "
          "beats the driver's prune or loses to the supersession "
          "tombstone; an unrelated partition's blob must survive")
def _build_tier_vs_replan(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    cold = ColdTierModel(world, tenant=7)
    world.publish(0, 500, 0, fence=1)
    world.publish(1, 501, 1, fence=1)
    # the tiering executor uploads the finalized partition-0 segment
    # covering both maps: PUT then one-sided publish, FIFO on its own
    # channel — the publish can land before OR after the repair prune
    sched.post("tier.put.p0",
               lambda s: cold.put("7/p0/seg_0_1", 100),
               chan="tier0", touches={"cold"})
    sched.post("tier.pub.p0",
               lambda s: cold.publish("7/p0/seg_0_1", 0, {0, 1}),
               chan="tier0", touches={"cold"})
    # a second target's partition-1 blob covering only map 1 rides its
    # own channel; the repair of map 0 must not take it down
    sched.post("tier.put.p1",
               lambda s: cold.put("7/p1/seg_1_2", 60),
               chan="tier1", touches={"cold"})
    sched.post("tier.pub.p1",
               lambda s: cold.publish("7/p1/seg_1_2", 1, {1}),
               chan="tier1", touches={"cold"})

    # map 0 re-executes (corrupt-output repair) and republishes at
    # fence 2: the driver prunes tiered entries covering it and
    # tombstones the map id against the still-in-flight upload
    def repair(s):
        world.publish(0, 700, 1, fence=2)
        cold.repair(0)
    sched.post("repair.m0.f2", repair, chan="drv",
               touches={"cold", "driver"})
    # the reducer's tiered rung can fire at any point in the race;
    # whatever it serves must never be a superseded map's old bytes
    sched.post("reduce.resolve.p0", lambda s: cold.resolve(0),
               chan="reducer", touches={"cold"})
    sched.post("reduce.resolve.p1", lambda s: cold.resolve(1),
               chan="reducer", touches={"cold"})
    return world


@scenario("tier_vs_unregister",
          "an upload races EPOCH_DEAD/unregister: whichever order, "
          "the blob is refused or reaped with its tenant charge "
          "repaid exactly once, and nothing serves a dead shuffle's "
          "directory")
def _build_tier_vs_unregister(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    cold = ColdTierModel(world, tenant=8)
    world.publish(0, 500, 0, fence=1)
    # a segment upload and a drain-row upload on separate channels,
    # each as PUT-then-publish, both racing the death broadcast
    sched.post("tier.put.seg",
               lambda s: cold.put("7/p0/seg_0_1", 100),
               chan="tier0", touches={"cold"})
    sched.post("tier.pub.seg",
               lambda s: cold.publish("7/p0/seg_0_1", 0, {0, 1}),
               chan="tier0", touches={"cold"})
    sched.post("tier.put.drain",
               lambda s: cold.put("7/p1/drain_m1_1", 60),
               chan="tier1", touches={"cold"})
    sched.post("tier.pub.drain",
               lambda s: cold.publish("7/p1/drain_m1_1", 1, {1}),
               chan="tier1", touches={"cold"})

    # TTL sweep / unregister: EPOCH_DEAD rides the driver's FIFO
    # broadcast; the tiering service drops (reap + repay) on receipt
    def drop(s):
        world.unregister()
        cold.drop()
        s.post("dead->obs0", lambda s2: world.deliver_dead(0),
               chan="obs0.push", touches={"obs0"})
    sched.post("bcast.drop", drop, chan="drv.bcast",
               touches={"cold", "obs0"})
    # a post-death resolve must serve NOTHING from the dead directory
    sched.post("reduce.resolve.p0", lambda s: cold.resolve(0),
               chan="reducer", touches={"cold"})
    return world


@scenario("driver_failover_mid_publish",
          "the primary dies with publishes in flight and a partially "
          "replicated op-log; the standby CAS-takes the lease, replays "
          "with real classes, and re-broadcasts under the next "
          "incarnation — re-sent publishes must be idempotent and "
          "every epoch push monotone ACROSS incarnations")
def _build_driver_failover_mid_publish(sched: VirtualScheduler) -> World:
    world = World(num_observers=2, num_maps=2)
    sid = world.sid
    world.lease_acquire("primary", 0, now=0.0)
    # committed pre-history at the primary: map0's publish plus its
    # staging charge, already appended to the incarnation-0 log
    world.publish(0, 700, 0, fence=1)
    world.charge(9, 100)
    rec0 = world.primary_log(("publish", 0, 700, 0, 1))
    rec0c = world.primary_log(("charge", 9, 100))
    snap1 = DriverTable.from_bytes(world.table.to_bytes())
    state = {"table": world.table}

    def repl(recs):
        def deliver(s, recs=recs):
            del s
            for r in recs:
                world.standby_deliver("sb", *r)
        return deliver

    # the replication stream is FIFO to the standby but races everything
    # else the dying primary does
    sched.post("repl.pub0", repl([rec0, rec0c]), chan="standby.stream",
               touches={"standby"})

    # epoch-1 table responses already in flight to both observers
    for i in range(2):
        def resp1(s, i=i):
            del s
            world.observers[i].put_table(sid, snap1, 1)
        sched.post(f"resp.e1->obs{i}", resp1, chan=f"obs{i}.resp",
                   touches={f"obs{i}"})

    # map1's publish lands at the primary mid-death; its log append may
    # or may not reach the standby before the takeover
    def pub1(s):
        world.publish(1, 701, 1, fence=1)
        world.charge(9, 60)
        r1 = world.primary_log(("publish", 1, 701, 1, 1))
        r2 = world.primary_log(("charge", 9, 60))
        s.post("repl.pub1", repl([r1, r2]), chan="standby.stream",
               touches={"standby"})
    sched.post("drv.pub1", pub1, touches={"table", "standby"})

    # lease expired: the standby CAS-takes term 1, replays whatever
    # prefix it holds, and re-broadcasts rebased state
    def takeover(s):
        if not world.lease_acquire("sb", 1, now=11.0):
            return
        st = world.takeover("sb", 1, now=11.0)
        state["table"] = st["table"]
        for i in range(len(world.observers)):
            def bump(s2, i=i, e=st["epoch"]):
                del s2
                world.observers[i].note_epoch(sid, e)
            s.post(f"takeover.e->obs{i}", bump, chan=f"obs{i}.push",
                   touches={f"obs{i}"})

            def resp2(s2, i=i, e=st["epoch"], t=st["table"]):
                del s2
                world.observers[i].put_table(sid, t, e)
            s.post(f"takeover.table->obs{i}", resp2,
                   chan=f"obs{i}.resp", touches={f"obs{i}"})
    sched.post("sb.takeover", takeover,
               touches={"lease", "standby", "table", "obs0", "obs1"})

    # DriverClient re-sends both publishes against whoever is primary —
    # the fence floors make the re-send a no-op or a legal first apply
    sched.post("repub.m0",
               lambda s: world.publish(0, 700, 0, fence=1,
                                       table=state["table"]),
               chan="exec0.drv", touches={"table"})
    sched.post("repub.m1",
               lambda s: world.publish(1, 701, 1, fence=1,
                                       table=state["table"]),
               chan="exec1.drv", touches={"table"})
    return world


@scenario("split_brain_two_leases",
          "two standbys race the term-1 CAS while the primary's renew "
          "heartbeats ride their own channel; exactly one holder per "
          "term, only the winner promotes, and a live lease refuses "
          "the loser's next-term retry")
def _build_split_brain_two_leases(sched: VirtualScheduler) -> World:
    world = World(num_observers=2, num_maps=1)
    sid = world.sid
    world.lease_acquire("primary", 0, now=0.0)  # expires at now=10

    def promote(s, name: str, term: int, now: float) -> None:
        st = world.takeover(name, term, now=now)
        for i in range(len(world.observers)):
            def bump(s2, i=i, e=st["epoch"]):
                del s2
                world.observers[i].note_epoch(sid, e)
            s.post(f"{name}.t{term}.e->obs{i}", bump,
                   chan=f"obs{i}.push", touches={f"obs{i}"})

    # renew heartbeats: the first lands before expiry (extends), the
    # second races the standbys — it must fail once term 1 is granted
    sched.post("primary.renew1",
               lambda s: world.lease_renew("primary", 0, now=9.0),
               chan="primary.lease", touches={"lease"})
    sched.post("primary.renew2",
               lambda s: world.lease_renew("primary", 0, now=12.0),
               chan="primary.lease", touches={"lease"})

    def acquire(name: str, term: int, now: float):
        def fire(s):
            if world.lease_acquire(name, term, now=now):
                promote(s, name, term, now)
        return fire
    sched.post("sbA.acquire", acquire("sbA", 1, 11.0), chan="sbA",
               touches={"lease", "standby", "obs0", "obs1"})
    sched.post("sbB.acquire", acquire("sbB", 1, 11.5), chan="sbB",
               touches={"lease", "standby", "obs0", "obs1"})
    # next-term retries: a LIVE term-1 lease held by the other standby
    # must refuse these (no term burn while the holder is alive)
    sched.post("sbA.retry", acquire("sbA", 2, 12.0), chan="sbA",
               touches={"lease", "standby", "obs0", "obs1"})
    sched.post("sbB.retry", acquire("sbB", 2, 12.5), chan="sbB",
               touches={"lease", "standby", "obs0", "obs1"})
    return world


@scenario("zombie_primary_publish",
          "a fenced old primary keeps its connections: renew attempts, "
          "old-incarnation epoch pushes, and log appends race the new "
          "primary's re-broadcast — every one must lose to the "
          "incarnation component everywhere an epoch is compared")
def _build_zombie_primary_publish(sched: VirtualScheduler) -> World:
    world = World(num_observers=2, num_maps=2)
    sid = world.sid
    world.lease_acquire("primary", 0, now=0.0)
    world.publish(0, 800, 0, fence=1)
    rec0 = world.primary_log(("publish", 0, 800, 0, 1))
    world.standby_deliver("sb", *rec0)  # replicated before the death
    snap1 = DriverTable.from_bytes(world.table.to_bytes())
    state = {"table": world.table}
    for i in range(2):
        world.observers[i].put_table(sid, snap1, 1)
        world.observers[i].note_epoch(sid, 1)

    def takeover(s):
        if not world.lease_acquire("sb", 1, now=11.0):
            return
        st = world.takeover("sb", 1, now=11.0)
        state["table"] = st["table"]
        for i in range(len(world.observers)):
            def bump(s2, i=i, e=st["epoch"]):
                del s2
                world.observers[i].note_epoch(sid, e)
            s.post(f"takeover.e->obs{i}", bump, chan=f"obs{i}.push",
                   touches={f"obs{i}"})
    sched.post("sb.takeover", takeover,
               touches={"lease", "standby", "table", "obs0", "obs1"})

    # the zombie's renew: legal only while no higher term exists (the
    # lease_renew mirror flags a post-takeover success)
    sched.post("zombie.renew",
               lambda s: world.lease_renew("primary", 0, now=11.5),
               chan="primary.lease", touches={"lease"})

    # the zombie's epoch-bump pushes carry small incarnation-0 values;
    # they ride its own still-open connections (distinct channels from
    # the new primary's pushes) and must never regress an observer
    zbump = world.epochs[sid] + 1
    for i in range(2):
        def zb(s, i=i):
            del s
            world.observers[i].note_epoch(sid, zbump)
        sched.post(f"zombie.bump->obs{i}", zb, chan=f"obs{i}.zpush",
                   touches={f"obs{i}"})

    # the zombie applies + appends a publish: before the takeover it is
    # a legitimate primary (the op replicates and replays); after, the
    # (incarnation, seq) guard at the standby fences the append
    def zappend(s):
        del s
        world.publish(1, 801, 0, fence=1)
        rec = world.primary_log(("publish", 1, 801, 0, 1),
                                incarnation=0)
        world.standby_deliver("sb", *rec)
    sched.post("zombie.append", zappend, chan="standby.stream",
               touches={"table", "standby"})

    # an executor re-sends map0's publish to whoever is primary
    sched.post("repub.m0",
               lambda s: world.publish(0, 800, 0, fence=1,
                                       table=state["table"]),
               chan="exec0.drv", touches={"table"})
    return world


@scenario("failover_vs_ttl_sweep",
          "the TTL sweep's unregister races its own replication and "
          "the takeover; the promoted standby re-derives the sweep "
          "from replicated register times, so a DEAD shuffle stays "
          "dead whether or not the unregister op ever replicated")
def _build_failover_vs_ttl_sweep(sched: VirtualScheduler) -> World:
    world = World(num_observers=2, num_maps=2)
    sid = world.sid
    world.lease_acquire("primary", 0, now=0.0)
    world.publish(0, 900, 0, fence=1)
    world.publish(1, 901, 1, fence=1)
    for rec in (world.primary_log(("publish", 0, 900, 0, 1)),
                world.primary_log(("publish", 1, 901, 1, 1))):
        world.standby_deliver("sb", *rec)
    # the register time rode the log at register; by now the TTL is
    # past, so the primary's sweep AND a promoted standby's re-derived
    # sweep both see the shuffle expired
    world.ttl_expired = True
    snap = DriverTable.from_bytes(world.table.to_bytes())

    for i in range(2):
        def resp(s, i=i):
            del s
            world.observers[i].put_table(sid, snap, 1)
        sched.post(f"resp.e1->obs{i}", resp, chan=f"obs{i}.resp",
                   touches={f"obs{i}"})

    def sweep(s):
        world.unregister()
        rec = world.primary_log(("unregister",))
        # append-before-push: the broadcaster queues the standby stream
        # send ahead of the EPOCH_DEAD pushes, but the standby's
        # PROCESSING still races them — which is exactly why the
        # promoted standby must re-derive the sweep instead of trusting
        # this op to have arrived
        s.post("repl.unreg",
               lambda s2: world.standby_deliver("sb", *rec),
               chan="standby.stream", touches={"standby"})
        for i in range(len(world.observers)):
            s.post(f"dead->obs{i}",
                   lambda s2, i=i: world.deliver_dead(i),
                   chan=f"obs{i}.push", touches={f"obs{i}"})
    sched.post("ttl.sweep", sweep,
               touches={"driver", "standby", "obs0", "obs1"})

    def takeover(s):
        if not world.lease_acquire("sb", 1, now=11.0):
            return
        st = world.takeover("sb", 1, now=11.0)
        if st["live"]:
            # only a live restored shuffle re-broadcasts positive state
            for i in range(len(world.observers)):
                def bump(s2, i=i, e=st["epoch"]):
                    del s2
                    world.observers[i].note_epoch(sid, e)
                s.post(f"takeover.e->obs{i}", bump,
                       chan=f"obs{i}.push", touches={f"obs{i}"})
        else:
            for i in range(len(world.observers)):
                s.post(f"takeover.dead->obs{i}",
                       lambda s2, i=i: world.deliver_dead(i),
                       chan=f"obs{i}.push", touches={f"obs{i}"})
    sched.post("sb.takeover", takeover,
               touches={"lease", "standby", "obs0", "obs1"})
    return world


@scenario("handoff_vs_publish",
          "shard ownership handoff races in-flight direct publishes: "
          "the old owner seals, the new owner adopts + replays the "
          "standby stream, stragglers bounce to the driver — no ACKed "
          "write may be lost, no sealed shard may apply")
def _build_handoff_vs_publish(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    gen1 = compose_epoch(0, 1)
    gen2 = compose_epoch(0, 2)
    # host A owns shard 0 (maps [0, 2)) at gen1; map0's publish already
    # ACKed + streamed pre-history
    world.shard_adopt("A", 0, 0, 2, gen1)
    world.shard_publish("A", 0, 0, token=500, exec_index=0, fence=1,
                        gen=gen1)

    # in-flight concurrent with the handoff: map1's first publish aimed
    # at A (may land before the seal — ACK + converge — or after —
    # bounce to the driver), a zombie fence-0 re-publish of map0, and a
    # supersede of map0 at fence 2
    sched.post("pub.m1->A",
               lambda s: world.shard_publish("A", 0, 1, 510, 1, 1, gen1),
               chan="pubX", touches={"A", "table"})
    sched.post("zombie.m0->A",
               lambda s: world.shard_publish("A", 0, 0, 499, 0, 0, gen1),
               chan="pubY", touches={"A", "table"})
    sched.post("supersede.m0->A",
               lambda s: world.shard_publish("A", 0, 0, 501, 0, 2, gen1),
               chan="pubZ", touches={"A", "table"})

    # the handoff: ShardMapMsg/ShardHandoffMsg fan out on per-member
    # FIFO channels, so A's seal and B's adopt+replay are CONCURRENT —
    # B can own before A sealed (gen admission is the guard, not the
    # seal), and stragglers at A after the seal bounce to the driver
    sched.post("handoff.seal@A", lambda s: world.shard_seal("A", 0),
               chan="A.push", touches={"A"})
    sched.post("handoff.adopt@B",
               lambda s: world.shard_adopt("B", 0, 0, 2, gen2,
                                           replay_from="A"),
               chan="B.push", touches={"B"})
    # the republish backstop: the publisher re-aims its remembered
    # map0 publish at the new owner under gen2 (fence-idempotent)
    sched.post("republish.m0->B",
               lambda s: world.shard_publish("B", 0, 0, 500, 0, 1, gen2),
               chan="pubX", touches={"B", "table"})
    return world


@scenario("handoff_vs_driver_failover",
          "a shard handoff issued by the dying driver incarnation races "
          "the promoted driver's re-assignment: composed generations "
          "put the incarnation in the high bits, so the new "
          "incarnation's assignment dominates in EVERY arrival order "
          "and the zombie assignment can never un-seat it")
def _build_handoff_vs_driver_failover(sched: VirtualScheduler) -> World:
    world = World(num_observers=1, num_maps=2)
    gen_old = compose_epoch(0, 1)
    gen_zombie = compose_epoch(0, 2)   # the dying driver's handoff
    gen_new = compose_epoch(1, 1)      # the promoted driver's assignment
    world.lease_acquire("primary", 0, now=0.0)
    world.shard_adopt("A", 0, 0, 2, gen_old)
    world.shard_publish("A", 0, 0, token=700, exec_index=0, fence=1,
                        gen=gen_old)

    # the old incarnation's handoff to B and the new incarnation's
    # assignment to C race at both hosts in any order; forward-only
    # adoption on the composed generation must leave C the owner
    sched.post("zombie.handoff.seal@A",
               lambda s: world.shard_seal("A", 0),
               chan="A.push", touches={"A"})
    sched.post("zombie.handoff.adopt@B",
               lambda s: world.shard_adopt("B", 0, 0, 2, gen_zombie,
                                           replay_from="A"),
               chan="B.push", touches={"B"})

    def takeover(s):
        if not world.lease_acquire("sb", 1, now=11.0):
            return
        world.takeover("sb", 1, now=11.0)
        # the promoted driver re-assigns shard 0 to C; B (if it adopted
        # the zombie handoff) must seal or be superseded by generation
        s.post("new.assign.adopt@C",
               lambda s2: world.shard_adopt("C", 0, 0, 2, gen_new,
                                            replay_from="A"),
               chan="C.push", touches={"C"})
        s.post("new.assign.seal@B",
               lambda s2: world.shard_seal("B", 0),
               chan="B.push", touches={"B"})
    sched.post("sb.takeover", takeover,
               touches={"lease", "standby", "B", "C"})

    # a straggler write still stamped with the ZOMBIE generation: every
    # owner must bounce it (STALE_GEN at C, SEALED/NOT_OWNER at B) into
    # the driver-direct path — it may never apply under gen_zombie at
    # the new incarnation's owner
    def straggler(s):
        status = world.shard_publish("C", 0, 1, 710, 1, 1, gen_zombie)
        if status == shard_plane.APPLIED and \
                incarnation_of(world.shard_owner("C").gen_of(
                    world.sid, 0) or 0) != 0:
            world.problem = ("shard-gen-fence: a zombie-generation "
                             "write applied at the new incarnation's "
                             "owner")
    sched.post("straggler.m1->C", straggler, chan="pubS",
               touches={"C", "table"})
    return world


# ------------------------------------------------------------ entry points

def _anchor_of(run: Run, build: Callable) -> Tuple[str, int]:
    """Anchor a violation at the culprit step's function if it lives in
    a real file, else at the scenario builder."""
    fn = run.culprit.fn if run.culprit is not None else build
    anchor = run.culprit.anchor if run.culprit is not None else None
    if anchor is not None:
        return anchor
    code = getattr(fn, "__code__", None)
    if code is not None and os.path.exists(code.co_filename):
        return code.co_filename, code.co_firstlineno
    return inspect.getsourcefile(build) or "<unknown>", 0


@dataclass
class ScenarioStats:
    name: str
    dfs_schedules: int   # distinct reduced schedules the DFS completed
    walk_schedules: int  # seeded random walks on top
    max_depth_seen: int
    budget_hit: bool     # DFS stopped at max_schedules, not exhaustion


def run_scenario(scn: Scenario, max_schedules: int = 256,
                 max_depth: int = 64, walks: int = 16, seed: int = 0
                 ) -> Tuple[List[Run], ScenarioStats]:
    runs = explore_dfs(scn.build, check_invariants,
                       max_schedules=max_schedules, max_depth=max_depth)
    dfs_n = len(runs)
    budget_hit = dfs_n >= max_schedules
    if walks > 0 and not any(r.violation for r in runs):
        runs += random_walks(scn.build, check_invariants, walks=walks,
                             seed=seed, max_depth=max_depth * 4)
    stats = ScenarioStats(scn.name, dfs_n, len(runs) - dfs_n,
                          max((len(r.trace) for r in runs), default=0),
                          budget_hit)
    return runs, stats


def run_catalog(max_schedules: Optional[int] = None,
                max_depth: Optional[int] = None,
                walks: Optional[int] = None, seed: int = 0,
                trace_dir: Optional[str] = None,
                root: Optional[str] = None
                ) -> Tuple[List[Finding], List[ScenarioStats]]:
    """Run every catalog scenario; violations become findings anchored
    at the culprit step, with the violating trace dumped as a JSON
    artifact for ``--replay`` when ``trace_dir`` is set.

    Budgets default from the environment (``MODELCHECK_SCHEDULES`` /
    ``MODELCHECK_DEPTH`` / ``MODELCHECK_WALKS``) so CI can widen the
    sweep without a code change; the in-code defaults fit the tier-1
    time box."""
    root = root or repo_root()
    max_schedules = max_schedules if max_schedules is not None else int(
        os.environ.get("MODELCHECK_SCHEDULES", "256"))
    max_depth = max_depth if max_depth is not None else int(
        os.environ.get("MODELCHECK_DEPTH", "64"))
    walks = walks if walks is not None else int(
        os.environ.get("MODELCHECK_WALKS", "16"))
    findings: List[Finding] = []
    stats: List[ScenarioStats] = []
    for scn in catalog():
        runs, st = run_scenario(scn, max_schedules=max_schedules,
                                max_depth=max_depth, walks=walks,
                                seed=seed)
        stats.append(st)
        for run in runs:
            if run.violation is None:
                continue
            path, line = _anchor_of(run, scn.build)
            trace_note = " -> ".join(run.trace)
            if trace_dir is not None:
                os.makedirs(trace_dir, exist_ok=True)
                artifact = os.path.join(trace_dir,
                                        f"{scn.name}.trace.json")
                with open(artifact, "w") as f:
                    json.dump({"scenario": scn.name, "seed": seed,
                               "trace": list(run.trace)}, f, indent=2)
                trace_note += f" (trace dumped to {artifact})"
            findings.append(Finding(
                PASS, rel(root, path), line,
                f"scenario {scn.name}: {run.violation}; "
                f"schedule: {trace_note}"))
            break  # one finding per scenario; the trace replays the rest
    return findings, stats


def replay_trace(path: str) -> Run:
    """Replay one dumped trace artifact byte-identically; raises
    AssertionError if the reproduction diverges."""
    with open(path) as f:
        doc = json.load(f)
    scn = next((s for s in catalog() if s.name == doc["scenario"]), None)
    if scn is None:
        raise ValueError(f"unknown scenario {doc['scenario']!r} in {path}")
    run = replay(scn.build, check_invariants, doc["trace"])
    if list(run.trace) != list(doc["trace"])[:len(run.trace)]:
        raise AssertionError(
            f"replay diverged: {run.trace} != {doc['trace']}")
    return run
