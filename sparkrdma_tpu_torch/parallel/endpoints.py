"""Driver/executor control-plane endpoints.

The reference splits roles the same way (java/RdmaNode.java:150-158 — the
driver accepts RPC channels, executors accept passive read-responder
channels; scala/RdmaShuffleManager.scala:73-134 — the driver's receive
listener runs membership):

* ``DriverEndpoint`` — accepts hellos, maintains the ordered membership
  list, broadcasts announces to every known executor
  (scala/RdmaShuffleManager.scala:76-115), hosts per-shuffle driver tables
  (allocated at registerShuffle, scala/RdmaShuffleManager.scala:168-183),
  applies positional publish writes, serves whole-table fetches.
* ``ExecutorEndpoint`` — sends hello on start
  (scala/RdmaShuffleManager.scala:204-226), learns membership from
  announces, serves block-location and block-byte reads out of a local
  ``ShuffleDataSource``, and exposes the client-side fetch calls used by the
  fetcher iterator.

Executor *indices* — the compact ints stored in driver-table entries — are
positions in the announce-ordered membership list (append-only), playing the
role the (address, lkey) pair plays in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import struct
import threading
import time
from typing import Dict, List, Optional, Protocol, Tuple

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel.driver_client import (DriverClient,
                                                  DriverUnreachableError)
from sparkrdma_tpu_torch.parallel.rpc_msg import (AnnounceMsg, HelloMsg, RpcMsg,
                                            decode_message)
from sparkrdma_tpu_torch.parallel.transport import (
    ChecksumError,
    Connection,
    ConnectionCache,
    ControlServer,
    FetchStatusError,
    TransportError,
    await_response,
)
from sparkrdma_tpu_torch.shuffle.map_output import (
    MAP_ENTRY_SIZE,
    DriverTable,
    MapTaskOutput,
)
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.ids import ShuffleManagerId

log = logging.getLogger(__name__)

# Dead-slot marker in membership lists: keeps executor indices stable after a
# loss while making the slot unroutable.
from sparkrdma_tpu_torch.utils.ids import ExecutorId as _ExecutorId  # noqa: E402

TOMBSTONE = ShuffleManagerId(_ExecutorId("", "", 0), "", 0)


class DeadExecutorError(RuntimeError):
    """Raised when a fetch resolves to a tombstoned (lost) executor slot."""


def _codec_aad(req, flags: int) -> bytes:
    """Associated data binding a wrapped fetch payload to its request:
    a recorded response replayed onto a different req_id/shuffle or with
    flipped flags fails verification (both sides derive this
    independently — it never travels)."""
    import struct

    return struct.pack("<qiI", req.req_id, req.shuffle_id, flags)


class AsyncFetch:
    """Completion handle for a pipelined fetch issued via
    ``Connection.request_async``: the request is already on the wire;
    ``result()`` finishes it on the CALLING thread (decode, credit
    bookkeeping, status handling) so connection reader threads never
    carry per-fetch CPU work. ``wire_done_s`` is stamped
    (``time.monotonic``) the instant the raw response lands — the
    issue→wire→complete boundary the fetcher's trace spans use."""

    __slots__ = ("wire_done_s", "_fut", "_default_timeout_s", "_complete")

    def __init__(self, fut, default_timeout_s: float, complete):
        self.wire_done_s: Optional[float] = None
        self._fut = fut
        self._default_timeout_s = default_timeout_s
        self._complete = complete
        fut.add_done_callback(self._stamp)

    def _stamp(self, _fut) -> None:
        self.wire_done_s = time.monotonic()

    def done(self) -> bool:
        """True once the raw response (or failure) has landed; a
        subsequent ``result()`` will not block on the wire."""
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        tmo = self._default_timeout_s if timeout is None else timeout
        return self._complete(await_response(self._fut, tmo))

    def cancel(self) -> None:
        """Abandon the request: cancelling a still-pending future fires
        the connection's cleanup callback, reclaiming its send-budget
        slot (an abandoned-but-never-answered request must not hold a
        slot forever). No-op once the response has landed — the
        done-callback already released the slot, and the credit
        bookkeeping's orphan path owns any landed-late response."""
        self._fut.cancel()


class ShuffleDataSource(Protocol):
    """What an executor serves to its peers (implemented by the resolver)."""

    def get_output_table(self, shuffle_id: int, map_id: int) -> Optional[MapTaskOutput]:
        ...

    def read_block(self, shuffle_id: int, buf_token: int, offset: int,
                   length: int) -> Optional[bytes]:
        ...


class DriverEndpoint:
    """Control-plane driver.

    With driver HA armed (``ha_standbys`` > 0, or constructed by a
    promoting :class:`~sparkrdma_tpu_torch.shuffle.ha.DriverStandby`), every
    mutation of the tables below is wrapped in an
    :class:`~sparkrdma_tpu_torch.shuffle.ha.OpLog` and streamed to registered
    standbys over the same push channel executors use. ``incarnation``
    is the lease term this endpoint was built at: it composes into the
    HIGH bits of every epoch this endpoint mints
    (:func:`~sparkrdma_tpu_torch.shuffle.ha.compose_epoch`), so after a
    failover every epoch the new primary publishes strictly dominates
    anything the deposed one can still push — the existing keep-highest
    guards ARE the zombie fence. ``restore`` is the promoting standby's
    ``(snapshot_blob | None, tail_records)``: replayed before serving,
    then the authoritative state is re-broadcast (membership, epoch
    rebases, plans, re-finalize, TakeoverMsg)."""

    def __init__(self, conf: Optional[TpuShuffleConf] = None, host: str = "",
                 incarnation: int = 0, server: Optional[ControlServer] = None,
                 lease_store=None, lease_holder: Optional[str] = None,
                 restore=None):
        from sparkrdma_tpu_torch.shuffle.ha import OpLog
        self.conf = conf or TpuShuffleConf()
        bind_host = host or self.conf.driver_host or "127.0.0.1"
        # elastic membership (parallel/membership.py): the epoch-versioned
        # membership plane replaces the old static slot list — slots keep
        # stable indices forever, but each carries a LIVE/DRAINING/DEAD
        # state and every change bumps ONE monotone epoch, pushed to
        # executors as a MembershipBumpMsg on the announce channel.
        from sparkrdma_tpu_torch.parallel.membership import MembershipPlane
        self.membership = MembershipPlane(tombstone=TOMBSTONE)
        # planned-drain accounting (membership.drain_slot): completed
        # graceful retires (zero re-executions) vs deadline/death
        # fallbacks into ordinary tombstone recovery
        self.drains_completed = 0
        self.drain_fallbacks = 0
        self.autoscaler = None
        self._tables: Dict[int, DriverTable] = {}
        self._tables_lock = threading.Lock()
        # metadata plane (shuffle/location_plane.py): per-shuffle location
        # EPOCH — the version reducers' caches validate against. Starts
        # at 1 on register; moves ONLY when location state is repaired
        # (an applied publish overwrites an existing entry, an executor
        # is tombstoned) or the shuffle dies (EPOCH_DEAD). Guarded by
        # _tables_lock (epoch and table always move together).
        self._epochs: Dict[int, int] = {}
        # shuffle -> (ShardMap, owner_gen). The generation is composed
        # like an epoch (ha.compose_epoch: incarnation high, per-
        # incarnation handoff seq low) so a post-failover assignment
        # always dominates every pre-failover owner's.
        self._shard_maps: Dict[int, tuple] = {}
        self.epoch_bumps = 0  # audit: pushed invalidations
        self.shard_handoffs = 0  # audit: shard ownership moves pushed
        self.shard_batches = 0  # audit: owner batches converged
        # adaptive reduce planning (shuffle/planner.py): per-shuffle size
        # histograms fed by publish lengths, the published plans, and the
        # reduce-partition count the manager registered with. Guarded by
        # _tables_lock (sizes and tables always move together).
        self._size_hists: Dict[int, object] = {}
        self._plans: Dict[int, object] = {}
        self._num_partitions: Dict[int, int] = {}
        self.plan_replans = 0  # audit: mid-stage re-plans pushed
        # push-merge (shuffle/push_merge.py): the driver's merged-segment
        # directory per shuffle — fed one-sided by merge targets'
        # MergedPublishMsg, served to reducers (FetchMergedReq), pruned
        # on repair publishes (drop_map) and tombstones (drop_slot).
        # Guarded by _tables_lock like every other per-shuffle table.
        self._merged: Dict[int, object] = {}
        self._finalize_sent: set = set()
        self.merged_publishes = 0  # audit: directory entries applied
        self.merged_zombie_drops = 0  # publishes from a DEAD slot dropped
        # cold tier (shuffle/cold_tier.py): the driver's tiered-blob
        # directory per shuffle — fed one-sided by TieredPublishMsg,
        # served to reducers (FetchTieredReq), pruned on repair
        # publishes (drop_map) but NEVER on tombstones: blobs outlive
        # the executor that uploaded them (that is the point). Guarded
        # by _tables_lock like every other per-shuffle table.
        self._tiered: Dict[int, object] = {}
        self.tiered_publishes = 0  # audit: tiered entries applied
        self.tiered_stale_drops = 0  # publishes of superseded maps dropped
        # (shuffle, map) pairs a repair publish superseded: an upload
        # that was mid-flight when the repair landed publishes LATE —
        # its blob carries the replaced attempt's bytes and must never
        # enter the directory (modelcheck tier_vs_replan). Bounded the
        # same two ways as the merge store's zombie markers; the race
        # it defends against is bounded by upload latency.
        from sparkrdma_tpu_torch.utils.tombstones import TombstoneCache
        self._tiered_superseded = TombstoneCache(ttl_s=30.0, cap=4096)
        self._clients = ConnectionCache(self.conf)
        # One broadcaster thread + a coalescing slot instead of a thread per
        # membership event: N executors joining produce O(N) sends of the
        # newest snapshot, not O(N^2) (the reference pre-connects async and
        # caches for the same reason, java/RdmaNode.java:283-353).
        self._announce_cond = threading.Condition()
        self._announce_pending: Optional[Tuple[List[ShuffleManagerId], int]] = None
        # metadata-plane pushes (epoch bumps, shard maps, shard-entry
        # forwards) ride the SAME broadcaster thread as announces:
        # invalidation is pushed on the existing channel, never polled,
        # and a dead peer's connect budget can never stall a publish
        # handler or the engine's register call. Items are
        # (target | None, msg); None broadcasts to every live member.
        self._push_pending: List[Tuple[Optional[ShuffleManagerId], RpcMsg]] = []
        self._announce_stop = False
        self._broadcaster = threading.Thread(
            target=self._broadcast_loop, daemon=True, name="driver-announce")
        self._broadcaster.start()
        # Long-poll table waiters: shuffle_id -> [(conn, req_id,
        # min_published, deadline)]. Registered when a fetch can't be
        # satisfied yet; answered by the publish that satisfies it (push,
        # not client polling) or by the expiry sweeper with the partial
        # table. Never blocks a handler thread — a blocked handler would
        # deadlock against publishes arriving on the same connection.
        self._waiters: Dict[int, list] = {}
        self._waiters_lock = threading.Lock()
        self._sweeper = threading.Thread(target=self._sweep_waiters,
                                         daemon=True, name="driver-sweeper")
        self._sweeper.start()
        # broadcast blobs (shared_vars.Broadcast): id -> pickled value,
        # served to executors on GetBroadcastReq
        self._broadcasts: Dict[int, bytes] = {}
        self._broadcasts_lock = threading.Lock()
        # commit-fencing audit: publishes rejected as stale (a zombie
        # speculative attempt's late publish)
        self.fenced_publishes = 0
        # tenancy (shuffle/tenancy.py): per-shuffle owning tenant +
        # registration time (the TTL clock), the admission gate on
        # registerShuffle, and the GC sweeper that unregisters expired
        # shuffles (terminal EPOCH_DEAD push; executors reap disk on
        # receipt). Guarded by _tables_lock: tenant and table always
        # move together.
        from sparkrdma_tpu_torch.shuffle.tenancy import AdmissionController
        from sparkrdma_tpu_torch.utils import trace as trace_mod
        self.tracer = trace_mod.get(self.conf)
        self.admission = AdmissionController(
            self.conf.admission_max_inflight,
            self.conf.admission_queue_depth,
            self.conf.admission_retry_after_ms)
        self._tenants: Dict[int, int] = {}
        self._register_times: Dict[int, float] = {}
        self.gc_expired = 0  # audit: TTL-expired shuffles unregistered
        # driver HA (shuffle/ha.py): the replicated-state-machine plane.
        # The op log is armed when HA is configured or this endpoint was
        # promoted from a standby; _ha_lock (reentrant: logged mutations
        # nest — a replayed publish derives epoch bumps) serializes
        # {append, replicate-queue, apply, compact} so log order IS
        # apply order and a snapshot at seq S reflects every op <= S.
        self.incarnation = int(incarnation)
        ha_armed = (self.conf.ha_standbys > 0 or self.incarnation > 0
                    or lease_store is not None)
        self.oplog = (OpLog(self.incarnation,
                            self.conf.oplog_snapshot_every)
                      if ha_armed else None)
        self._ha_lock = threading.RLock()
        self._standbys: List[Tuple[str, str, int]] = []  # (name, host, port)
        self._standbys_lock = threading.Lock()
        self._replaying = False
        self._derived = threading.local()  # in-apply derived-mutation flag
        self.lease_store = lease_store
        self.lease_holder = lease_holder or f"driver-{os.getpid()}"
        self._lease_lost = threading.Event()
        self.ha_failovers_count = 0  # audit: takeovers this endpoint did
        # the server LAST: its accept thread dispatches hellos/joins the
        # moment the socket opens, and the handlers touch membership,
        # admission and tracer state — every field above must exist
        # before the first frame can arrive. A promoting standby hands
        # its OWN server in: its handler delegates here only after
        # promotion returns, so no frame reaches a half-built endpoint.
        if server is not None:
            self.server = server
        else:
            self.server = ControlServer(bind_host, self.conf.driver_port,
                                        self.conf, self._handle,
                                        name="driver")
        if restore is not None:
            self._restore(restore)
        self._lease_thread: Optional[threading.Thread] = None
        if self.lease_store is not None:
            ttl_s = self.conf.driver_lease_ms / 1000
            # a fresh primary claims its term; a promoted one already
            # holds it (try_acquire refuses term == current, harmlessly)
            self.lease_store.try_acquire(self.lease_holder,
                                         self.incarnation, ttl_s)
            self._lease_thread = threading.Thread(
                target=self._lease_loop, daemon=True, name="driver-lease")
            self._lease_thread.start()
        self._gc_thread: Optional[threading.Thread] = None
        if self.conf.shuffle_ttl_ms > 0:
            self._gc_thread = threading.Thread(
                target=self._gc_loop, daemon=True, name="driver-gc")
            self._gc_thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.host, self.server.port

    # -- driver HA: op log, snapshots, restore (shuffle/ha.py) -----------

    def _ha_apply(self, kind: int, payload: bytes, apply_fn):
        """Log one mutation, replicate it, apply it, maybe compact —
        one critical section. The append and its standby-stream push
        are queued BEFORE ``apply_fn`` runs (and so before any
        executor-facing push the apply queues): the broadcaster drains
        FIFO, so a standby holds the op before any executor observes
        its effect — the ordering the failover_vs_ttl_sweep model
        scenario depends on. Derived mutations inside the apply (epoch
        bumps a publish causes, tombstone fallout) see
        ``_derived.active`` and skip logging themselves: replay
        re-derives them from the logged cause."""
        if self.oplog is None or self._replaying:
            return apply_fn()
        with self._ha_lock:
            self._log_op(kind, payload)
            was = getattr(self._derived, "active", False)
            self._derived.active = True
            try:
                out = apply_fn()
            finally:
                self._derived.active = was
            self._maybe_compact()
            return out

    def _in_derived_apply(self) -> bool:
        return getattr(self._derived, "active", False)

    def _log_op(self, kind: int, payload: bytes) -> None:
        rec = self.oplog.append(kind, payload)
        with self._standbys_lock:
            standbys = list(self._standbys)
        for _name, h, p in standbys:
            self._queue_push((h, p), M.OpLogAppendMsg(
                rec.incarnation, rec.seq, rec.kind, rec.payload))

    def _maybe_compact(self) -> None:
        """Fold state into a snapshot every ``oplog_snapshot_every``
        ops. Runs AFTER the triggering op applied (inside _ha_lock), so
        the snapshot at seq S really contains every op <= S and the
        truncated tail loses nothing."""
        from sparkrdma_tpu_torch.shuffle import ha
        if not self.oplog.snapshot_due():
            return
        seq = self.oplog.last_seq()
        blob = ha.encode_snapshot(self.snapshot_state())
        self.oplog.install_snapshot(seq, blob)
        with self._standbys_lock:
            standbys = list(self._standbys)
        for _name, h, p in standbys:
            self._queue_push((h, p), M.SnapshotMsg(self.incarnation, seq,
                                                   blob))

    def snapshot_state(self) -> dict:
        """The replicated control-plane state as a plain dict (bytes
        leaves allowed — the ha snapshot codec base64s them). Size
        histograms are deliberately NOT carried: publishes after the
        snapshot re-feed them via the logged frames, and a post-failover
        plan built from a thinner histogram is still a valid plan (the
        planner degrades to coarser splits, never to an error)."""
        unix_now, mono_now = time.time(), time.monotonic()
        with self._tables_lock:
            shuffles = {}
            for sid, table in self._tables.items():
                plan = self._plans.get(sid)
                merged = self._merged.get(sid)
                tiered = self._tiered.get(sid)
                shuffles[str(sid)] = {
                    "num_maps": table.num_maps,
                    "num_partitions": self._num_partitions.get(sid, 0),
                    "tenant": self._tenants.get(sid, 0),
                    "epoch": self._epochs.get(sid, 1),
                    # wall-clock registration time: monotonic clocks
                    # don't travel between processes, and the promoted
                    # standby must re-derive the TTL sweep from the
                    # REPLICATED registration time (the no-resurrect
                    # invariant), not from its own replay instant
                    "reg_unix": unix_now - (mono_now
                                            - self._register_times.get(
                                                sid, mono_now)),
                    "table": table.to_bytes(),
                    "plan": (plan.to_bytes() if plan is not None
                             else None),
                    "merged": (merged.to_bytes() if merged is not None
                               else None),
                    "tiered": (tiered.to_bytes() if tiered is not None
                               else None),
                    "finalized": sid in self._finalize_sent,
                }
        members, states, epoch = self.membership.snapshot()
        return {"shuffles": shuffles,
                "membership": {"members": [m.serialize() for m in members],
                               "states": list(states),
                               "epoch": epoch}}

    def _restore(self, restore) -> None:
        """Replay ``(snapshot_blob | None, tail_records)`` into this
        endpoint, then re-broadcast the authoritative state under the
        new incarnation. Executor-facing pushes are suppressed during
        the replay (_queue_push drops them) — the takeover re-announce
        at the end is the one authoritative broadcast."""
        from sparkrdma_tpu_torch.shuffle import ha
        blob, tail = restore
        self._replaying = True  # analysis: unguarded-ok(restore runs in __init__ before the server dispatches any handler thread)
        try:
            if blob:
                self._load_snapshot(ha.decode_snapshot(blob))
            for rec in sorted(tail, key=lambda r: (r.incarnation, r.seq)):
                try:
                    self._apply_op(rec)
                except Exception:  # noqa: BLE001 — one bad op must not
                    # strand the takeover; the rebased re-announce below
                    # still invalidates every stale cache
                    log.exception("driver restore: op (%d,%d) kind %d "
                                  "failed", rec.incarnation, rec.seq,
                                  rec.kind)
        finally:
            self._replaying = False  # analysis: unguarded-ok(still inside __init__, single-threaded)
        # seed OUR log with a complete snapshot at seq 0: a standby
        # registering before the first compaction must receive the
        # restored state, or a second failover would lose it
        self.oplog.install_snapshot(0, ha.encode_snapshot(
            self.snapshot_state()))
        self._announce_takeover()

    def _load_snapshot(self, state: dict) -> None:
        from sparkrdma_tpu_torch.shuffle.push_merge import MergedDirectory
        from sparkrdma_tpu_torch.shuffle.planner import ReducePlan
        from sparkrdma_tpu_torch.shuffle.tenancy import AdmissionRejected
        unix_now, mono_now = time.time(), time.monotonic()
        mem = state.get("membership", {})
        if mem.get("members"):
            members = []
            for raw in mem["members"]:
                mid, _ = ShuffleManagerId.deserialize(raw)
                members.append(mid)
            self.membership.restore(members, list(mem.get("states", [])),
                                    int(mem.get("epoch", 0)))
        for key, s in state.get("shuffles", {}).items():
            sid = int(key)
            tenant = int(s.get("tenant", 0))
            try:
                self.admission.admit(tenant, sid)
            except AdmissionRejected:
                # config drift between primaries; the shuffle EXISTS, so
                # restore it anyway — admission re-converges on its next
                # unregister
                log.warning("driver restore: admission rejected restored "
                            "shuffle %d (tenant %d); restoring anyway",
                            sid, tenant)
            with self._tables_lock:
                self._tables[sid] = DriverTable.from_bytes(s["table"])
                self._epochs[sid] = int(s.get("epoch", 1))
                self._num_partitions[sid] = int(s.get("num_partitions", 0))
                self._tenants[sid] = tenant
                age = max(0.0, unix_now - float(s.get("reg_unix",
                                                      unix_now)))
                self._register_times[sid] = mono_now - age
                if s.get("plan") is not None:
                    self._plans[sid] = ReducePlan.from_bytes(s["plan"])
                if s.get("merged") is not None:
                    self._merged[sid] = MergedDirectory.from_bytes(
                        s["merged"])
                if s.get("tiered") is not None:
                    from sparkrdma_tpu_torch.shuffle.cold_tier import \
                        TieredDirectory
                    self._tiered[sid] = TieredDirectory.from_bytes(
                        s["tiered"])
                if s.get("finalized"):
                    self._finalize_sent.add(sid)
                if self.conf.adaptive_plan and sid not in self._size_hists:
                    from sparkrdma_tpu_torch.shuffle.planner import SizeHistogram
                    self._size_hists[sid] = SizeHistogram(
                        int(s["num_maps"]), int(s.get("num_partitions",
                                                      0)))

    def _apply_op(self, rec) -> None:
        """Replay one op record (``_replaying`` is set: handlers mutate
        but push nothing). OP_WIRE replays the encoded frame through the
        normal dispatch — fence floors and epoch guards make an op the
        snapshot already contains a no-op, which is what the replay
        idempotency tests pin."""
        from sparkrdma_tpu_torch.shuffle import ha
        if rec.kind == ha.OP_WIRE:
            try:
                msg = decode_message(rec.payload)
            except ValueError:
                log.warning("driver restore: undecodable wire op (%d,%d)",
                            rec.incarnation, rec.seq)
                return
            self._handle(None, msg)
        elif rec.kind == ha.OP_REGISTER:
            sid, num_maps, num_partitions, tenant, reg_unix = \
                ha.unpack_register(rec.payload)
            self.register_shuffle(sid, num_maps, num_partitions, tenant)
            with self._tables_lock:
                if sid in self._register_times:
                    age = max(0.0, time.time() - reg_unix)
                    self._register_times[sid] = time.monotonic() - age
        elif rec.kind == ha.OP_UNREGISTER:
            self.unregister_shuffle(ha.unpack_sid(rec.payload))
        elif rec.kind == ha.OP_BUMP:
            self.bump_epoch(ha.unpack_sid(rec.payload),
                            reason="replayed bump")
        elif rec.kind == ha.OP_TOMBSTONE:
            mid, _ = ShuffleManagerId.deserialize(rec.payload)
            self.remove_member(mid)
        elif rec.kind == ha.OP_DRAIN:
            slot, step = ha.unpack_drain(rec.payload)
            self.drain_transition(slot, step)
        elif rec.kind == ha.OP_PLAN:
            from sparkrdma_tpu_torch.shuffle.planner import ReducePlan
            plan = ReducePlan.from_bytes(rec.payload)
            self._install_plan(plan.shuffle_id, plan)
        elif rec.kind == ha.OP_FINALIZE:
            self.finalize_merge(ha.unpack_sid(rec.payload))
        else:
            log.warning("driver restore: unknown op kind %d", rec.kind)

    def _announce_takeover(self) -> None:
        """The promoted primary's one authoritative re-broadcast:
        membership snapshot, every live shuffle's location epoch rebased
        into the new incarnation, the newest plans, re-finalize triggers
        (merge targets idempotently re-publish segments the op-log lag
        window may have missed), and the TakeoverMsg that re-points
        every executor's DriverClient."""
        from sparkrdma_tpu_torch.shuffle.ha import rebase_epoch
        inc = self.incarnation
        # TTL re-derive FIRST, from the replicated registration clocks:
        # a restored-but-expired shuffle dies (ordinary EPOCH_DEAD push)
        # before any re-broadcast could resurrect it at a reducer
        self.gc_sweep()
        # the takeover pointer leads the queue so executor retries
        # re-aim before the state pushes land behind it
        self._queue_push(None, M.TakeoverMsg(inc, self.server.host,
                                             self.server.port))
        members, states, mepoch = self.membership.snapshot()
        mepoch = self.membership.rebase_epoch(rebase_epoch(mepoch, inc))
        self.publish_membership(members, states, mepoch)
        with self._tables_lock:
            sids = sorted(self._tables)
            plans = {}
            for sid in sids:
                self._epochs[sid] = rebase_epoch(self._epochs[sid], inc)
                plan = self._plans.get(sid)
                if plan is not None:
                    plan = dataclasses.replace(
                        plan, plan_epoch=rebase_epoch(plan.plan_epoch,
                                                      inc))
                    self._plans[sid] = plan
                    plans[sid] = plan.to_bytes()
            epochs = {sid: self._epochs[sid] for sid in sids}
            refinalize = [sid for sid in sids
                          if sid in self._finalize_sent]
        for sid in sids:
            self._queue_push(None, M.EpochBumpMsg(sid, epochs[sid]))
        for sid in sids:
            if sid in plans:
                self._queue_push(None, M.ReducePlanMsg(plans[sid]))
        for sid in refinalize:
            self._queue_push(None, M.FinalizeSegmentsReq(0, sid))
        self.ha_failovers_count += 1
        log.warning("driver: incarnation %d serving — %d shuffles "
                    "restored, membership epoch %d re-announced", inc,
                    len(sids), mepoch)

    def _on_standby_hello(self, msg: "M.StandbyHelloMsg") -> None:
        """Register (or re-register) a standby and queue its catch-up:
        the newest snapshot plus the whole tail. The standby dedupes by
        (incarnation, seq), so over-sending is harmless; under-sending
        would strand it cold."""
        if self.oplog is None:
            log.warning("driver: standby hello from %s with HA off "
                        "(set ha_standbys > 0)", msg.name)
            return
        addr = (msg.host, msg.port)
        with self._standbys_lock:
            self._standbys = ([s for s in self._standbys
                               if s[0] != msg.name]
                              + [(msg.name, msg.host, msg.port)])
        with self._ha_lock:
            snap = self.oplog.snapshot()
            blob, tail = self.oplog.restore_point()
            if blob is not None:
                self._queue_push(addr, M.SnapshotMsg(self.incarnation,
                                                     snap[0], blob))
            for rec in tail:
                if rec.seq > msg.last_seq or blob is not None:
                    self._queue_push(addr, M.OpLogAppendMsg(
                        rec.incarnation, rec.seq, rec.kind, rec.payload))
        log.info("driver: standby %s registered at %s:%d (caught up "
                 "from seq %d)", msg.name, msg.host, msg.port,
                 msg.last_seq)

    def _lease_loop(self) -> None:
        """Renew the leadership lease at a quarter TTL. The instant a
        renew fails a higher term exists — we are the zombie: go mute
        (stop the broadcaster) so no further push leaves this endpoint.
        Everything already in flight is fenced by incarnation at every
        receiver; muting just stops paying for doomed sends."""
        ttl_s = self.conf.driver_lease_ms / 1000
        period = max(0.01, ttl_s / 4)
        while not self._announce_stop and not self._lease_lost.is_set():
            if not self.lease_store.renew(self.lease_holder,
                                          self.incarnation, ttl_s):
                self._lease_lost.set()
                log.warning("driver: lease lost at incarnation %d — a "
                            "newer primary exists; muting broadcasts",
                            self.incarnation)
                with self._announce_cond:
                    self._announce_stop = True
                    self._announce_cond.notify()
                return
            self._lease_lost.wait(period)

    def deposed(self) -> bool:
        """True once this endpoint observed a higher lease term (tests
        and the chaos harness poll this)."""
        return self._lease_lost.is_set()

    def drain_transition(self, slot: int, step: int):
        """The logged form of the three membership drain mutations
        (``ha.DRAIN_BEGIN/ABORT/RETIRE``) — drain_slot and abort_drain
        route through here so a failover mid-drain replays to the same
        slot states."""
        from sparkrdma_tpu_torch.shuffle import ha
        mutators = {ha.DRAIN_BEGIN: self.membership.begin_drain,
                    ha.DRAIN_ABORT: self.membership.abort_drain,
                    ha.DRAIN_RETIRE: self.membership.retire}
        base_fn = mutators[step]

        def apply_fn(s: int):
            res = base_fn(s)
            if res is not None and step == ha.DRAIN_BEGIN:
                # a draining OWNER hands its shards off NOW, not at the
                # eventual tombstone: the drain exists to walk work off
                # the host, and a fence-CAS range it still owned would
                # re-pin every publish in its map-range to it
                self._shard_handoff(s, reason="drain")
            return res

        if self.oplog is not None and not self._replaying:
            return self._ha_apply(ha.OP_DRAIN, ha.op_drain(slot, step),
                                  lambda: apply_fn(slot))
        return apply_fn(slot)

    # -- shuffle registry (driver side of registerShuffle) ---------------

    def register_shuffle(self, shuffle_id: int, num_maps: int,
                         num_partitions: int = 0,
                         tenant: int = 0) -> None:
        """Allocate the per-shuffle map-output table
        (scala/RdmaShuffleManager.scala:168-172) at epoch 1, and — with
        ``metadata_shards`` on — assign map-range shards over the live
        members and push the assignment so reducers aim cold-path table
        syncs at shard hosts instead of the driver. With
        ``adaptive_plan`` on, a :class:`~.planner.SizeHistogram` is
        allocated too (fed by the lengths riding each publish).

        ``tenant`` mints the owning tenant: admission control gates
        here (queue-or-reject past the per-tenant in-flight cap — see
        ``admission_max_inflight``) and the mapping is pushed to every
        executor as a TenantMapMsg so serve-path fair share and quota
        ledgers charge the right owner."""
        from sparkrdma_tpu_torch.shuffle import ha
        if self.oplog is not None and not self._replaying:
            return self._ha_apply(
                ha.OP_REGISTER,
                ha.op_register(shuffle_id, num_maps, num_partitions,
                               tenant, time.time()),
                lambda: self._register_impl(shuffle_id, num_maps,
                                            num_partitions, tenant))
        return self._register_impl(shuffle_id, num_maps, num_partitions,
                                   tenant)

    def _register_impl(self, shuffle_id: int, num_maps: int,
                       num_partitions: int = 0, tenant: int = 0) -> None:
        from sparkrdma_tpu_torch.shuffle.ha import compose_epoch
        from sparkrdma_tpu_torch.shuffle.location_plane import ShardMap

        def admit_event(kind: str, t: int, waited_ms: int) -> None:
            # literal names: the trace registry's drift lint rejects
            # computed emission names by design
            if kind == "accept":
                self.tracer.instant("admit.accept", "tenant",
                                    shuffle=shuffle_id, tenant=t,
                                    waited_ms=waited_ms)
            elif kind == "queue":
                self.tracer.instant("admit.queue", "tenant",
                                    shuffle=shuffle_id, tenant=t)
            else:
                self.tracer.instant("admit.reject", "tenant",
                                    shuffle=shuffle_id, tenant=t,
                                    waited_ms=waited_ms)

        # elastic capacity: the fleet present at the FIRST register is
        # the baseline admission was sized for; from here every
        # membership change rescales the cap/retry hints (set_fleet)
        if self.membership.freeze_baseline():
            self._update_admission_fleet()
        # may raise AdmissionRejected (retry-after hint attached); an
        # admitted-then-duplicate register releases its slot below
        self.admission.admit(tenant, shuffle_id, on_event=admit_event)
        shard_map = None
        with self._tables_lock:
            if shuffle_id in self._tables:
                # a duplicate register under a DIFFERENT tenant id just
                # added the shuffle to that tenant's inflight set, and
                # on_unregister will only ever release the RECORDED
                # owner's slot — release the stray one (outside the
                # table lock, matching unregister's lock order)
                stray = self._tenants.get(shuffle_id, 0) != tenant
            else:
                stray = None
        if stray is not None:
            if stray:
                self.admission.on_unregister(tenant, shuffle_id)
            return
        with self._tables_lock:
            if shuffle_id in self._tables:
                # lost a same-sid register race since the check above:
                # same stray-slot rule as the fast duplicate path
                if self._tenants.get(shuffle_id, 0) != tenant:
                    self.admission.on_unregister(tenant, shuffle_id)
                return
            self._tables[shuffle_id] = DriverTable(num_maps)
            # epoch 1 of THIS incarnation: identical to the pre-HA 1 at
            # incarnation 0; after a failover, strictly above anything
            # the previous incarnation ever published for a reused id
            self._epochs[shuffle_id] = compose_epoch(self.incarnation, 1)
            self._num_partitions[shuffle_id] = num_partitions
            self._tenants[shuffle_id] = int(tenant)
            self._register_times[shuffle_id] = time.monotonic()
            if self.conf.adaptive_plan:
                from sparkrdma_tpu_torch.shuffle.planner import SizeHistogram
                self._size_hists[shuffle_id] = SizeHistogram(
                    num_maps, num_partitions)
            if self.conf.metadata_shards > 0:
                # shard hosts come from PLACEABLE membership: assign
                # consults the plane directly, so a draining slot —
                # about to leave — can never adopt a replica or (in
                # ownership mode) a fence-CAS range
                shard_map = ShardMap.assign(num_maps, self.membership,
                                            self.conf.metadata_shards)
                if shard_map is not None:
                    shard_gen = compose_epoch(self.incarnation, 1)
                    self._shard_maps[shuffle_id] = (shard_map, shard_gen)
        if shard_map is not None:
            self._queue_push(None, M.ShardMapMsg(
                shuffle_id, shard_gen, num_maps, shard_map.shard_slots))
        if tenant != 0:
            # teach executors the owner (serve-path fair share, cache
            # charging). Skipped for the default tenant so pre-tenancy
            # deployments put ZERO new frames on the wire — TTL alone
            # needs no push (only the driver enforces it; expiry
            # arrives as the ordinary EPOCH_DEAD).
            self._queue_push(None, M.TenantMapMsg(
                shuffle_id, int(tenant), self.conf.shuffle_ttl_ms))

    def unregister_shuffle(self, shuffle_id: int) -> None:
        from sparkrdma_tpu_torch.shuffle import ha
        if self.oplog is not None and not self._replaying:
            # log-before-push discipline: the standby stream holds the
            # unregister before any executor can observe the EPOCH_DEAD
            # it causes, so a takeover can never resurrect a shuffle a
            # reducer already saw die
            return self._ha_apply(ha.OP_UNREGISTER, ha.op_sid(shuffle_id),
                                  lambda: self._unregister_impl(shuffle_id))
        return self._unregister_impl(shuffle_id)

    def _unregister_impl(self, shuffle_id: int) -> None:
        with self._tables_lock:
            known = self._tables.pop(shuffle_id, None) is not None
            self._epochs.pop(shuffle_id, None)
            self._shard_maps.pop(shuffle_id, None)
            self._size_hists.pop(shuffle_id, None)
            self._plans.pop(shuffle_id, None)
            self._num_partitions.pop(shuffle_id, None)
            self._merged.pop(shuffle_id, None)
            self._tiered.pop(shuffle_id, None)
            self._finalize_sent.discard(shuffle_id)
            tenant = self._tenants.pop(shuffle_id, 0)
            self._register_times.pop(shuffle_id, None)
        if known:
            # free the tenant's admission slot (wakes queued registers)
            self.admission.on_unregister(tenant, shuffle_id)
        # unblock long-pollers: the shuffle is gone, answer "unknown"
        with self._waiters_lock:
            waiters = self._waiters.pop(shuffle_id, [])
        for conn, req_id, _, _ in waiters:
            self._answer_waiter(conn, M.FetchTableResp(req_id, -1, b"",
                                                       M.EPOCH_DEAD))
        if known:
            # terminal push: caches (location views, warm partitions,
            # shard replicas) drop the shuffle instead of re-validating
            # against a version that will never exist again
            self._queue_push(None, M.EpochBumpMsg(shuffle_id,
                                                  M.EPOCH_DEAD))

    def epoch_of(self, shuffle_id: int) -> Optional[int]:
        """The shuffle's current location-state version (None =
        unregistered)."""
        with self._tables_lock:
            return self._epochs.get(shuffle_id)

    # -- tenancy (shuffle/tenancy.py) ------------------------------------

    def tenant_of(self, shuffle_id: int) -> int:
        with self._tables_lock:
            return self._tenants.get(shuffle_id, 0)

    def _touch_locked(self, shuffle_id: int) -> None:
        """Refresh the shuffle's TTL clock (caller holds _tables_lock):
        the TTL is an IDLE bound, not a registration-age bound — a
        publish or driver table sync proves the job is alive, so the
        GC sweep reaps only shuffles no one has touched for a full
        TTL. Warm iterative jobs that issue zero driver RPCs by design
        should size shuffle_ttl_ms above their run or disable it."""
        if self._replaying:
            # Failover replay must not freshen TTL clocks: the restored
            # reg_unix already carries the true idle age, and replayed
            # publishes are history, not fresh liveness proof.
            return
        if shuffle_id in self._register_times:
            self._register_times[shuffle_id] = time.monotonic()

    def live_shuffles(self) -> List[int]:
        """Registered shuffle ids (the GC sweep's authoritative live
        set — ``manager.gc_orphans`` feeds it to executors)."""
        with self._tables_lock:
            return sorted(self._tables)

    def active_tenant_count(self) -> int:
        """Distinct tenants holding registered shuffles (>= 1): the
        divisor for the even-share HBM/cache sizing."""
        with self._tables_lock:
            return max(1, len(set(self._tenants.values()) or {0}))

    def gc_sweep(self, now: Optional[float] = None) -> List[int]:
        """Unregister shuffles idle (no publish, no table sync) longer
        than ``shuffle_ttl_ms`` (ROADMAP item 1's shuffle TTL/GC). The
        terminal EPOCH_DEAD push makes every executor reap the
        shuffle's committed outputs, merged segments and overflow blobs
        from disk. Returns the expired ids (the GC thread calls this on
        a ttl/4 cadence; public for deterministic tests)."""
        ttl_s = self.conf.shuffle_ttl_ms / 1000
        if ttl_s <= 0:
            return []
        now = time.monotonic() if now is None else now
        with self._tables_lock:
            expired = [sid for sid, t0 in self._register_times.items()
                       if now - t0 > ttl_s]
        for sid in expired:
            self.tracer.instant("admit.expire", "tenant", shuffle=sid,
                                tenant=self.tenant_of(sid))
            log.info("driver GC: shuffle %d exceeded its %dms TTL",
                     sid, self.conf.shuffle_ttl_ms)
            self.unregister_shuffle(sid)
            self.gc_expired += 1
        return expired

    def _gc_loop(self) -> None:
        period = max(0.05, self.conf.shuffle_ttl_ms / 4000)
        while not self.server.stopped:
            time.sleep(period)
            try:
                self.gc_sweep()
            except Exception:  # noqa: BLE001 — the sweeper must live
                log.exception("shuffle TTL sweep failed")

    def bump_epoch(self, shuffle_id: int, reason: str = "") -> Optional[int]:
        """Advance one shuffle's epoch and push the invalidation. The
        driver calls this itself on repair publishes and tombstones
        (DERIVED bumps — replay re-derives them from the logged cause,
        so only out-of-band calls log their own OP_BUMP); public for
        engines that learn of staleness out of band."""
        from sparkrdma_tpu_torch.shuffle import ha
        if (self.oplog is not None and not self._replaying
                and not self._in_derived_apply()):
            return self._ha_apply(ha.OP_BUMP, ha.op_sid(shuffle_id),
                                  lambda: self._bump_impl(shuffle_id,
                                                          reason))
        return self._bump_impl(shuffle_id, reason)

    def _bump_impl(self, shuffle_id: int, reason: str = "") -> Optional[int]:
        with self._tables_lock:
            if shuffle_id not in self._epochs:
                return None
            self._epochs[shuffle_id] += 1
            epoch = self._epochs[shuffle_id]
        self.epoch_bumps += 1
        log.info("driver: epoch bump shuffle %d -> %d%s", shuffle_id,
                 epoch, f" ({reason})" if reason else "")
        self._queue_push(None, M.EpochBumpMsg(shuffle_id, epoch))
        return epoch

    # -- adaptive reduce planning (shuffle/planner.py) -------------------

    def size_histogram(self, shuffle_id: int):
        """The shuffle's SizeHistogram (None when adaptive planning is
        off or the shuffle is unregistered)."""
        with self._tables_lock:
            return self._size_hists.get(shuffle_id)

    def reduce_plan(self, shuffle_id: int):
        """The current published ReducePlan, or None."""
        with self._tables_lock:
            return self._plans.get(shuffle_id)

    def _plan_inputs(self, shuffle_id: int):
        """(hist, owners, live_slots, avoid_slots) for plan
        construction, or None. ``live_slots`` keeps DRAINING members —
        their bytes still count for locality accounting and split
        bounds — while ``avoid_slots`` names them so placement steers
        new reduce work onto slots that will outlive the stage."""
        with self._tables_lock:
            hist = self._size_hists.get(shuffle_id)
            table = self._tables.get(shuffle_id)
        if hist is None or table is None:
            return None
        owners = {}
        for m in range(table.num_maps):
            entry = table.entry(m)
            if entry is not None:
                owners[m] = entry[1]
        live = self.membership.live_slots(include_draining=True)
        avoid = self.membership.draining_slots()
        return hist, owners, live, avoid

    def build_reduce_plan(self, shuffle_id: int, tracer=None):
        """Build (or rebuild) the shuffle's ReducePlan from the size
        histogram at map-stage completion and PUSH it on the broadcast
        channel — the plan is a one-sided, driver-published artifact
        like the location tables. Returns the plan, or None when
        adaptive planning is off / the shuffle is unknown / no sizes
        ever arrived (mixed-version executors): callers fall back to
        the identity plan, so a size-less cluster degrades to today's
        behavior, never to an error."""
        from sparkrdma_tpu_torch.shuffle.planner import ReducePlanner
        if self.conf.shard_ownership and self.conf.metadata_shards > 0:
            # owner-batch convergence is asynchronous (bounded by the
            # executors' flush interval): planning at map-stage
            # completion must not read the histogram mid-echo, so wait
            # — briefly, bounded — for the table to reach its map count
            with self._tables_lock:
                table = self._tables.get(shuffle_id)
            if table is not None:
                deadline = time.monotonic() + 0.5
                while (table.num_published < table.num_maps
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
        inputs = self._plan_inputs(shuffle_id)
        if inputs is None:
            return None
        hist, owners, live, avoid = inputs
        if hist.maps_recorded == 0 or hist.num_partitions == 0:
            return None
        from sparkrdma_tpu_torch.shuffle.ha import compose_epoch
        with self._tables_lock:
            prev = self._plans.get(shuffle_id)
        epoch = (prev.plan_epoch + 1 if prev is not None
                 else compose_epoch(self.incarnation, 1))
        plan = ReducePlanner(self.conf).plan(shuffle_id, hist, owners,
                                             live, plan_epoch=epoch,
                                             tracer=tracer,
                                             avoid_slots=avoid)
        if not self._install_plan(shuffle_id, plan):
            return None  # unregistered while planning
        log.info("driver: reduce plan shuffle %d epoch %d: %s",
                 shuffle_id, plan.plan_epoch, plan.counts())
        return plan

    def _install_plan(self, shuffle_id: int, plan) -> bool:
        """Install + push one plan, logged as OP_PLAN (the plan BYTES
        are authoritative — replay installs rather than re-deriving, so
        a failover preserves the exact task layout reducers hold)."""
        from sparkrdma_tpu_torch.shuffle import ha

        def apply() -> bool:
            with self._tables_lock:
                if shuffle_id not in self._tables:
                    return False
                self._plans[shuffle_id] = plan
            self._queue_push(None, M.ReducePlanMsg(plan.to_bytes()))
            return True

        if (self.oplog is not None and not self._replaying
                and not self._in_derived_apply()):
            return self._ha_apply(ha.OP_PLAN, plan.to_bytes(), apply)
        return apply()

    def replan_reduce(self, shuffle_id: int, completed_task_ids,
                      dead_slot: int = -1, tracer=None):
        """Mid-stage re-plan after an executor loss: surviving reducers
        keep their completed ranges; only ORPHANED tasks (incomplete,
        placed on a slot that is dead or tombstoned) re-assign to live
        slots, under a bumped plan epoch, pushed like the original."""
        from sparkrdma_tpu_torch.shuffle.planner import ReducePlanner
        with self._tables_lock:
            plan = self._plans.get(shuffle_id)
        if plan is None:
            return None
        inputs = self._plan_inputs(shuffle_id)
        if inputs is None:
            return None
        hist, owners, live, avoid = inputs
        if dead_slot >= 0:
            live = [s for s in live if s != dead_slot]
        if not live:
            return None
        new_plan = ReducePlanner(self.conf).replan(
            plan, hist, owners, live, completed_task_ids, tracer=tracer,
            avoid_slots=avoid)
        if not self._install_plan(shuffle_id, new_plan):
            return None
        self.plan_replans += 1
        log.info("driver: reduce RE-plan shuffle %d epoch %d (dead slot "
                 "%d)", shuffle_id, new_plan.plan_epoch, dead_slot)
        return new_plan

    def _on_fetch_plan(self, msg: "M.FetchPlanReq") -> RpcMsg:
        with self._tables_lock:
            known = msg.shuffle_id in self._tables
            plan = self._plans.get(msg.shuffle_id)
        if plan is not None:
            return M.FetchPlanResp(msg.req_id, M.STATUS_OK,
                                   plan.to_bytes())
        return M.FetchPlanResp(
            msg.req_id,
            M.STATUS_ERROR if known else M.STATUS_UNKNOWN_SHUFFLE, b"")

    # -- push-merge directory (shuffle/push_merge.py) --------------------

    def _on_merged_publish(self, msg: "M.MergedPublishMsg") -> None:
        """Apply one finalized merged segment into the directory —
        one-sided like a location publish; problems log driver-side."""
        from sparkrdma_tpu_torch.shuffle.push_merge import (MergedDirectory,
                                                      MergedEntry)
        with self._tables_lock:
            # zombie guard: a finalize publish from a slot tombstoned
            # while the message was in flight must not re-enter the
            # directory — on_slot_dead already pruned that slot, and a
            # resurrected entry would serve to reducers stamped with
            # the POST-bump epoch (the modelcheck merged-live
            # invariant). Checked INSIDE _tables_lock: remove_member
            # tombstones the slot before on_slot_dead takes this lock
            # for the prune, so a publish that saw the slot live here
            # applies before the prune, never after it. (The nesting
            # _tables_lock -> membership._lock matches the register
            # path; nothing nests the other way.)
            members = self.membership.members()
            if (0 <= msg.exec_index < len(members)
                    and members[msg.exec_index] == TOMBSTONE):
                self.merged_zombie_drops += 1
                log.info("driver: dropped merged publish from DEAD "
                         "slot %d for shuffle %d", msg.exec_index,
                         msg.shuffle_id)
                return
            table = self._tables.get(msg.shuffle_id)
            if table is None:
                log.warning("driver: merged publish for unknown shuffle "
                            "%d", msg.shuffle_id)
                return
            parts = self._num_partitions.get(msg.shuffle_id, 0)
            if parts and not 0 <= msg.partition_id < parts:
                log.warning("driver: merged publish with bad partition "
                            "%d for shuffle %d", msg.partition_id,
                            msg.shuffle_id)
                return
            directory = self._merged.get(msg.shuffle_id)
            if directory is None:
                directory = MergedDirectory()
                self._merged[msg.shuffle_id] = directory
            directory.apply(MergedEntry(
                msg.partition_id, msg.exec_index, msg.token, msg.nbytes,
                msg.crc32, msg.covered, msg.ranges))
            self.merged_publishes += 1

    def _on_fetch_merged(self, msg: "M.FetchMergedReq") -> RpcMsg:
        with self._tables_lock:
            known = msg.shuffle_id in self._tables
            epoch = self._epochs.get(msg.shuffle_id, 0)
            directory = self._merged.get(msg.shuffle_id)
            data = directory.to_bytes() if directory is not None else b""
        if not known:
            return M.FetchMergedResp(msg.req_id, M.STATUS_UNKNOWN_SHUFFLE,
                                     M.EPOCH_DEAD, b"")
        return M.FetchMergedResp(msg.req_id, M.STATUS_OK, epoch, data)

    def merged_directory(self, shuffle_id: int):
        """Snapshot of the shuffle's merged directory (tests/benches
        poll this for coverage; None = nothing published yet)."""
        from sparkrdma_tpu_torch.shuffle.push_merge import MergedDirectory
        with self._tables_lock:
            directory = self._merged.get(shuffle_id)
            return (MergedDirectory.from_bytes(directory.to_bytes())
                    if directory is not None else None)

    def merged_covering(self, shuffle_id: int, maps, exclude_slot: int = -1
                        ) -> set:
        """Which of ``maps`` have EVERY reduce partition covered by the
        merged entry a retrying reducer will actually SELECT — the
        re-point set of recovery: these maps need no re-execution.

        This mirrors the fetcher's resolution exactly (one entry per
        partition: widest live coverage, slot tie-break — a segment's
        bytes cannot be sliced per map, so a reducer consumes at most
        ONE entry per partition and coverage must be judged against
        that entry, not the union over replicas; a union answer could
        re-point a map the chosen entry doesn't carry and strand the
        retry on the dead owner)."""
        from sparkrdma_tpu_torch.shuffle.push_merge import MergedDirectory
        with self._tables_lock:
            live_dir = self._merged.get(shuffle_id)
            parts = self._num_partitions.get(shuffle_id, 0)
            # snapshot under the lock: late finalize publishes and
            # tombstone pruning mutate the live directory concurrently
            directory = (MergedDirectory.from_bytes(live_dir.to_bytes())
                         if live_dir is not None else None)
        if directory is None or parts <= 0:
            return set()
        members = self.membership.members()

        def live(slot: int) -> bool:
            return (slot != exclude_slot and slot < len(members)
                    and members[slot] != TOMBSTONE)

        chosen = []
        for p in range(parts):
            entries = [e for e in directory.entries(p) if live(e.slot)]
            chosen.append(entries[0] if entries else None)
        covered = set()
        for m in maps:
            if all(e is not None and e.covers(m) for e in chosen):
                covered.add(m)
        return covered

    # -- cold-tier directory (shuffle/cold_tier.py) ----------------------

    def _on_tiered_publish(self, msg: "M.TieredPublishMsg") -> None:
        """Apply one cold-tier blob into the directory — one-sided like
        a merged publish, but with NO zombie-slot guard: a blob
        uploaded by a since-tombstoned executor is still durable and
        still serves (blobs have no owner to die). Unknown-shuffle and
        bad-partition guards stay."""
        from sparkrdma_tpu_torch.shuffle.cold_tier import (TieredDirectory,
                                                     TieredEntry)
        with self._tables_lock:
            table = self._tables.get(msg.shuffle_id)
            if table is None:
                log.warning("driver: tiered publish for unknown shuffle "
                            "%d", msg.shuffle_id)
                return
            parts = self._num_partitions.get(msg.shuffle_id, 0)
            if parts and not 0 <= msg.partition_id < parts:
                log.warning("driver: tiered publish with bad partition "
                            "%d for shuffle %d", msg.partition_id,
                            msg.shuffle_id)
                return
            table_maps = table.num_maps
            from sparkrdma_tpu_torch.shuffle.push_merge import bitmap_get
            if any(bitmap_get(msg.covered, m)
                   and (msg.shuffle_id, m) in self._tiered_superseded
                   for m in range(table_maps)):
                # the blob holds a repair-superseded attempt's bytes:
                # the upload started before the repair landed, the
                # publish arrived after drop_map pruned the directory —
                # letting it in would resurrect the stale coverage
                self.tiered_stale_drops += 1
                log.info("driver: dropped tiered publish of superseded "
                         "map for shuffle %d partition %d",
                         msg.shuffle_id, msg.partition_id)
                return
            directory = self._tiered.get(msg.shuffle_id)
            if directory is None:
                directory = TieredDirectory()
                self._tiered[msg.shuffle_id] = directory
            directory.apply(TieredEntry(
                msg.partition_id, msg.blob_key, msg.nbytes, msg.crc32,
                msg.covered))
            self.tiered_publishes += 1

    def _on_fetch_tiered(self, msg: "M.FetchTieredReq") -> RpcMsg:
        with self._tables_lock:
            known = msg.shuffle_id in self._tables
            epoch = self._epochs.get(msg.shuffle_id, 0)
            directory = self._tiered.get(msg.shuffle_id)
            data = directory.to_bytes() if directory is not None else b""
        if not known:
            return M.FetchTieredResp(msg.req_id, M.STATUS_UNKNOWN_SHUFFLE,
                                     M.EPOCH_DEAD, b"")
        return M.FetchTieredResp(msg.req_id, M.STATUS_OK, epoch, data)

    def tiered_directory(self, shuffle_id: int):
        """Snapshot of the shuffle's tiered directory (tests/benches
        poll this for coverage; None = nothing tiered yet)."""
        from sparkrdma_tpu_torch.shuffle.cold_tier import TieredDirectory
        with self._tables_lock:
            directory = self._tiered.get(shuffle_id)
            return (TieredDirectory.from_bytes(directory.to_bytes())
                    if directory is not None else None)

    def tiered_covering(self, shuffle_id: int, maps) -> set:
        """Which of ``maps`` have EVERY reduce partition covered by the
        cold tier — recovery's second re-point set, checked after
        ``merged_covering``: these maps need no re-execution even when
        no live replica holds them. Coverage is judged against the
        UNION of a partition's blob entries (unlike merged: a reducer
        can restore several blobs per partition — whole-segment blobs
        and per-map drain rows compose), and there is no liveness
        filter — blobs have no owner to exclude."""
        from sparkrdma_tpu_torch.shuffle.cold_tier import TieredDirectory
        with self._tables_lock:
            live_dir = self._tiered.get(shuffle_id)
            parts = self._num_partitions.get(shuffle_id, 0)
            directory = (TieredDirectory.from_bytes(live_dir.to_bytes())
                         if live_dir is not None else None)
        if directory is None or parts <= 0:
            return set()
        covered = set()
        for m in maps:
            if all(directory.covering(m, p) for p in range(parts)):
                covered.add(m)
        return covered

    def finalize_merge(self, shuffle_id: int) -> None:
        """Broadcast the finalize trigger for one shuffle's merge
        targets (also queued automatically when the last map publishes;
        targets finalize idempotently)."""
        from sparkrdma_tpu_torch.shuffle import ha

        def apply() -> None:
            with self._tables_lock:
                if shuffle_id in self._finalize_sent:
                    return
                self._finalize_sent.add(shuffle_id)
            self._queue_push(None, M.FinalizeSegmentsReq(0, shuffle_id))

        with self._tables_lock:
            if shuffle_id in self._finalize_sent:
                return  # cheap pre-check: no op logged for a duplicate
        if (self.oplog is not None and not self._replaying
                and not self._in_derived_apply()):
            return self._ha_apply(ha.OP_FINALIZE, ha.op_sid(shuffle_id),
                                  apply)
        return apply()

    def refinalize_merge(self, shuffle_id: int) -> None:
        """Re-broadcast the finalize trigger: drain re-pushes REOPEN
        already-sealed segments on their targets, and the new rows only
        publish into the merged directory on a fresh finalize. Only
        shuffles whose map stage is COMPLETE re-finalize — sealing a
        mid-stage shuffle early would shed every later background push
        (membership.drain_slot documents the mid-map-stage fallback)."""
        if not self.conf.push_merge:
            return
        with self._tables_lock:
            table = self._tables.get(shuffle_id)
            if table is None or table.num_published < table.num_maps:
                return
            self._finalize_sent.discard(shuffle_id)
        self.finalize_merge(shuffle_id)

    def map_entry(self, shuffle_id: int, map_id: int):
        """Current (token, exec_index) for one map, or None (unpublished
        OR unknown shuffle — use :meth:`has_shuffle` to tell apart). Lets
        an in-process engine VERIFY a repair publish has landed:
        publishes are one-sided (no ack, like the reference's RDMA WRITE
        into the table), and the long-poll sync point only covers the
        publish COUNT — a repair overwrite doesn't change the count, so
        recovery must observe the entry itself."""
        with self._tables_lock:
            table = self._tables.get(shuffle_id)
        return table.entry(map_id) if table is not None else None

    def has_shuffle(self, shuffle_id: int) -> bool:
        with self._tables_lock:
            return shuffle_id in self._tables

    # -- broadcast registry (shared_vars) --------------------------------

    def register_broadcast(self, bcast_id: int, blob: bytes) -> None:
        with self._broadcasts_lock:
            self._broadcasts[bcast_id] = blob

    def unregister_broadcast(self, bcast_id: int) -> None:
        with self._broadcasts_lock:
            self._broadcasts.pop(bcast_id, None)

    def members(self) -> List[ShuffleManagerId]:
        return self.membership.members()

    def client_conn(self, peer: ShuffleManagerId) -> Connection:
        """A cached control connection to one member (the drain
        coordinator's DrainReq rides this)."""
        return self._clients.get(peer.rpc_host, peer.rpc_port)

    def publish_membership(self, snapshot: List[ShuffleManagerId],
                           states: List[int], epoch: int) -> None:
        """Broadcast one committed membership change: the full announce
        (legacy peers understand exactly this much), the slot-state
        bump (elastic peers recompute placement/targets/health from
        it), and the admission capacity rescale."""
        self._queue_announce(snapshot, epoch)
        self._queue_push(None, M.MembershipBumpMsg(epoch, states))
        self._update_admission_fleet()

    def _update_admission_fleet(self) -> None:
        self.admission.set_fleet(len(self.membership.live_slots()),
                                 self.membership.baseline())

    def remove_member(self, manager_id: ShuffleManagerId) -> None:
        """Executor-loss cleanup (scala/RdmaShuffleManager.scala:155-165).

        The slot is kept (indices are stable); the entry is tombstoned so
        fetchers fail fast instead of contacting a dead peer. The tombstoned
        snapshot is re-announced so all executors converge.
        """
        from sparkrdma_tpu_torch.shuffle import ha

        def apply() -> None:
            res = self.membership.tombstone(manager_id)
            if res is None:
                return  # unknown or already tombstoned: nothing to do
            snapshot, states, epoch, dead_slot = res
            self.publish_membership(snapshot, states, epoch)
            self.on_slot_dead(dead_slot)

        if (self.oplog is not None and not self._replaying
                and not self._in_derived_apply()):
            return self._ha_apply(ha.OP_TOMBSTONE, manager_id.serialize(),
                                  apply)
        return apply()

    def on_slot_dead(self, dead_slot: int) -> None:
        """The location-plane half of losing a slot (failure tombstone
        AND planned retire share it): bump shuffles whose table actually
        NAMES the dead slot — their cached locations could route a fetch
        at a dead executor (the chaos matrix asserts none serves after
        this). Shuffles with no entry on the slot keep their epoch:
        invalidating them too would cold-restart every reducer's cache
        fleet-wide and queue O(shuffles x members) pushes for nothing."""
        with self._tables_lock:
            sids = [sid for sid, table in self._tables.items()
                    if any((e := table.entry(m)) is not None
                           and e[1] == dead_slot
                           for m in range(table.num_maps))]
            # merged segments hosted BY the dead slot are gone with it;
            # entries on survivors stay — they are exactly what recovery
            # re-points to instead of re-executing
            for directory in self._merged.values():
                directory.drop_slot(dead_slot)
        for sid in sids:
            self.bump_epoch(sid, reason="executor lost")
        self._shard_handoff(dead_slot, reason="executor lost")

    def _shard_handoff(self, slot: int, reason: str) -> None:
        """Move every shard hosted by ``slot`` to a new owner,
        generation-forward (model-checked: handoff_vs_publish /
        handoff_vs_driver_failover). The refreshed ShardMapMsg rides the
        announce channel first — the new owner adopts its range — then
        one ShardHandoffMsg per moved shard triggers the standby-buffer
        replay (FIFO per member keeps that order). DERIVED from the
        logged membership op (tombstone/drain), never logged itself: a
        standby replaying those ops re-derives the same reassignment,
        and composed generations (incarnation in the high bits) keep any
        replayed assignment strictly above every pre-failover owner's."""
        if self.conf.metadata_shards <= 0:
            return
        from sparkrdma_tpu_torch.shuffle.ha import compose_epoch, epoch_seq
        from sparkrdma_tpu_torch.shuffle.location_plane import ShardMap
        pushes: List[RpcMsg] = []
        moves = []
        with self._tables_lock:
            for sid, (smap, gen) in list(self._shard_maps.items()):
                if slot not in smap.shard_slots:
                    continue
                table = self._tables.get(sid)
                if table is None:
                    continue
                new_map = ShardMap.assign(table.num_maps, self.membership,
                                          self.conf.metadata_shards,
                                          avoid={slot})
                if new_map is None:
                    # nobody left to host shards: driver-only metadata
                    # (the publish path and cold sync both fall back)
                    self._shard_maps.pop(sid, None)
                    continue
                new_gen = compose_epoch(self.incarnation,
                                        epoch_seq(gen) + 1)
                self._shard_maps[sid] = (new_map, new_gen)
                self.shard_handoffs += 1
                pushes.append(M.ShardMapMsg(sid, new_gen, table.num_maps,
                                            new_map.shard_slots))
                for sh in range(new_map.num_shards):
                    old = (smap.shard_slots[sh]
                           if sh < smap.num_shards else -1)
                    new = new_map.shard_slots[sh]
                    if old != new:
                        pushes.append(M.ShardHandoffMsg(sid, sh, new_gen,
                                                        new, old))
                        moves.append((sid, sh, new, old))
        for m in pushes:
            self._queue_push(None, m)
        for sid, sh, new, old in moves:
            self.tracer.instant("meta.shard_handoff", "meta", shuffle=sid,
                                shard=sh, to_slot=new, from_slot=old,
                                reason=reason)

    # -- elastic membership (parallel/membership.py) ---------------------

    def maps_owned_by(self, shuffle_id: int, slot: int) -> List[int]:
        """Maps whose CURRENT table entry names ``slot`` (the drain
        coordinator's re-point accounting)."""
        with self._tables_lock:
            table = self._tables.get(shuffle_id)
        if table is None:
            return []
        return [m for m in range(table.num_maps)
                if (e := table.entry(m)) is not None and e[1] == slot]

    def unservable_without(self, shuffle_id: int, slot: int) -> List[int]:
        """Maps that could NOT be served if ``slot`` retired right now:
        no live owner elsewhere AND no merged replica the reducers'
        merged-first resolution would select. Empty = retiring the slot
        costs zero re-executions (the drain coordinator's safety
        invariant; covers maps re-pointed to segments the drainee
        HOSTS, not just maps it owns)."""
        with self._tables_lock:
            table = self._tables.get(shuffle_id)
        if table is None:
            return []
        members = self.membership.members()

        def owner_live(s: int) -> bool:
            return (s != slot and 0 <= s < len(members)
                    and members[s] != TOMBSTONE)

        pending = []
        for m in range(table.num_maps):
            e = table.entry(m)
            if e is not None and owner_live(e[1]):
                continue
            pending.append(m)
        if not pending:
            return []
        covered = self.merged_covering(shuffle_id, pending,
                                       exclude_slot=slot)
        pending = [m for m in pending if m not in covered]
        if pending:
            # the cold tier counts toward the safety invariant: a blob
            # has no slot to retire, so tiered coverage survives any
            # drain by construction
            cold = self.tiered_covering(shuffle_id, pending)
            pending = [m for m in pending if m not in cold]
        return pending

    def abort_drain(self, slot: int) -> bool:
        """Return a DRAINING slot to LIVE (the operator changed their
        mind and the drainee is still healthy), broadcasting the state
        change — without the publish, peers would treat the slot as
        draining forever. No-op (False) unless the slot is DRAINING."""
        from sparkrdma_tpu_torch.shuffle.ha import DRAIN_ABORT
        reverted = self.drain_transition(slot, DRAIN_ABORT)
        if reverted is None:
            return False
        self.publish_membership(*reverted)
        log.info("driver: drain of slot %d aborted; slot is LIVE again",
                 slot)
        return True

    def decommission_slot(self, slot: int,
                          deadline_ms: Optional[int] = None) -> dict:
        """Gracefully drain + retire one executor slot (see
        :func:`sparkrdma_tpu_torch.parallel.membership.drain_slot`)."""
        from sparkrdma_tpu_torch.parallel.membership import drain_slot
        return drain_slot(self, slot, deadline_ms=deadline_ms)

    def attach_autoscaler(self, scale_up=None, scale_down=None,
                          load_fn=None):
        """Create (and with ``autoscale_interval_ms`` > 0, start) the
        membership autoscaler. ``scale_up(n)`` is the embedding
        harness's spawn hook; ``scale_down(slot)`` defaults to
        :meth:`decommission_slot`. Returns the
        :class:`~sparkrdma_tpu_torch.parallel.membership.Autoscaler`."""
        from sparkrdma_tpu_torch.parallel.membership import Autoscaler
        if self.autoscaler is None:
            self.autoscaler = Autoscaler(self, self.conf,
                                         scale_up=scale_up,
                                         scale_down=scale_down,
                                         load_fn=load_fn)
            self.autoscaler.start()
        return self.autoscaler

    # -- message handling ------------------------------------------------

    def _handle(self, conn: Connection, msg: RpcMsg) -> Optional[RpcMsg]:
        # wire-shaped mutations are op-logged VERBATIM and re-applied
        # through this same dispatch on replay: the fence floors / epoch
        # guards inside the handlers are the idempotency story, so the
        # log needs no semantic understanding of the frames it carries
        if (self.oplog is not None and not self._replaying
                and isinstance(msg, (HelloMsg, M.JoinMsg, M.PublishMsg,
                                     M.MergedPublishMsg,
                                     M.TieredPublishMsg,
                                     M.ShardBatchMsg))):
            from sparkrdma_tpu_torch.shuffle.ha import OP_WIRE
            return self._ha_apply(OP_WIRE, msg.encode(),
                                  lambda: self._dispatch(conn, msg))
        return self._dispatch(conn, msg)

    def _dispatch(self, conn: Optional[Connection],
                  msg: RpcMsg) -> Optional[RpcMsg]:
        if isinstance(msg, HelloMsg):
            self._on_hello(msg.manager_id)
            return None
        if isinstance(msg, M.JoinMsg):
            self._on_hello(msg.manager_id, explicit_join=True)
            return None
        if isinstance(msg, M.StandbyHelloMsg):
            self._on_standby_hello(msg)
            return None
        if isinstance(msg, M.PublishMsg):
            return self._on_publish(msg)
        if isinstance(msg, M.FetchTableReq):
            return self._on_fetch_table(conn, msg)
        if isinstance(msg, M.FetchPlanReq):
            return self._on_fetch_plan(msg)
        if isinstance(msg, M.MergedPublishMsg):
            self._on_merged_publish(msg)
            return None
        if isinstance(msg, M.ShardBatchMsg):
            self._on_shard_batch(msg)
            return None
        if isinstance(msg, M.FetchMergedReq):
            return self._on_fetch_merged(msg)
        if isinstance(msg, M.TieredPublishMsg):
            self._on_tiered_publish(msg)
            return None
        if isinstance(msg, M.FetchTieredReq):
            return self._on_fetch_tiered(msg)
        if isinstance(msg, M.GetBroadcastReq):
            with self._broadcasts_lock:
                blob = self._broadcasts.get(msg.bcast_id)
            if blob is None:
                return M.GetBroadcastResp(msg.req_id, M.STATUS_ERROR, b"")
            return M.GetBroadcastResp(msg.req_id, M.STATUS_OK, blob)
        if isinstance(msg, M.PingMsg):
            return M.PongMsg(msg.req_id)
        log.warning("driver: unexpected %s", type(msg).__name__)
        return None

    def _on_hello(self, manager_id: ShuffleManagerId,
                  explicit_join: bool = False) -> None:
        """(scala/RdmaShuffleManager.scala:76-115). A JoinMsg routes
        here too (``explicit_join``) — the membership plane treats every
        hello as a join; the explicit frame just names the elastic
        intent for tracing/audit."""
        snapshot, states, epoch, is_new = self.membership.join(manager_id)
        if is_new and (explicit_join or self.membership.joins):
            self.tracer.instant("member.join", "member",
                                slot=len(snapshot) - 1, epoch=epoch,
                                explicit=int(explicit_join))
            log.info("driver: executor %s:%s JOINED as slot %d "
                     "(membership epoch %d)", manager_id.rpc_host,
                     manager_id.rpc_port, len(snapshot) - 1, epoch)
        # Broadcast the full ordered membership to everyone, async — the
        # driver connects out to each executor's control server — plus
        # the slot-state bump and the admission capacity rescale.
        self.publish_membership(snapshot, states, epoch)

    def _queue_announce(self, snapshot: List[ShuffleManagerId],
                        epoch: int) -> None:
        """Hand the broadcaster the newest snapshot; older queued ones are
        superseded (every snapshot is the full membership, so skipping
        intermediates loses nothing — executors order by epoch anyway)."""
        if self._replaying:
            return  # restore is silent; the takeover re-announce speaks
        with self._announce_cond:
            if (self._announce_pending is None
                    or epoch > self._announce_pending[1]):
                self._announce_pending = (snapshot, epoch)
            self._announce_cond.notify()

    def _queue_push(self, target, msg: RpcMsg) -> None:
        """Queue a metadata-plane push for the broadcaster thread:
        ``target=None`` broadcasts to every live member, a
        ShuffleManagerId directs one send (shard-entry forwards), and a
        raw ``(host, port)`` tuple directs one send to a non-member
        address (the standby replication stream). Best-effort by design
        — a lost push is backstopped by the fetch-failure invalidation
        path (or, for standbys, by the re-hello catch-up), so no retry
        ladder hangs off the publish handler. Suppressed during restore
        replay: the takeover re-announce is the authoritative
        broadcast."""
        if self._replaying:
            return
        with self._announce_cond:
            if self._announce_stop:
                return
            self._push_pending.append((target, msg))
            self._announce_cond.notify()

    def _broadcast_loop(self) -> None:
        while True:
            with self._announce_cond:
                while (self._announce_pending is None
                       and not self._push_pending
                       and not self._announce_stop):
                    # 1s deadline: stop() notifies under the lock, but a
                    # lost wake must cost one re-check, not a hung
                    # broadcaster at teardown
                    self._announce_cond.wait(timeout=1.0)
                if self._announce_stop:
                    return
                snapshot_epoch = self._announce_pending
                self._announce_pending = None
                pushes, self._push_pending = self._push_pending, []
            try:
                if snapshot_epoch is not None:
                    self._broadcast(*snapshot_epoch)
            except Exception:  # noqa: BLE001 — a bad snapshot must cost one
                # broadcast, not the whole announce plane (the single
                # long-lived thread would otherwise die silently)
                log.exception("driver: announce broadcast (epoch %d) failed",
                              snapshot_epoch[1])
            for target, msg in pushes:
                try:
                    self._send_push(target, msg)
                except Exception:  # noqa: BLE001 — same survival contract
                    log.exception("driver: metadata push failed")

    def _send_push(self, target, msg: RpcMsg) -> None:
        if isinstance(target, tuple):  # standby replication stream
            try:
                self._clients.get(*target).send(msg)
            except TransportError as e:
                # one attempt, like every push: a dead standby re-syncs
                # through its next StandbyHello catch-up
                log.debug("driver: standby push %s to %s:%s failed: %s",
                          type(msg).__name__, target[0], target[1], e)
            return
        members = self.membership.members()
        targets = ([target] if target is not None
                   else [m for m in members if m != TOMBSTONE])
        for m in targets:
            if self._announce_stop:
                return
            if m == TOMBSTONE:
                continue
            try:
                self._clients.get(m.rpc_host, m.rpc_port).send(msg)
            except TransportError as e:
                # one attempt only: the peer may be mid-death (the very
                # event some pushes announce); its reducers heal via the
                # fetch-failure invalidation backstop
                log.debug("driver: push %s to %s:%s failed: %s",
                          type(msg).__name__, m.rpc_host, m.rpc_port, e)

    def _broadcast(self, members: List[ShuffleManagerId], epoch: int) -> None:
        announce = AnnounceMsg(members, epoch)
        lost: List[ShuffleManagerId] = []
        for m in members:
            if m == TOMBSTONE:
                continue
            if self._announce_stop:
                # stop() raced us: bail before minting fresh connections the
                # just-run close_all() would never see
                return
            # Two attempts: a failed send on a stale cached connection is
            # not evidence of peer death — retry on a fresh connection and
            # only declare the peer lost if that also fails (a transient
            # blip must not permanently tombstone a live executor).
            delivered = False
            for attempt in range(2):
                conn = None
                try:
                    conn = self._clients.get(m.rpc_host, m.rpc_port)
                    conn.send(announce)
                    delivered = True
                    break
                except TransportError as e:
                    log.warning("driver: announce to %s:%s failed "
                                "(attempt %d): %s", m.rpc_host, m.rpc_port,
                                attempt + 1, e)
                    if conn is not None:
                        conn.close()  # drop the stale connection
            if not delivered:
                lost.append(m)
        # Failure detection: an unreachable executor is treated as lost and
        # tombstoned so fetchers fail fast (the reference reacts to
        # SparkListenerBlockManagerRemoved the same way,
        # scala/RdmaShuffleManager.scala:155-165). remove_member no-ops on
        # already-tombstoned slots, so this converges.
        for m in lost:
            log.warning("driver: marking unreachable executor %s:%s as lost",
                        m.rpc_host, m.rpc_port)
            self.remove_member(m)

    def _on_publish(self, msg: M.PublishMsg,
                    forward_shard: bool = True) -> Optional[RpcMsg]:
        # Publish is one-sided in the reference (RDMA WRITE into the table,
        # scala/RdmaShuffleManager.scala:410-412) — no remote reply; problems
        # are only observable driver-side, so log rather than ack.
        from sparkrdma_tpu_torch.shuffle.map_output import _MAP_ENTRY, MAP_ENTRY_SIZE
        with self._tables_lock:
            table = self._tables.get(msg.shuffle_id)
            self._touch_locked(msg.shuffle_id)
        if table is None:
            log.warning("driver: publish for unknown shuffle %d", msg.shuffle_id)
            return None
        if not 0 <= msg.map_id < table.num_maps:
            log.warning("driver: publish with bad map_id %d for shuffle %d",
                        msg.map_id, msg.shuffle_id)
            return None
        if len(msg.entry) != MAP_ENTRY_SIZE:
            log.warning("driver: bad publish entry size %d for shuffle %d "
                        "map %d", len(msg.entry), msg.shuffle_id, msg.map_id)
            return None
        token, exec_index = _MAP_ENTRY.unpack(msg.entry)
        old = table.entry(msg.map_id)
        try:
            accepted = table.publish(msg.map_id, token, exec_index,
                                     fence=msg.fence)
        except (ValueError, IndexError) as e:
            log.warning("driver: bad publish for shuffle %d map %d: %s",
                        msg.shuffle_id, msg.map_id, e)
            return None
        if not accepted:
            # a zombie speculative attempt's late publish: the committed
            # winner's location stays the one served
            self.fenced_publishes += 1
            log.warning("driver: FENCED stale publish for shuffle %d map "
                        "%d (exec %d fence %d)", msg.shuffle_id, msg.map_id,
                        exec_index, msg.fence)
            return None
        # adaptive planning: an APPLIED publish carries its per-partition
        # sizes into the histogram — positionally, so a repair publish
        # overwrites the dead attempt's row exactly like the table entry
        if msg.lengths is not None:
            with self._tables_lock:
                hist = self._size_hists.get(msg.shuffle_id)
            if hist is not None:
                hist.add(msg.map_id, msg.lengths)
        # epoch semantics: a publish that OVERWROTE a live entry is a
        # REPAIR (re-execution after loss or corrupt output, elastic
        # rejoin under new tokens) — bump + push so epoch-validated
        # caches refresh. First-time publishes and identical republishes
        # move no state reducers could have cached against.
        epoch = self.epoch_of(msg.shuffle_id) or 1
        if old is not None and old != (token, exec_index):
            # merged segments holding the REPLACED attempt's bytes are
            # conservative casualties: a corrupt-output repair may have
            # rewritten content, so the directory drops every entry
            # covering this map BEFORE the bump pushes the invalidation
            with self._tables_lock:
                directory = self._merged.get(msg.shuffle_id)
                if directory is not None and directory.drop_map(msg.map_id):
                    log.info("driver: merged entries covering shuffle %d "
                             "map %d dropped (repair publish)",
                             msg.shuffle_id, msg.map_id)
                # cold blobs carrying the replaced attempt's bytes are
                # the same conservative casualty: a blob uploaded (or
                # still uploading) from the superseded segment must
                # never resolve — its entry dies here and a LATE
                # publish of it lands against this pruned state, where
                # the reducer's resolve-order already prefers the
                # repaired hot copy (modelcheck tier_vs_replan)
                tiered = self._tiered.get(msg.shuffle_id)
                if tiered is not None and tiered.drop_map(msg.map_id):
                    log.info("driver: tiered entries covering shuffle %d "
                             "map %d dropped (repair publish)",
                             msg.shuffle_id, msg.map_id)
                # and close the mid-upload window: a tiered publish of
                # this map arriving AFTER this prune is stale by
                # construction (its upload read the replaced bytes)
                self._tiered_superseded.add((msg.shuffle_id, msg.map_id))
            epoch = self.bump_epoch(msg.shuffle_id,
                                    reason="repair publish") or epoch
        # push-merge: the LAST publish completes the map stage — tell
        # merge targets to quiesce, seal, and publish their segments
        if (self.conf.push_merge
                and table.num_published == table.num_maps):
            self.finalize_merge(msg.shuffle_id)
        # sharded driver state: the fence CAS above is the driver's
        # authority — only surviving publishes are forwarded into the
        # owning shard host's replica (one directed positional write,
        # the reference's table WRITE re-aimed at a shard host).
        # ``forward_shard=False`` on the batch-convergence path: the
        # record came FROM the owner, whose replica already holds it.
        with self._tables_lock:
            shard_map_v = self._shard_maps.get(msg.shuffle_id)
        if shard_map_v is not None and forward_shard:
            shard_map = shard_map_v[0]
            members = self.membership.members()
            slot = shard_map.slot_of_map(msg.map_id)
            if slot < len(members) and members[slot] != TOMBSTONE:
                self._queue_push(members[slot], M.ShardEntryMsg(
                    msg.shuffle_id, epoch, msg.map_id, table.num_maps,
                    msg.entry))
        # push: answer any long-poller this publish satisfies (the write
        # above happens-before the waiter scan; _on_fetch_table re-checks
        # the count inside the same lock, so no wakeup can be lost)
        ready = []
        with self._waiters_lock:
            pending = self._waiters.get(msg.shuffle_id)
            if pending:
                n = table.num_published
                still = [w for w in pending if w[2] > n]
                ready = [w for w in pending if w[2] <= n]
                if still:
                    self._waiters[msg.shuffle_id] = still
                else:
                    self._waiters.pop(msg.shuffle_id, None)
        if ready:
            count, table_bytes = table.num_published, table.to_bytes()
            for conn, req_id, _, _ in ready:
                self._answer_waiter(conn, M.FetchTableResp(
                    req_id, count, table_bytes, epoch))
        return None

    def _on_shard_batch(self, msg: "M.ShardBatchMsg") -> None:
        """Batch convergence from a shard OWNER (shard_ownership mode):
        replay each owner-applied write through the normal publish /
        merged-publish path. The fence CAS and the directory's zombie
        guard make the echo idempotent, which is exactly what keeps the
        driver-visible table byte-identical to the unsharded path —
        the owner accelerated the write, it never forked the state."""
        self.shard_batches += 1
        for map_id, fence, entry, lengths in msg.records:
            self._on_publish(
                M.PublishMsg(msg.shuffle_id, map_id, entry, fence=fence,
                             lengths=lengths),
                forward_shard=False)
        for blob in msg.blobs:
            try:
                inner = M.MergedPublishMsg.from_payload(blob)
            except (struct.error, ValueError, IndexError) as e:
                log.warning("driver: undecodable merged blob in shard "
                            "batch for shuffle %d: %s", msg.shuffle_id, e)
                continue
            self._on_merged_publish(inner)

    def _on_fetch_table(self, conn: Connection,
                        msg: M.FetchTableReq) -> Optional[RpcMsg]:
        with self._tables_lock:
            table = self._tables.get(msg.shuffle_id)
            epoch = self._epochs.get(msg.shuffle_id, 0)
            self._touch_locked(msg.shuffle_id)
        if table is None:
            return M.FetchTableResp(msg.req_id, -1, b"", M.EPOCH_DEAD)
        with self._waiters_lock:
            n = table.num_published
            if n >= msg.min_published or msg.timeout_ms <= 0:
                return M.FetchTableResp(msg.req_id, n, table.to_bytes(),
                                        epoch)
            deadline = time.monotonic() + msg.timeout_ms / 1000
            waiter = (conn, msg.req_id, msg.min_published, deadline)
            self._waiters.setdefault(msg.shuffle_id, []).append(waiter)
        # unregister-race re-check: unregister_shuffle pops the table
        # (tables lock) and THEN wakes waiters (waiters lock) — a poll
        # that read the table before the pop but registered after the
        # wake would sit out its whole deadline for a shuffle that is
        # already gone. Re-reading the registry after registration
        # closes the window: whoever pops the waiter (us here, or the
        # unregister that raced in between) answers it, exactly once.
        with self._tables_lock:
            gone = msg.shuffle_id not in self._tables
        if gone:
            with self._waiters_lock:
                pending = self._waiters.get(msg.shuffle_id, [])
                mine = waiter in pending
                if mine:
                    pending.remove(waiter)
                    if not pending:
                        self._waiters.pop(msg.shuffle_id, None)
            if mine:
                return M.FetchTableResp(msg.req_id, -1, b"", M.EPOCH_DEAD)
        return None  # answered later by a publish or the sweeper

    def _answer_waiter(self, conn: Connection, resp: RpcMsg) -> None:
        try:
            conn.send(resp)
        except TransportError as e:
            log.warning("driver: long-poll answer failed: %s", e)

    def _sweep_waiters(self) -> None:
        """Expire long-polls at their deadline with the partial table."""
        while not self._announce_stop:
            time.sleep(0.05)
            now = time.monotonic()
            expired = []  # [(sid, table, [waiter, ...])]
            with self._waiters_lock:
                for sid, pending in list(self._waiters.items()):
                    live = [w for w in pending if w[3] > now]
                    dead = [w for w in pending if w[3] <= now]
                    if dead:
                        with self._tables_lock:
                            table = self._tables.get(sid)
                            epoch = self._epochs.get(sid, M.EPOCH_DEAD)
                        expired.append((table, epoch, dead))
                        if live:
                            self._waiters[sid] = live
                        else:
                            self._waiters.pop(sid, None)
            for table, epoch, dead in expired:
                if table is None:
                    count, table_bytes = -1, b""
                else:
                    count, table_bytes = table.num_published, table.to_bytes()
                for conn, req_id, _, _ in dead:
                    self._answer_waiter(conn, M.FetchTableResp(
                        req_id, count, table_bytes, epoch))

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        # the lease loop keys off _lease_lost too: setting it here lets
        # a clean stop release the renew thread within one period
        self._lease_lost.set()
        with self._announce_cond:
            self._announce_stop = True
            self._announce_cond.notify()
        self._broadcaster.join(timeout=self.conf.teardown_timeout_ms / 1000)
        if self._lease_thread is not None:
            self._lease_thread.join(
                timeout=self.conf.teardown_timeout_ms / 1000)
        self._clients.close_all()
        self.server.stop()


class ByteCredits:
    """Per-connection serving window: logical response bytes the server
    may hold built-and-undelivered (the receiver-driven flow control of
    java/RdmaChannel.java:61-64, 744-787 — credits granted by the recv
    window, replenished by the reader's CreditReport on receipt).

    Parking is QUEUED, not blocking: a request that doesn't fit enqueues
    a resume callback and frees its serving thread, so one stalled
    connection can never head-of-line-block the shared serving pool.
    ``release`` re-admits parked requests FIFO with their reservation
    already taken. A single request larger than the whole window is
    charged the full window, so one oversized block can never deadlock.
    """

    def __init__(self, budget: int):
        self.budget = budget
        self._avail = budget
        self._lock = threading.Lock()
        self._parked_q: list = []  # [(need, deadline, resume, expire)]
        self.peak_reserved = 0  # audit: worst-case held bytes
        self.parked = 0         # audit: requests that had to wait

    def reserve_or_park(self, nbytes: int, deadline: float,
                        resume, expire) -> bool:
        """Atomically reserve (returns True) or enqueue the continuation
        (returns False). The availability check and the park happen under
        ONE lock acquisition — with a separate check-then-park, a
        ``release`` landing in the gap could drain the window and never
        wake the request (lost wakeup: the request, and behind the FIFO
        gate every later one, would sit parked against a fully-available
        window until the sweeper failed them). ``resume()`` fires (off
        this thread) once the reservation has been taken on the request's
        behalf; ``expire()`` fires if the deadline passes first (swept by
        the endpoint)."""
        need = min(nbytes, self.budget)
        with self._lock:
            # FIFO fairness: never jump a parked queue
            if not self._parked_q and self._avail >= need:
                self._avail -= need
                self.peak_reserved = max(self.peak_reserved,
                                         self.budget - self._avail)
                return True
            self._parked_q.append((need, deadline, resume, expire))
            self.parked += 1
        return False

    def release(self, nbytes: int) -> None:
        resumes = []
        with self._lock:
            self._avail = min(self.budget,
                              self._avail + min(nbytes, self.budget))
            while self._parked_q and self._avail >= self._parked_q[0][0]:
                need, _, resume, _ = self._parked_q.pop(0)
                self._avail -= need
                self.peak_reserved = max(self.peak_reserved,
                                         self.budget - self._avail)
                resumes.append(resume)
        for resume in resumes:
            resume()

    def expire_stale(self, now: float) -> list:
        """Pop parked entries past their deadline; returns their expire
        callbacks for the caller to run."""
        expired = []
        with self._lock:
            keep = []
            for item in self._parked_q:
                (expired if item[1] <= now else keep).append(item)
            self._parked_q = keep
        return [item[3] for item in expired]


class ExecutorEndpoint:
    """Control-plane executor: serves peers, talks to the driver."""

    def __init__(self, manager_id_host: str, executor: str,
                 driver_addr: Tuple[str, int],
                 data_source: Optional[ShuffleDataSource] = None,
                 conf: Optional[TpuShuffleConf] = None,
                 engine_port: int = 0, block_port: int = 0,
                 tracer=None):
        self.conf = conf or TpuShuffleConf()
        self.data_source = data_source
        self.tracer = tracer or trace_mod.NULL
        self.server = ControlServer(manager_id_host, self.conf.executor_port,
                                    self.conf, self._handle,
                                    name=f"exec-{executor}")
        self.manager_id = ShuffleManagerId(
            _ExecutorId(executor, manager_id_host, engine_port),
            self.server.host, self.server.port, block_port)
        self._driver_addr = driver_addr
        self._members: List[ShuffleManagerId] = []
        self._announce_epoch = -1
        self._members_event = threading.Event()
        self._members_lock = threading.Lock()
        self._clients = ConnectionCache(self.conf, on_message=self._handle)
        # the ONE driver channel (parallel/driver_client.py): every
        # driver-bound call site routes through it so a failover
        # re-points them all at once; a TakeoverMsg moves the pointer
        # forward-only under the incarnation comparison
        self.driver = DriverClient(self.conf, self._clients, driver_addr)
        # metadata plane (shuffle/location_plane.py): the epoch-validated
        # local cache of driver tables + block-location entries (the
        # warm-path zero-RPC store), and this executor's driver-table
        # shard replicas (fed by the driver's ShardEntryMsg forwards,
        # served to peers' FetchShardReq long-polls)
        from sparkrdma_tpu_torch.shuffle.location_plane import (
            LocationPlane, ShardStore)
        self.location_plane = LocationPlane(
            enabled=bool(self.conf.location_epoch_cache))
        self.shard_store = ShardStore()
        self._shard_waiters: Dict[int, list] = {}
        self._shard_waiters_lock = threading.Lock()
        # partitioned metadata OWNERSHIP (shuffle/shard_plane.py): with
        # shard_ownership on, this executor may OWN map-ranges — run
        # their fence CAS, stream their per-shard op log to a standby,
        # and batch-converge applied writes into the driver table.
        # shard_owner doubles as the mode flag (None = replica mode).
        self.shard_owner = None
        self.shard_standby = None
        # pending owner->driver batches: (sid, shard) -> (gen, records,
        # merged blobs); flushed at shard_batch_entries or by the
        # flusher thread (bounded convergence lag)
        self._shard_batches: Dict[Tuple[int, int], tuple] = {}
        self._shard_batch_lock = threading.Lock()
        self._shard_flusher: Optional[threading.Thread] = None
        self._shard_flush_wake = threading.Event()
        # publisher-side republish backstop: direct-to-owner publishes
        # are remembered until the shuffle dies so a handoff can re-aim
        # them (fence floors make re-sends idempotent). This is what
        # turns "owner killed mid-publish" into a metadata re-send
        # instead of a map re-execution.
        self._republish: Dict[int, Dict[int, tuple]] = {}
        self._republish_lock = threading.Lock()
        if self.conf.shard_ownership and self.conf.metadata_shards > 0:
            from sparkrdma_tpu_torch.shuffle.shard_plane import (
                ShardOwnerStore, ShardStandbyBuffer)
            self.shard_owner = ShardOwnerStore()
            self.shard_standby = ShardStandbyBuffer()
        # invalidation generation: a long-poll answered with a
        # PRE-invalidation table must not re-memoize after the
        # invalidation (stage recovery repaired the driver table; a stale
        # re-cache would pin dead-slot locations for every later reader).
        # One endpoint-wide counter: an invalidation of ANY shuffle skips
        # memoizing concurrently-in-flight polls — at worst one extra
        # table fetch later, and O(1) state instead of a per-shuffle-id
        # dict that grows forever
        self._table_gen = 0
        self._table_lock = threading.Lock()
        self.wire_bytes_in = 0  # compressed-on-the-wire fetch payload total
        self._wire_lock = threading.Lock()
        # wire codec (encryption/integrity hook, utils/codecs.py — the
        # scala/RdmaShuffleReader.scala:118-128 wrapStream analogue)
        from sparkrdma_tpu_torch.utils import codecs as _codecs
        self._codec, self._codec_key = _codecs.resolve(self.conf)
        # task shipping (engine tasks run here when a runner is installed;
        # see sparkrdma_tpu_torch/tasks.py)
        self._task_runner = None
        self._task_pool = None
        # push-merge (shuffle/push_merge.py): the manager installs a
        # MergeStore here when push_merge is on; pushes/finalizes run on
        # the serve pool (disk appends must never block a reader thread)
        self.merge_store = None
        # planned push (shuffle/pushed_store.py): the manager installs a
        # PushedInputStore here when planned_push is on; the fetcher
        # resolves it FIRST, before merged segments and per-map pull
        self.pushed_store = None
        # cold tier (shuffle/cold_tier.py): the manager installs a
        # TieringService here when cold_tier is on; finalized segments
        # tier asynchronously and the fetcher resolves the TIERED
        # location class LAST, before re-execution
        self.tiering = None
        # the planned pusher's plan hook (SegmentPusher.on_plan): called
        # when a ReducePlanMsg lands so submitted maps whose plan
        # arrived late (or re-planned) re-push to their planned slots
        self.on_plan_cb = None
        # tenancy (shuffle/tenancy.py): shuffle -> owning tenant, taught
        # by the driver's TenantMapMsg push and locally by the manager's
        # handle path; keys the serve loop's fair-share queue. The DRR
        # queue itself is created lazily with the serve pool.
        self._tenant_lock = threading.Lock()
        self._tenant_map: Dict[int, int] = {}
        self._serve_drr = None
        self.fair_served: Dict[int, int] = {}  # tenant -> serves (audit)
        # receiver-driven serving flow control: per-connection byte
        # windows + a serving pool so data responses build/park OFF the
        # reader thread (a parked reader could never receive the very
        # CreditReport that would unpark it)
        import weakref

        self._serve_pool = None
        self._serve_pool_lock = threading.Lock()
        self._park_sweeper = None
        self._conn_credits = weakref.WeakKeyDictionary()
        self._credits_lock = threading.Lock()
        self._credit_timeouts = 0
        # client side: logical sizes of in-flight credited fetches, keyed
        # by connection -> {req_id: size} — consulted when a response
        # arrives ORPHANED (its requester timed out) so its credits still
        # get reported and the server's window heals. Weak keys: entries
        # whose response never arrives (conn died post-timeout) die with
        # the connection instead of accumulating forever, and a recycled
        # id() can never alias a new connection's req_ids.
        self._fetch_credit_pending: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        self._fetch_credit_lock = threading.Lock()
        # connection pre-warming (reference pre-connects requestor
        # channels the moment a peer announces,
        # RdmaShuffleManager.scala:117-126): addresses this endpoint has
        # already dialed (or is dialing) ahead of any fetch
        self._prewarmed: set = set()
        self._prewarm_lock = threading.Lock()
        self._stopping = False
        # CreditReport sends ride a dedicated worker (started on first
        # use): the receipt-time settle runs on connection READER
        # threads, and a blocking sendall there — both TCP directions
        # full under sustained load — would stop the reader from
        # draining responses, stalling every in-flight fetch until
        # timeout instead of making progress
        self._credit_q: "queue.Queue" = queue.Queue()
        self._credit_worker: Optional[threading.Thread] = None
        self._credit_worker_lock = threading.Lock()
        self.prewarm_dials = 0  # audit: successful ahead-of-fetch dials
        # peer-health monitor: heartbeats go only to peers with fetch
        # interest registered (watch_peer), so an idle cluster sends no
        # health traffic; the thread starts lazily on first watch
        self._hb_lock = threading.Lock()
        self._hb_watch: Dict[int, Tuple[ShuffleManagerId, int]] = {}
        self._hb_misses: Dict[int, int] = {}
        self._hb_suspects: set = set()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_wake = threading.Event()
        # mid-job joiners announced by a MembershipBumpMsg before their
        # AnnounceMsg landed: slots to register with the monitor once
        # the member list can resolve them (guarded by _hb_lock)
        self._joiner_watch_pending: set = set()
        self.suspect_events = 0    # audit: peers declared suspect
        self.checksum_failures = 0  # audit: CRC32 mismatches on fetches

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Hello to the driver (scala/RdmaShuffleManager.scala:204-226).
        Routed through the retry envelope: a hello racing a driver
        failover re-dials the re-pointed primary, and fencing makes a
        duplicate hello (one per primary that saw it) idempotent."""
        self.driver.send(HelloMsg(self.manager_id))

    def join_cluster(self) -> None:
        """Explicit mid-job JOIN (parallel/membership.py): same
        membership append as the hello, but the driver traces the
        elastic event. An old driver without the frame would tear the
        connection — the hello already sent is the compatible greeting,
        so a lost/ignored join degrades to static-membership behavior."""
        self.driver.send(M.JoinMsg(self.manager_id))

    def driver_conn(self) -> Connection:
        return self.driver.conn()

    def stop(self) -> None:
        # flagged BEFORE close_all so a racing prewarm dial either sees
        # it (and closes its own connection) or inserts into the cache
        # before close_all drains it — no window where a fresh dial can
        # outlive this teardown
        # analysis: unguarded-ok(set-once monotonic flag; ordering vs close_all documented above)
        self._stopping = True
        self._hb_wake.set()  # ends the heartbeat monitor, if started
        self._shard_flush_wake.set()  # ends the shard-batch flusher
        if self._task_pool is not None:
            self._task_pool.shutdown(wait=False, cancel_futures=True)
        if self._serve_pool is not None:
            self._serve_pool.shutdown(wait=False, cancel_futures=True)
        self._clients.close_all()
        self.server.stop()
        self._credit_q.put(None)  # ends the credit worker, if started

    # -- membership ------------------------------------------------------

    def members(self) -> List[ShuffleManagerId]:
        with self._members_lock:
            return list(self._members)

    def wait_for_members(self, n: int, timeout: float = 10.0) -> List[ShuffleManagerId]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._members_lock:
                if len(self._members) >= n:
                    return list(self._members)
            self._members_event.wait(timeout=0.05)
            self._members_event.clear()
        raise TimeoutError(f"membership did not reach {n} "
                           f"(have {len(self.members())})")

    def exec_index(self, timeout: float = 0.0) -> int:
        """This executor's stable index in the membership order. With a
        timeout, waits for the driver's announce to arrive (publishers may
        race the hello/announce round trip)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._members_lock:
                for i, m in enumerate(self._members):
                    if m == self.manager_id:
                        return i
            if time.monotonic() >= deadline:
                raise KeyError("executor not yet announced")
            self._members_event.wait(timeout=0.05)
            self._members_event.clear()

    def member_at(self, index: int) -> ShuffleManagerId:
        with self._members_lock:
            m = self._members[index]
        if m == TOMBSTONE:
            raise DeadExecutorError(f"executor slot {index} was lost")
        return m

    # -- peer health (heartbeat monitor) ---------------------------------

    def note_tenant(self, shuffle_id: int, tenant: int) -> None:
        """Record the shuffle's owning tenant (push or handle path)."""
        with self._tenant_lock:
            self._tenant_map[shuffle_id] = int(tenant)

    def tenant_of(self, shuffle_id: int) -> int:
        """The shuffle's owning tenant; DEFAULT_TENANT when untaught
        (lost push => degraded fairness, never a correctness issue)."""
        with self._tenant_lock:
            return self._tenant_map.get(shuffle_id, 0)

    def watch_peer(self, exec_index: int, peer: ShuffleManagerId) -> None:
        """Register fetch interest in a peer: the monitor pings watched
        peers every ``heartbeat_interval_ms`` and declares one suspect
        after ``heartbeat_misses`` consecutive missed beats — failing its
        outstanding fetches promptly instead of letting them wait out a
        TCP timeout. Refcounted; pair with :meth:`unwatch_peer`."""
        if self.conf.heartbeat_interval_ms <= 0 or self._stopping:
            return
        with self._hb_lock:
            _, count = self._hb_watch.get(exec_index, (peer, 0))
            self._hb_watch[exec_index] = (peer, count + 1)
            if self._hb_thread is None:
                self._hb_thread = threading.Thread(
                    target=self._hb_loop, daemon=True,
                    name=f"hb-{self.manager_id.executor_id.executor}")
                self._hb_thread.start()

    def unwatch_peer(self, exec_index: int) -> None:
        with self._hb_lock:
            entry = self._hb_watch.get(exec_index)
            if entry is None:
                return
            peer, count = entry
            if count <= 1:
                self._hb_watch.pop(exec_index, None)
                self._hb_misses.pop(exec_index, None)
            else:
                self._hb_watch[exec_index] = (peer, count - 1)

    def peer_suspect(self, exec_index: int) -> bool:
        """True once the monitor has declared this slot dead: fetchers
        fail fast into FetchFailed (stage retry) instead of retrying."""
        with self._hb_lock:
            return exec_index in self._hb_suspects

    def declare_suspect(self, exec_index: int, peer: ShuffleManagerId,
                        reason: str) -> None:
        """The monitor's verdict (also callable by tests/engines that
        learned of a death out of band): mark the slot, then close the
        cached connections to the peer so every outstanding request on
        them fails NOW — ``_fail_pending`` turns a silent peer death into
        immediate TransportErrors for the whole in-flight window."""
        with self._hb_lock:
            if exec_index in self._hb_suspects:
                return
            self._hb_suspects.add(exec_index)
            self.suspect_events += 1
        log.warning("%s: peer slot %d (%s:%s) declared suspect: %s",
                    self.manager_id.executor_id.executor, exec_index,
                    peer.rpc_host, peer.rpc_port, reason)
        self.tracer.instant("peer.suspect", "fault", peer=exec_index,
                            reason=reason)
        self.tracer.counter("peer.suspects", self.suspect_events, "fault")
        self._clients.drop(peer.rpc_host, peer.rpc_port)
        if peer.block_port:
            self._clients.drop(peer.rpc_host, peer.block_port)

    def health_snapshot(self) -> dict:
        with self._hb_lock:
            return {
                "watched": {i: n for i, (_, n) in self._hb_watch.items()},
                "misses": dict(self._hb_misses),
                "suspects": sorted(self._hb_suspects),
                "suspect_events": self.suspect_events,
            }

    def _hb_loop(self) -> None:
        interval = self.conf.heartbeat_interval_ms / 1000
        while not self._stopping and not self.server.stopped:
            if self._hb_wake.wait(interval):
                return  # stop() woke us
            with self._hb_lock:
                targets = [(i, peer) for i, (peer, _) in
                           self._hb_watch.items()
                           if i not in self._hb_suspects]
            pings = []
            for i, peer in targets:
                if self._stopping:
                    return
                # peek, never dial: the monitor exists for peers the
                # fetch path is ALREADY talking to over a looks-alive
                # connection. Dialing here would stall the whole beat on
                # one unreachable peer's connect budget (and could mint a
                # fresh connection after stop()'s close_all); a missing
                # connection means the fetch path is dialing itself and
                # its own failure handling owns reachability.
                conn = self._clients.peek(peer.rpc_host, peer.rpc_port)
                if conn is None:
                    continue
                try:
                    pings.append((i, peer, conn.request_async(
                        M.PingMsg(conn.next_req_id()))))
                except TransportError:
                    self._hb_miss(i, peer, "send failed")
            # collect pongs within one interval so a silent peer costs
            # exactly one beat, not a stacked-timeout multiple of it
            deadline = time.monotonic() + interval
            for i, peer, fut in pings:
                try:
                    resp = await_response(
                        fut, max(0.001, deadline - time.monotonic()))
                    if not isinstance(resp, M.PongMsg):
                        # wrong echo counts as a miss, never kills the
                        # monitor thread
                        raise TransportError(
                            f"bad pong: {type(resp).__name__}")
                    with self._hb_lock:
                        self._hb_misses.pop(i, None)
                except (TimeoutError, TransportError):
                    # await_response cancelled the future on timeout, so
                    # a late pong lands on the unsolicited path harmlessly
                    self._hb_miss(i, peer, "missed beat")

    def _hb_miss(self, exec_index: int, peer: ShuffleManagerId,
                 kind: str) -> None:
        with self._hb_lock:
            n = self._hb_misses.get(exec_index, 0) + 1
            self._hb_misses[exec_index] = n
        if n >= self.conf.heartbeat_misses:
            self.declare_suspect(
                exec_index, peer,
                f"{n} consecutive missed heartbeats ({kind})")

    # -- elastic membership (parallel/membership.py) ---------------------

    def slot_draining(self, slot: int) -> bool:
        """True when the driver's pushed state vector marks the slot
        DRAINING: stop choosing it as a merge/overflow target. Unknown
        slots read LIVE (pre-elastic drivers never push states)."""
        return self.location_plane.slot_draining(slot)

    def _on_membership_bump(self, msg: "M.MembershipBumpMsg") -> None:
        """A pushed membership change: cache the slot-state vector
        (epoch-ordered) and register newly-LIVE joiners with the
        peer-health monitor — a mid-job joiner was otherwise never
        health-watched until some fetch took interest, so its loss was
        detected only by a failed fetch. The watch costs nothing until
        a connection to the joiner exists (the monitor peeks, never
        dials)."""
        joined = self.location_plane.note_membership(msg.epoch,
                                                     msg.slot_states)
        if not joined or self.conf.heartbeat_interval_ms <= 0:
            return
        with self._hb_lock:
            self._joiner_watch_pending.update(joined)
        self._watch_pending_joiners()

    def _watch_pending_joiners(self) -> None:
        """Resolve stashed joiner slots against the (possibly
        just-updated) member list and register them with the monitor.
        A bump can beat its announce — unresolvable slots stay stashed
        and the announce handler retries."""
        if self.conf.heartbeat_interval_ms <= 0 or self._stopping:
            return
        with self._hb_lock:
            pending = set(self._joiner_watch_pending)
        if not pending:
            return
        with self._members_lock:
            members = list(self._members)
        for slot in sorted(pending):
            if slot >= len(members):
                continue  # announce not here yet; retried on arrival
            peer = members[slot]
            if peer == TOMBSTONE or peer == self.manager_id:
                with self._hb_lock:
                    self._joiner_watch_pending.discard(slot)
                continue
            with self._hb_lock:
                self._joiner_watch_pending.discard(slot)
            # monitor-owned watch (never unwatched: the refcount is held
            # for the joiner's lifetime on this endpoint — suspects and
            # teardown end it, exactly like a long-lived fetch interest)
            self.watch_peer(slot, peer)

    def _on_drain(self, conn: Connection, msg: "M.DrainReq") -> None:
        """The drainee half of the graceful-drain protocol: make every
        row this executor is the last holder of — its own committed map
        outputs AND the merged-segment rows it hosts for other
        executors' maps — land on a surviving peer, then answer with
        the audit counts. Serving continues throughout — in-flight
        reads quiesce naturally; the driver only retires the slot after
        its coverage check passes."""
        deadline_ms = msg.deadline_ms or self.conf.drain_deadline_ms
        deadline = time.monotonic() + max(0.05, deadline_ms / 1000)
        status = M.STATUS_OK
        rows_pushed = 0
        bytes_pushed = 0
        try:
            status, rows_pushed, bytes_pushed = \
                self._drain_replicate(deadline)
        except Exception:  # noqa: BLE001 — dedicated thread; a broken
            # drain must still answer so the driver's deadline isn't
            # burned waiting on silence
            log.exception("drain replication pass failed")
            status = M.STATUS_ERROR
        log.info("%s: drain pass done (status %d, %d row(s) pushed, "
                 "%d byte(s))", self.manager_id.executor_id.executor,
                 status, rows_pushed, bytes_pushed)
        try:
            conn.send(M.DrainResp(msg.req_id, status, rows_pushed,
                                  bytes_pushed))
        except TransportError as e:
            log.warning("drain response lost (driver gone?): %s", e)

    def _drain_directory(self, shuffle_id: int, deadline: float,
                         expect_entries: bool):
        """The shuffle's merged directory for drain routing, waiting
        briefly (bounded by ``deadline``) for the map-stage finalize to
        land when this executor holds committed outputs but the
        directory is still empty — a drain racing the ordinary finalize
        would otherwise route rows blind and scatter coverage."""
        wait_until = min(deadline, time.monotonic() + 2.0)
        while True:
            directory = self.get_merged_directory(shuffle_id, fresh=True)
            if directory is not None and (len(directory)
                                          or not expect_entries):
                return directory
            if time.monotonic() >= wait_until:
                return directory
            time.sleep(0.05)

    def _drain_replicate(self, deadline: float) -> Tuple[int, int, int]:
        """Replicate everything only this executor holds, routing each
        (map, partition) row to the slot already holding that
        partition's WIDEST live merged entry. The routing is the load-
        bearing part: reducers (and recovery's ``merged_covering``)
        consume at most ONE merged entry per partition — the widest —
        so scattering drain rows across slots would build wide-but-
        incomplete entries that SHADOW the rows' actual coverage.
        Merging into the already-widest entry keeps one strictly
        growing segment per partition. Rows the widest surviving entry
        already covers are skipped outright, so a fleet whose
        background replication kept up pushes ZERO bytes here.

        Returns ``(status, rows_pushed, bytes_pushed)``."""
        src = self.data_source
        if (not self.conf.push_merge or src is None
                or not hasattr(src, "committed_outputs")):
            # nothing to replicate WITH: the driver's coverage check
            # decides (it will fall back to tombstone recovery)
            return M.STATUS_ERROR, 0, 0
        try:
            my = self.exec_index(timeout=1)
        except KeyError:
            my = -1
        with self._members_lock:
            members = list(self._members)
        # consult BOTH membership views: the announce list (tombstones)
        # and the pushed state vector (draining/dead) — back-to-back
        # drains race their retire announces, and whichever signal
        # arrives first must keep the just-retired slot out of the
        # routing pool
        _, states = self.location_plane.membership()
        candidates = [i for i, m in enumerate(members)
                      if m != TOMBSTONE and i != my
                      and not (i < len(states) and states[i] != 0)]
        if not candidates and self.tiering is None:
            # no live peers and no cold store: nowhere to put the rows.
            # With tiering installed the drain proceeds peer-less — the
            # scale-to-zero exit — and per-row fallback arbitrates.
            return M.STATUS_ERROR, 0, 0
        cand_set = set(candidates)
        directories: Dict[int, object] = {}

        def preferred(sid: int, partition: int):
            """(entry, slot): the widest surviving entry for the
            partition and its slot, or (None, deterministic fallback)."""
            directory = directories.get(sid)
            if directory is not None:
                for e in directory.entries(partition):
                    if e.slot in cand_set:
                        return e, e.slot
            if not candidates:
                return None, -1  # peer-less drain: tiering carries it
            return None, candidates[partition % len(candidates)]

        status = M.STATUS_OK
        rows_pushed = 0
        bytes_pushed = 0

        def push_row(sid: int, partition: int, map_id: int, fence: int,
                     data: bytes) -> bool:
            nonlocal rows_pushed, bytes_pushed, status
            for _attempt in range(3):
                if not candidates:
                    status = M.STATUS_ERROR
                    return False
                _, slot = preferred(sid, partition)
                try:
                    peer = self.member_at(slot)
                    resp = self.push_blocks(peer, sid, map_id, fence,
                                            M.PUSH_KIND_DRAIN, partition,
                                            [len(data)], data)
                except (DeadExecutorError, TransportError, TimeoutError,
                        IndexError) as e:
                    # the slot died since the candidate snapshot was
                    # taken — back-to-back drains race their retire
                    # announces against this pass. Drop it from the
                    # routing pool and re-route the row; the driver's
                    # coverage check still arbitrates the final truth.
                    log.warning("drain push of shuffle %d map %d p%d to "
                                "slot %d failed (%s); re-routing", sid,
                                map_id, partition, slot, e)
                    if slot in cand_set:
                        cand_set.discard(slot)
                        candidates.remove(slot)
                    continue
                if resp.status == M.STATUS_OK and any(resp.accepted
                                                      or b"\x01"):
                    rows_pushed += 1
                    bytes_pushed += len(data)
                return True
            status = M.STATUS_ERROR
            return False

        def route_row(sid: int, partition: int, map_id: int, fence: int,
                      data: bytes) -> bool:
            """Tier-first drain exit: an only-copy row goes to the cold
            store (one durable blob, no peer involved) when tiering is
            up; a store that is down or a dead shuffle falls back to
            the ordinary peer push — the drain never gets CHEAPER
            guarantees than it had before the cold tier existed."""
            nonlocal rows_pushed, bytes_pushed
            if self.tiering is not None:
                if self.tiering.tier_row(sid, partition, map_id, fence,
                                         data, map_id + 1):
                    rows_pushed += 1
                    bytes_pushed += len(data)
                    return True
                log.debug("drain tier of shuffle %d map %d p%d declined; "
                          "falling back to peer push", sid, map_id,
                          partition)
            return push_row(sid, partition, map_id, fence, data)

        own_sids = src.local_shuffles()
        hosted_sids = (self.merge_store.hosted_shuffles()
                       if self.merge_store is not None else [])
        for sid in sorted(set(own_sids) | set(hosted_sids)):
            directories[sid] = self._drain_directory(
                sid, deadline, expect_entries=sid in own_sids)
        # 1) own committed outputs: the rows that would RE-EXECUTE if
        # this slot died unreplicated
        for sid in own_sids:
            for m, lengths in sorted(src.committed_outputs(sid).items()):
                fence = src.committed_fence(sid, m)
                for p in range(len(lengths)):
                    if time.monotonic() > deadline:
                        log.warning("drain replication hit its deadline "
                                    "mid-pass (shuffle %d map %d p%d)",
                                    sid, m, p)
                        return M.STATUS_ERROR, rows_pushed, bytes_pushed
                    entry, _ = preferred(sid, p)
                    if entry is not None and entry.covers(m):
                        continue  # a surviving replica already has it
                    try:
                        data = src.local_blocks(sid, m, p, p + 1)
                    except Exception as e:  # noqa: BLE001 — corrupt/EIO:
                        # never replicate rot; recovery owns this map
                        log.warning("drain read of shuffle %d map %d "
                                    "p%d failed: %s", sid, m, p, e)
                        status = M.STATUS_ERROR
                        break
                    if data is None:
                        break  # superseded/unregistered mid-drain
                    route_row(sid, p, m, fence, data)
        # 2) hosted merged rows: replicas OTHER maps depend on that
        # would silently die with this slot. export_rows streams the
        # payloads (one row in memory at a time) — a target hosting
        # gigabytes of segments must not materialize them all at the
        # exact moment it is being decommissioned.
        if self.merge_store is not None:
            for sid, partition, map_id, fence, data in \
                    self.merge_store.export_rows():
                if time.monotonic() > deadline:
                    log.warning("drain handoff hit its deadline mid-pass "
                                "(shuffle %d p%d map %d)", sid, partition,
                                map_id)
                    return M.STATUS_ERROR, rows_pushed, bytes_pushed
                entry, _ = preferred(sid, partition)
                if entry is not None and entry.covers(map_id):
                    continue
                route_row(sid, partition, map_id, fence, data)
        return status, rows_pushed, bytes_pushed

    # -- connection pre-warming ------------------------------------------

    def _prewarm_peers(self) -> None:
        """Dial every newly-announced peer in the background so the first
        fetch of a shuffle pays zero handshake latency (the reference
        pre-connects on announce, RdmaShuffleManager.scala:117-126).

        Runs OFF the announce reader thread — dialing is bounded by the
        existing connect budget (``max_connection_attempts`` x
        ``connect_timeout_ms``, java/RdmaNode.java:283-353) and must not
        stall announce processing behind a slow peer. Warms the control
        port always, plus the native block-server port when the fetch
        path would actually use it (no wire compression/codec)."""
        with self._members_lock:
            members = list(self._members)
        warm_block = self._codec is None and not self.conf.wire_compress
        addrs = []
        for m in members:
            if m == TOMBSTONE or m == self.manager_id:
                continue
            addrs.append((m.rpc_host, m.rpc_port))
            if warm_block and m.block_port:
                addrs.append((m.rpc_host, m.block_port))
        with self._prewarm_lock:
            todo = [a for a in addrs if a not in self._prewarmed]
            self._prewarmed.update(todo)
        if not todo:
            return
        threading.Thread(target=self._prewarm_dial, args=(todo,),
                         daemon=True,
                         name=f"prewarm-"
                              f"{self.manager_id.executor_id.executor}"
                         ).start()

    def _prewarm_dial(self, addrs) -> None:
        for host, port in addrs:
            if self._stopping or self.server.stopped:
                return
            try:
                conn = self._clients.get(host, port)
                if self._stopping:
                    # stop() raced the dial: either close_all() drained
                    # the cache after our insert (conn already closed),
                    # or it ran before — then this close is ours to do,
                    # or the socket + reader thread outlive the endpoint
                    conn.close()
                    return
                self.prewarm_dials += 1
            except TransportError as e:
                # un-mark so the next announce retries; the lazy fetch
                # path stays the correctness backstop either way
                with self._prewarm_lock:
                    self._prewarmed.discard((host, port))
                log.debug("prewarm of %s:%s failed: %s", host, port, e)

    # -- serving peers ---------------------------------------------------

    def _handle(self, conn: Connection, msg: RpcMsg) -> Optional[RpcMsg]:
        if isinstance(msg, AnnounceMsg):
            with self._members_lock:
                # Total order by driver epoch: stale snapshots (racing
                # announce threads, reordered delivery) never overwrite a
                # newer tombstoned list.
                if msg.epoch > self._announce_epoch:
                    self._announce_epoch = msg.epoch
                    self._members = list(msg.manager_ids)
            self._members_event.set()
            if self.conf.pre_warm_connections:
                self._prewarm_peers()
            self._watch_pending_joiners()
            return None
        if isinstance(msg, M.MembershipBumpMsg):
            self._on_membership_bump(msg)
            return None
        if isinstance(msg, M.TakeoverMsg):
            # driver failover: re-point the driver channel, forward-only
            # under the incarnation comparison (a zombie's stale
            # broadcast loses). In-flight retry loops re-read the
            # address every attempt, so nothing else needs to notice.
            if self.driver.note_takeover(msg.incarnation, msg.host,
                                         msg.port):
                log.info("driver takeover observed: incarnation %d at "
                         "%s:%d", msg.incarnation, msg.host, msg.port)
            return None
        if isinstance(msg, M.DrainReq):
            # NOT the serve pool: the replication pass can run for up to
            # drain_deadline_ms and must not starve block serving —
            # same contract as the finalize handler
            threading.Thread(
                target=self._on_drain, args=(conn, msg), daemon=True,
                name=f"drain-{self.manager_id.executor_id.executor}"
            ).start()
            return None
        if isinstance(msg, M.EpochBumpMsg):
            self._on_epoch_bump(msg)
            return None
        if isinstance(msg, M.TenantMapMsg):
            self.note_tenant(msg.shuffle_id, msg.tenant)
            from sparkrdma_tpu_torch.shuffle import dist_cache
            dist_cache.set_tenant(msg.shuffle_id, msg.tenant)
            src = self.data_source
            if src is not None and hasattr(src, "note_tenant"):
                src.note_tenant(msg.shuffle_id, msg.tenant)
            if self.merge_store is not None:
                # a fresh registration reusing a dropped id re-arms the
                # merge target (same FIFO channel as the unregister)
                self.merge_store.note_registered(msg.shuffle_id)
            if self.pushed_store is not None:
                self.pushed_store.note_registered(msg.shuffle_id)
            if self.tiering is not None:
                self.tiering.note_registered(msg.shuffle_id)
            self.location_plane.note_registered(msg.shuffle_id)
            return None
        if isinstance(msg, M.ReducePlanMsg):
            self._on_reduce_plan(msg)
            return None
        if isinstance(msg, M.ShardMapMsg):
            from sparkrdma_tpu_torch.shuffle.location_plane import ShardMap
            # a pushed shard map is a registration signal: it re-arms a
            # dead id (same FIFO channel as the unregister push)
            self.location_plane.note_registered(msg.shuffle_id)
            if self.merge_store is not None:
                self.merge_store.note_registered(msg.shuffle_id)
            if self.pushed_store is not None:
                self.pushed_store.note_registered(msg.shuffle_id)
            if self.tiering is not None:
                self.tiering.note_registered(msg.shuffle_id)
            accepted = self.location_plane.put_shard_map(
                msg.shuffle_id, ShardMap(msg.num_maps, msg.shard_slots),
                msg.epoch)
            if accepted and self.shard_owner is not None:
                self._on_shard_assignment(msg.shuffle_id, msg.epoch)
            return None
        if isinstance(msg, M.ShardEntryMsg):
            self._on_shard_entry(msg)
            return None
        if isinstance(msg, M.FetchShardReq):
            return self._on_fetch_shard(conn, msg)
        if isinstance(msg, M.ShardPublishMsg):
            self._on_shard_publish(msg)
            return None
        if isinstance(msg, M.ShardMergedPublishMsg):
            self._on_shard_merged_publish(msg)
            return None
        if isinstance(msg, M.ShardOpMsg):
            if self.shard_standby is not None:
                self.shard_standby.ingest(msg.shuffle_id, msg.shard,
                                          msg.owner_gen, msg.seq,
                                          msg.kind, msg.blob)
            return None
        if isinstance(msg, M.ShardHandoffMsg):
            self._on_shard_handoff(msg)
            return None
        if isinstance(msg, M.FetchOutputReq):
            return self._on_fetch_output(msg)
        if isinstance(msg, M.FetchOutputsReq):
            return self._on_fetch_outputs(msg)
        if isinstance(msg, M.FetchBlocksReq):
            if not self.conf.sw_flow_control:
                return self._on_fetch_blocks(msg)
            self._serve_blocks_async(conn, msg)
            return None
        if isinstance(msg, M.PushBlocksReq):
            self._serve_async(self._on_push_blocks, conn, msg)
            return None
        if isinstance(msg, M.PushPlannedReq):
            self._serve_async(self._on_push_planned, conn, msg)
            return None
        if isinstance(msg, M.FinalizeSegmentsReq):
            # NOT the serve pool: the quiesce wait can hold a worker for
            # up to push_deadline_ms, and the pool is shared with
            # foreground block serving — finalize is once per (shuffle,
            # target), a dedicated short-lived thread is cheap
            threading.Thread(
                target=self._on_finalize_segments, args=(conn, msg),
                daemon=True,
                name=f"finalize-{self.manager_id.executor_id.executor}"
            ).start()
            return None
        if isinstance(msg, M.CreditReport):
            self._credits_of(conn).release(msg.consumed)
            return None
        if isinstance(msg, M.FetchBlocksResp):
            self._on_orphan_blocks_resp(conn, msg)
            return None
        if isinstance(msg, M.RunTaskReq):
            return self._on_run_task(conn, msg)
        if isinstance(msg, M.PingMsg):
            return M.PongMsg(msg.req_id)
        if isinstance(msg, M.PongMsg):
            return None  # pong landed after its ping's deadline: stale
        if isinstance(msg, (M.FetchOutputResp, M.FetchOutputsResp,
                            M.FetchTableResp, M.FetchShardResp,
                            M.FetchPlanResp, M.PushBlocksResp,
                            M.PushPlannedResp, M.FinalizeSegmentsResp,
                            M.FetchMergedResp, M.DrainResp)):
            # orphan of a cancelled/timed-out request (the fetcher
            # cancels whole read-ahead windows on failure); unlike block
            # responses these carry no credits, so dropping is complete
            log.debug("%s: stale %s (requester gave up)",
                      self.manager_id.executor_id.executor,
                      type(msg).__name__)
            return None
        log.warning("%s: unexpected %s", self.manager_id.executor_id.executor,
                    type(msg).__name__)
        return None

    # -- task shipping ---------------------------------------------------

    def set_task_runner(self, runner) -> None:
        """Install ``runner(payload bytes) -> (status, result bytes)``; it
        runs on a bounded worker pool (a task must never run on the
        connection's reader thread — it would block the control plane,
        including the publishes its own writes produce)."""
        from concurrent.futures import ThreadPoolExecutor

        self._task_runner = runner
        if self._task_pool is None:
            self._task_pool = ThreadPoolExecutor(
                max_workers=self.conf.task_threads,
                thread_name_prefix=f"task-{self.manager_id.executor_id.executor}")

    def _on_run_task(self, conn: Connection,
                     msg: M.RunTaskReq) -> Optional[RpcMsg]:
        runner = self._task_runner
        if runner is None or self._task_pool is None:
            return M.RunTaskResp(msg.req_id, M.TASK_NO_RUNNER, b"")

        def work():
            try:
                status, result = runner(msg.data)
            except BaseException as e:  # noqa: BLE001 — even SystemExit
                # from a shipped task must produce a response; a silent
                # swallow leaves the driver waiting out task_timeout_ms
                status, result = M.TASK_ERROR, repr(e).encode()
            try:
                conn.send(M.RunTaskResp(msg.req_id, status, result))
            except TransportError as e:
                log.warning("task response lost (driver gone?): %s", e)

        self._task_pool.submit(work)
        return None  # answered by the worker when the task finishes

    # -- metadata plane (epoch pushes + shard replicas) ------------------

    def _on_epoch_bump(self, msg: M.EpochBumpMsg) -> None:
        """A pushed invalidation: the shuffle's location state moved (or
        died). Epoch-validated caches — location views here, warm
        partition ranges in dist_cache — refresh on their next read
        instead of serving a dead executor's locations."""
        invalidated = self.location_plane.note_epoch(msg.shuffle_id,
                                                     msg.epoch)
        if self.pushed_store is not None and msg.epoch != M.EPOCH_DEAD:
            # a location-epoch ADVANCE names a recovery event: staged
            # pushed ranges conservatively drop (a corrupt-output repair
            # may rewrite bytes; re-pushes re-stage under new fences)
            self.pushed_store.on_location_epoch(msg.shuffle_id, msg.epoch)
        if msg.epoch == M.EPOCH_DEAD:
            self.shard_store.drop(msg.shuffle_id)
            self._expire_shard_waiters(msg.shuffle_id)
            if self.shard_owner is not None:
                # owned ranges, buffered op streams, unconverged batches
                # and the republish backstop all die with the shuffle
                self.shard_owner.drop(msg.shuffle_id)
                self.shard_standby.drop(msg.shuffle_id)
                with self._shard_batch_lock:
                    for k in [k for k in self._shard_batches
                              if k[0] == msg.shuffle_id]:
                        del self._shard_batches[k]
                with self._republish_lock:
                    self._republish.pop(msg.shuffle_id, None)
            if self.merge_store is not None:
                # merged segments + overflow blobs die with the shuffle
                self.merge_store.drop_shuffle(msg.shuffle_id)
            if self.pushed_store is not None:
                # staged pushed ranges die with the shuffle too
                self.pushed_store.drop_shuffle(msg.shuffle_id)
            if self.tiering is not None:
                # cold blobs reap through the same tombstone discipline:
                # an upload racing this death deletes its own blob and
                # skips the publish (modelcheck tier_vs_unregister)
                self.tiering.drop_shuffle(msg.shuffle_id)
            src = self.data_source
            if src is not None and hasattr(src, "remove_shuffle"):
                # shuffle TTL/GC: a driver-side unregister (explicit or
                # TTL sweep) reaps this executor's committed outputs
                # too — on the serve pool, never the reader thread
                # (remove_shuffle unlinks files). Idempotent with the
                # local manager.unregister_shuffle path.
                self._ensure_serve_pool().submit(
                    self._reap_shuffle_disk, src, msg.shuffle_id)
            # terminal: forget the tenant mapping too (a long-running
            # service churning TTL'd shuffles must not leak one dict
            # entry per dead shuffle; re-register re-teaches it)
            with self._tenant_lock:
                self._tenant_map.pop(msg.shuffle_id, None)
        from sparkrdma_tpu_torch.shuffle import dist_cache
        dist_cache.on_epoch(msg.shuffle_id, msg.epoch)
        if invalidated:
            self.tracer.instant("meta.epoch_bump", "meta",
                                shuffle=msg.shuffle_id, epoch=msg.epoch)

    @staticmethod
    def _reap_shuffle_disk(src, shuffle_id: int) -> None:
        try:
            src.remove_shuffle(shuffle_id)
        except Exception:  # noqa: BLE001 — GC must never kill serving
            log.exception("GC reap of shuffle %d failed", shuffle_id)

    def _on_reduce_plan(self, msg: "M.ReducePlanMsg") -> None:
        """A pushed reduce plan (initial publish or mid-stage re-plan):
        cache it for cache-first resolution, and when it REPLACES an
        older epoch's plan invalidate plan-keyed warm state — a re-plan
        re-carves the reduce ranges, so warm bytes cached under the old
        carve-up must never serve (``dist_cache.on_plan_epoch``)."""
        from sparkrdma_tpu_torch.shuffle.planner import ReducePlan
        try:
            plan = ReducePlan.from_bytes(msg.plan_bytes)
        except (struct.error, ValueError) as e:
            log.warning("%s: undecodable reduce plan push: %s",
                        self.manager_id.executor_id.executor, e)
            return
        # a pushed plan names a LIVE shuffle: like the other
        # registration pushes it re-arms a dead/dropped reused id (same
        # FIFO channel as the unregister push). Response-path plans
        # (get_reduce_plan's pull) deliberately don't.
        self.location_plane.note_registered(plan.shuffle_id)
        if self.merge_store is not None:
            self.merge_store.note_registered(plan.shuffle_id)
        if self.tiering is not None:
            self.tiering.note_registered(plan.shuffle_id)
        accepted = self.location_plane.put_plan(plan.shuffle_id, plan)
        if not accepted:
            return  # stale reordered push: must not touch warm state
        if self.pushed_store is not None:
            # adopt the plan epoch: staged ranges a re-plan orphaned are
            # released here (their new slots get the replayed pushes)
            self.pushed_store.on_plan(plan.shuffle_id, plan.plan_epoch)
        if self.on_plan_cb is not None:
            # the planned pusher replays submitted maps against the
            # fresh plan (late-arriving plan, or re-plan re-routing)
            try:
                self.on_plan_cb(plan.shuffle_id)
            except Exception:  # noqa: BLE001 — a replay failure must
                # not drop the plan push (maps stay pull-fetched)
                log.exception("planned-push replay for shuffle %d failed",
                              plan.shuffle_id)
        from sparkrdma_tpu_torch.shuffle import dist_cache
        dist_cache.on_plan_epoch(plan.shuffle_id, plan.plan_epoch)
        if plan.plan_epoch > 1:
            self.tracer.instant("plan.replan", "plan",
                                shuffle=plan.shuffle_id,
                                epoch=plan.plan_epoch)

    def get_reduce_plan(self, shuffle_id: int, timeout: float = 5.0):
        """Cache-first ReducePlan resolution: the pushed plan in the
        location plane when present, else ONE pull from the driver
        (``FetchPlanReq`` — the lost-push backstop). Returns None when
        no plan exists (adaptive planning off, or the map stage hasn't
        completed): callers run the identity plan."""
        cached = self.location_plane.plan(shuffle_id)
        if cached is not None:
            return cached
        from sparkrdma_tpu_torch.shuffle.planner import ReducePlan
        try:
            resp = self.driver.request(
                lambda c: M.FetchPlanReq(c.next_req_id(), shuffle_id),
                timeout=timeout)
        except (TransportError, TimeoutError) as e:
            log.debug("reduce-plan fetch for shuffle %d failed: %s",
                      shuffle_id, e)
            return None
        assert isinstance(resp, M.FetchPlanResp)
        if resp.status != M.STATUS_OK:
            return None
        plan = ReducePlan.from_bytes(resp.plan_bytes)
        if self.location_plane.put_plan(shuffle_id, plan):
            from sparkrdma_tpu_torch.shuffle import dist_cache
            dist_cache.on_plan_epoch(shuffle_id, plan.plan_epoch)
        return plan

    def _on_shard_entry(self, msg: M.ShardEntryMsg) -> None:
        self.shard_store.apply(msg.shuffle_id, msg.epoch, msg.map_id,
                               msg.num_maps, msg.entry)
        # wake any shard long-poller this entry satisfies (push, not
        # client polling — the driver's waiter contract, at shard scale)
        ready = []
        with self._shard_waiters_lock:
            pending = self._shard_waiters.get(msg.shuffle_id)
            if pending:
                still = []
                for w in pending:
                    conn, req_id, lo, hi, min_pub, _deadline = w
                    n = self.shard_store.count_in(msg.shuffle_id, lo, hi)
                    if n is not None and n >= min_pub:
                        ready.append(w)
                    else:
                        still.append(w)
                if still:
                    self._shard_waiters[msg.shuffle_id] = still
                else:
                    self._shard_waiters.pop(msg.shuffle_id, None)
        for conn, req_id, lo, hi, _min_pub, _deadline in ready:
            self._answer_shard_waiter(msg.shuffle_id, conn, req_id, lo, hi)

    def _answer_shard_waiter(self, shuffle_id: int, conn: Connection,
                             req_id: int, lo: int, hi: int) -> None:
        res = self.shard_store.read_range(shuffle_id, lo, hi)
        if res is None:
            resp = M.FetchShardResp(req_id, -1, 0, b"")
        else:
            n, epoch, data = res
            resp = M.FetchShardResp(req_id, n, epoch, data)
        try:
            conn.send(resp)
        except TransportError as e:
            log.debug("shard long-poll answer failed: %s", e)

    def _on_fetch_shard(self, conn: Connection,
                        msg: M.FetchShardReq) -> Optional[RpcMsg]:
        """Serve one driver-table map-range out of this executor's shard
        replica — the fan-in distribution half of the sharded metadata
        plane. Long-poll semantics mirror the driver's table fetch:
        unsatisfiable requests park as waiters answered by the entry
        forward that satisfies them (or swept at deadline with the
        partial range)."""
        res = self.shard_store.read_range(msg.shuffle_id, msg.map_lo,
                                          msg.map_hi)
        if res is None:
            # no replica here (never assigned, or dropped): the client
            # falls back to the authoritative driver table
            return M.FetchShardResp(msg.req_id, -1, 0, b"")
        n, epoch, data = res
        if n >= msg.min_published or msg.timeout_ms <= 0:
            return M.FetchShardResp(msg.req_id, n, epoch, data)
        deadline = time.monotonic() + msg.timeout_ms / 1000
        with self._shard_waiters_lock:
            self._shard_waiters.setdefault(msg.shuffle_id, []).append(
                (conn, msg.req_id, msg.map_lo, msg.map_hi,
                 msg.min_published, deadline))
        self._ensure_park_sweeper()  # the shared sweeper expires these
        return None

    def _expire_shard_waiters(self, shuffle_id: Optional[int] = None,
                              now: Optional[float] = None) -> None:
        """Answer shard waiters that expired (``now``) or whose shuffle
        died (``shuffle_id``) with the partial range — the terminal
        status contract of the driver's sweeper, at shard scale."""
        expired = []
        with self._shard_waiters_lock:
            for sid, pending in list(self._shard_waiters.items()):
                if shuffle_id is not None and sid != shuffle_id:
                    continue
                if shuffle_id is not None:
                    dead, live = pending, []
                else:
                    dead = [w for w in pending if w[5] <= now]
                    live = [w for w in pending if w[5] > now]
                if dead:
                    expired.extend((sid, w) for w in dead)
                    if live:
                        self._shard_waiters[sid] = live
                    else:
                        self._shard_waiters.pop(sid, None)
        for sid, (conn, req_id, lo, hi, _min_pub, _dl) in expired:
            self._answer_shard_waiter(sid, conn, req_id, lo, hi)

    # -- partitioned metadata ownership (shuffle/shard_plane.py) ---------

    def _my_slot(self) -> int:
        """This executor's membership slot, or -1 pre-announce. The
        announce always precedes any shard assignment on the same FIFO
        driver channel, so a real owner resolves by the time an
        assignment can name it; -1 callers degrade to the driver path."""
        with self._members_lock:
            for i, m in enumerate(self._members):
                if m == self.manager_id:
                    return i
        return -1

    def _on_shard_assignment(self, shuffle_id: int, gen: int) -> None:
        """An accepted (generation-forward) shard assignment: adopt the
        ranges this slot now owns, seal + flush the ones it no longer
        does, and re-aim buffered publishes (the handoff backstop)."""
        smap = self.location_plane.shard_map(shuffle_id)
        me = self._my_slot()
        if smap is None or me < 0:
            return
        owned_now = {sh for sh in range(smap.num_shards)
                     if smap.shard_slots[sh] == me}
        for sh in self.shard_owner.owned_shards(shuffle_id):
            if sh not in owned_now and \
                    (self.shard_owner.gen_of(shuffle_id, sh) or 0) < gen:
                self.shard_owner.seal(shuffle_id, sh)
        for sh in owned_now:
            lo, hi = smap.range_of(sh)
            self.shard_owner.adopt(shuffle_id, sh, lo, hi,
                                   smap.num_maps, gen)
        # flush + republish OFF the driver reader thread: both dial
        # peers, and the reader must stay free to drain pushes
        self._ensure_serve_pool().submit(self._flush_shard_batches,
                                         shuffle_id)
        with self._republish_lock:
            buffered = bool(self._republish.get(shuffle_id))
        if buffered:
            self._ensure_serve_pool().submit(self._republish_shuffle,
                                             shuffle_id)

    def _on_shard_handoff(self, msg: "M.ShardHandoffMsg") -> None:
        """Ownership of (shuffle, shard) moved. Outgoing owner (alive —
        the drain case): seal NOW, later direct publishes bounce to the
        driver. Incoming owner: replay the standby buffer under the new
        generation — the records re-run the full owner apply (store +
        serve replica + stream + batch), so nothing the dead owner had
        logged is lost and the driver batch echo stays idempotent."""
        if self.shard_owner is None:
            return
        sid, shard = msg.shuffle_id, msg.shard
        me = self._my_slot()
        if me < 0:
            return
        if msg.old_slot == me:
            self.shard_owner.seal(sid, shard)
            self._ensure_serve_pool().submit(self._flush_shard_batches,
                                             sid)
        if msg.new_slot == me and self.shard_standby is not None:
            from sparkrdma_tpu_torch.shuffle import ha
            records = self.shard_standby.take(sid, shard)
            for kind, blob in records:
                if kind == ha.SHARD_OP_PUBLISH:
                    map_id, fence, entry, lengths = \
                        ha.unpack_shard_publish(blob)
                    self._owner_publish(sid, map_id, entry, fence,
                                        msg.owner_gen, lengths)
                elif kind == ha.SHARD_OP_MERGED:
                    self._owner_merged(sid, shard, msg.owner_gen, blob)

    def _owner_publish(self, shuffle_id: int, map_id: int, entry: bytes,
                       fence: int, gen: int, lengths=None) -> bool:
        """Owner-side apply of one direct publish: fence CAS + log in
        the owner store (log-before-apply), serve-replica apply + waiter
        wake, op stream to the standby, batch toward the driver. False =
        not applied here (caller forwards to the driver); a FENCED
        zombie returns True — handled, deliberately not forwarded."""
        from sparkrdma_tpu_torch.shuffle import shard_plane
        owner = self.shard_owner
        if owner is None:
            return False
        shard = owner.shard_for(shuffle_id, map_id)
        if shard is None:
            return False
        status, rec = owner.publish(shuffle_id, shard, map_id, entry,
                                    fence, gen, lengths)
        # analysis: epoch-eq-ok(FENCED is a write-path status code, not a version; exact match selects the handled-no-forward outcome)
        if status == shard_plane.FENCED:
            return True
        if status != shard_plane.APPLIED:
            return False
        smap = self.location_plane.shard_map(shuffle_id)
        num_maps = smap.num_maps if smap is not None else map_id + 1
        epoch = self.location_plane.known_epoch(shuffle_id) or 1
        self._on_shard_entry(M.ShardEntryMsg(shuffle_id, epoch, map_id,
                                             num_maps, entry))
        self._stream_shard_op(shuffle_id, shard, gen, rec)
        self._queue_shard_batch(shuffle_id, shard, gen,
                                record=(map_id, fence, entry, lengths))
        return True

    def _owner_merged(self, shuffle_id: int, shard: int, gen: int,
                      blob: bytes) -> bool:
        from sparkrdma_tpu_torch.shuffle import shard_plane
        owner = self.shard_owner
        if owner is None:
            return False
        status, rec = owner.merged(shuffle_id, shard, gen, blob)
        if status != shard_plane.APPLIED:
            return False
        self._stream_shard_op(shuffle_id, shard, gen, rec)
        self._queue_shard_batch(shuffle_id, shard, gen, blob=blob)
        return True

    def _on_shard_publish(self, msg: "M.ShardPublishMsg") -> None:
        """A direct-to-owner publish (the one-hop write path). Not
        applicable here — stale map at the sender, sealed shard, a
        handoff won the race — forwards to the driver: the stale view
        costs one extra hop, never a lost entry."""
        if self._owner_publish(msg.shuffle_id, msg.map_id, msg.entry,
                               msg.fence, msg.owner_gen, msg.lengths):
            return
        try:
            self.driver.send(M.PublishMsg(msg.shuffle_id, msg.map_id,
                                          msg.entry, fence=msg.fence,
                                          lengths=msg.lengths))
        except TransportError as e:
            log.debug("non-owner publish forward for shuffle %d map %d "
                      "failed: %s", msg.shuffle_id, msg.map_id, e)

    def _on_shard_merged_publish(self,
                                 msg: "M.ShardMergedPublishMsg") -> None:
        if self._owner_merged(msg.shuffle_id, msg.shard, msg.owner_gen,
                              msg.blob):
            return
        try:
            inner = M.MergedPublishMsg.from_payload(msg.blob)
        except (struct.error, ValueError, IndexError) as e:
            log.warning("undecodable merged blob routed at shuffle %d "
                        "shard %d: %s", msg.shuffle_id, msg.shard, e)
            return
        try:
            self.driver.send(inner)
        except TransportError as e:
            log.debug("non-owner merged forward for shuffle %d failed: "
                      "%s", msg.shuffle_id, e)

    def _shard_standby_peer(self, shuffle_id: int, shard: int):
        """Deterministic standby for an owned shard: the NEXT shard's
        owner slot (wrapping) — a distinct live host whenever the
        assignment has more than one shard. None for single-shard maps
        (the driver batch is the only backstop there, which is the
        pre-ownership durability story)."""
        smap = self.location_plane.shard_map(shuffle_id)
        if smap is None or smap.num_shards < 2:
            return None
        slot = smap.shard_slots[(shard + 1) % smap.num_shards]
        if slot == self._my_slot():
            return None
        try:
            return self.member_at(slot)
        except (DeadExecutorError, IndexError):
            return None

    def _stream_shard_op(self, shuffle_id: int, shard: int, gen: int,
                         rec) -> None:
        peer = self._shard_standby_peer(shuffle_id, shard)
        if peer is None:
            return
        try:
            conn = self._clients.get(peer.rpc_host, peer.rpc_port)
            conn.send(M.ShardOpMsg(shuffle_id, shard, gen, rec.seq,
                                   rec.kind, rec.payload))
        except TransportError as e:
            # one-attempt like every push; the driver batch still
            # converges, so a lost stream record degrades failover
            # freshness, never correctness
            log.debug("shard op stream for shuffle %d shard %d failed: "
                      "%s", shuffle_id, shard, e)

    def _queue_shard_batch(self, shuffle_id: int, shard: int, gen: int,
                           record=None, blob=None) -> None:
        """Stage one applied write for driver convergence; flush at
        shard_batch_entries (the flusher thread drains partials)."""
        out = []
        with self._shard_batch_lock:
            key = (shuffle_id, shard)
            cur = self._shard_batches.get(key)
            if cur is None or cur[0] != gen:
                if cur is not None and (cur[1] or cur[2]):
                    out.append(M.ShardBatchMsg(shuffle_id, shard, cur[0],
                                               cur[1], cur[2]))
                cur = (gen, [], [])
                self._shard_batches[key] = cur
            if record is not None:
                cur[1].append(record)
            if blob is not None:
                cur[2].append(blob)
            if len(cur[1]) + len(cur[2]) >= self.conf.shard_batch_entries:
                out.append(M.ShardBatchMsg(shuffle_id, shard, gen,
                                           cur[1], cur[2]))
                del self._shard_batches[key]
        for m in out:
            try:
                self.driver.send(m)
            except TransportError as e:
                log.warning("shard batch for shuffle %d failed: %s",
                            shuffle_id, e)
        self._ensure_shard_flusher()

    def _flush_shard_batches(self,
                             shuffle_id: Optional[int] = None) -> None:
        with self._shard_batch_lock:
            keys = [k for k in self._shard_batches
                    if shuffle_id is None or k[0] == shuffle_id]
            out = []
            for k in keys:
                gen, recs, blobs = self._shard_batches.pop(k)
                if recs or blobs:
                    out.append(M.ShardBatchMsg(k[0], k[1], gen, recs,
                                               blobs))
        for m in out:
            try:
                self.driver.send(m)
            except TransportError as e:
                log.warning("shard batch flush for shuffle %d failed: %s",
                            m.shuffle_id, e)

    def _ensure_shard_flusher(self) -> None:
        if self._shard_flusher is not None or self._stopping:
            return
        with self._shard_batch_lock:
            if self._shard_flusher is not None:
                return
            t = threading.Thread(
                target=self._shard_flush_loop, daemon=True,
                name=f"shard-flush-{self.manager_id.executor_id.executor}")
            self._shard_flusher = t
        t.start()

    def _shard_flush_loop(self) -> None:
        # partial-batch drain every 10ms: convergence lag toward the
        # driver stays bounded even when publishes trickle in below the
        # batch threshold
        while not self._stopping:
            self._shard_flush_wake.wait(timeout=0.01)
            self._shard_flush_wake.clear()
            if self._stopping:
                return
            self._flush_shard_batches()

    def _send_owner_publish(self, shuffle_id: int, map_id: int,
                            entry: bytes, fence: int, lengths) -> bool:
        """Route a publish straight to its map-range OWNER — one hop,
        no driver round-trip ("RPC Considered Harmful": the destination
        is known ahead of time). Remembers the publish for handoff
        republish first, so no window exists where a dying owner is the
        only holder. False = caller sends the ordinary driver publish."""
        if self.shard_owner is None:
            return False
        smap_v = self.location_plane.shard_map_v(shuffle_id)
        if smap_v is None:
            return False
        smap, gen = smap_v
        with self._republish_lock:
            self._republish.setdefault(shuffle_id, {})[map_id] = (
                entry, fence, list(lengths) if lengths is not None
                else None)
        try:
            shard = smap.shard_of(map_id)
        except IndexError:
            return False
        slot = smap.shard_slots[shard]
        if slot == self._my_slot():
            return self._owner_publish(shuffle_id, map_id, entry, fence,
                                       gen, lengths)
        try:
            peer = self.member_at(slot)
            conn = self._clients.get(peer.rpc_host, peer.rpc_port)
            conn.send(M.ShardPublishMsg(shuffle_id, map_id, entry,
                                        fence, gen, lengths))
            return True
        except (DeadExecutorError, IndexError, TransportError) as e:
            log.debug("direct publish for shuffle %d map %d fell back "
                      "to the driver: %s", shuffle_id, map_id, e)
            return False

    def _republish_shuffle(self, shuffle_id: int) -> None:
        """Handoff backstop: re-aim this publisher's remembered
        publishes at the (new) owners. Fence floors make duplicates
        no-ops; a publish that died in a killed owner's socket gets
        re-delivered — a metadata re-send, never a map re-execution."""
        with self._republish_lock:
            buffered = dict(self._republish.get(shuffle_id, {}))
        for map_id, (entry, fence, lengths) in buffered.items():
            if self._send_owner_publish(shuffle_id, map_id, entry, fence,
                                        lengths):
                continue
            try:
                self.driver.send(M.PublishMsg(shuffle_id, map_id, entry,
                                              fence=fence,
                                              lengths=lengths))
            except TransportError as e:
                log.debug("republish of shuffle %d map %d failed: %s",
                          shuffle_id, map_id, e)

    def _send_owner_merged(self, msg: "M.MergedPublishMsg") -> bool:
        """Route a merged-directory publish to the owner of shard
        ``partition % num_shards`` (deterministic spread — merged
        segments aren't map-range keyed, so any stable rule works).
        False = caller sends it to the driver directly."""
        if self.shard_owner is None:
            return False
        smap_v = self.location_plane.shard_map_v(msg.shuffle_id)
        if smap_v is None:
            return False
        smap, gen = smap_v
        shard = msg.partition_id % smap.num_shards
        blob = msg.payload()
        slot = smap.shard_slots[shard]
        if slot == self._my_slot():
            return self._owner_merged(msg.shuffle_id, shard, gen, blob)
        try:
            peer = self.member_at(slot)
            conn = self._clients.get(peer.rpc_host, peer.rpc_port)
            conn.send(M.ShardMergedPublishMsg(msg.shuffle_id, shard, gen,
                                              blob))
            return True
        except (DeadExecutorError, IndexError, TransportError) as e:
            log.debug("owner-routed merged publish for shuffle %d fell "
                      "back to the driver: %s", msg.shuffle_id, e)
            return False

    def _publish_merged(self, msg: "M.MergedPublishMsg") -> None:
        """The merge finalizer's publish callback: owner-routed in
        ownership mode, driver-direct otherwise. When the cold tier is
        on, the SAME descriptor also enqueues a background upload —
        the tiering service reads the sealed ranges back through the
        serve path and publishes the blob one-sided when it lands."""
        if self.tiering is not None:
            self.tiering.submit(msg)
        if self._send_owner_merged(msg):
            return
        self.driver.send(msg)

    def _publish_tiered(self, msg: "M.TieredPublishMsg") -> None:
        """The tiering service's publish callback: driver-direct and
        one-sided (the directory is HA-replicated driver-side)."""
        self.driver.send(msg)

    def _corrupt_served(self, shuffle_id: int, map_id: int,
                        detail: str) -> None:
        """Audit a serve that found at-rest corruption (the resolver
        already quarantined the output)."""
        self.tracer.instant("serve.corrupt", "fault", shuffle=shuffle_id,
                            map=map_id, detail=detail)
        log.error("%s: serving shuffle %d map %d found corrupt committed "
                  "output (%s); answering STATUS_CORRUPT so the reducer "
                  "re-executes the map",
                  self.manager_id.executor_id.executor, shuffle_id, map_id,
                  detail)

    def _on_fetch_output(self, msg: M.FetchOutputReq) -> RpcMsg:
        """Serve 16B location entries
        (scala/RdmaShuffleFetcherIterator.scala:293-315 analogue)."""
        if self.data_source is None:
            return M.FetchOutputResp(msg.req_id, M.STATUS_ERROR, b"")
        from sparkrdma_tpu_torch.utils.integrity import CorruptOutputError
        try:
            table = self.data_source.get_output_table(msg.shuffle_id,
                                                      msg.map_id)
        except CorruptOutputError as e:
            self._corrupt_served(msg.shuffle_id, msg.map_id, str(e))
            return M.FetchOutputResp(msg.req_id, M.STATUS_CORRUPT, b"")
        except OSError as e:
            # transient disk error in the serve-time verify: answer the
            # retryable class — an unanswered request would burn the
            # requester's whole deadline instead of one backoff
            log.warning("location serve failed for shuffle %d map %d: %s",
                        msg.shuffle_id, msg.map_id, e)
            return M.FetchOutputResp(msg.req_id, M.STATUS_ERROR, b"")
        if table is None:
            return M.FetchOutputResp(msg.req_id, M.STATUS_UNKNOWN_MAP, b"")
        if not (0 <= msg.start_partition <= msg.end_partition <= table.num_partitions):
            return M.FetchOutputResp(msg.req_id, M.STATUS_BAD_RANGE, b"")
        return M.FetchOutputResp(msg.req_id, M.STATUS_OK,
                                 table.get_range(msg.start_partition, msg.end_partition))

    def _on_fetch_outputs(self, msg: M.FetchOutputsReq) -> RpcMsg:
        """Serve MANY maps' 16B location entries in one response (the
        batched metadata read of the coalesced dataplane). Per-map
        statuses answer each map authoritatively — one unpublished map
        doesn't hide the others' entries — while structural problems
        (no data source, a response past the payload cap) fail the whole
        request."""
        if self.data_source is None:
            return M.FetchOutputsResp(msg.req_id, M.STATUS_ERROR, [])
        from sparkrdma_tpu_torch.shuffle.map_output import ENTRY_SIZE

        span = msg.end_partition - msg.start_partition
        if (msg.start_partition < 0 or span < 0
                or span * ENTRY_SIZE * max(1, len(msg.map_ids))
                > self._MAX_RESP_PAYLOAD):
            return M.FetchOutputsResp(msg.req_id, M.STATUS_BAD_RANGE, [])
        from sparkrdma_tpu_torch.utils.integrity import CorruptOutputError
        records = []
        for map_id in msg.map_ids:
            try:
                table = self.data_source.get_output_table(msg.shuffle_id,
                                                          map_id)
            except CorruptOutputError as e:
                self._corrupt_served(msg.shuffle_id, map_id, str(e))
                records.append((map_id, M.STATUS_CORRUPT, b""))
                continue
            except OSError as e:
                log.warning("location serve failed for shuffle %d map %d: "
                            "%s", msg.shuffle_id, map_id, e)
                records.append((map_id, M.STATUS_ERROR, b""))
                continue
            if table is None:
                records.append((map_id, M.STATUS_UNKNOWN_MAP, b""))
            elif not (msg.start_partition <= msg.end_partition
                      <= table.num_partitions):
                records.append((map_id, M.STATUS_BAD_RANGE, b""))
            else:
                records.append((map_id, M.STATUS_OK, table.get_range(
                    msg.start_partition, msg.end_partition)))
        return M.FetchOutputsResp(msg.req_id, M.STATUS_OK, records)

    # Response-payload caps, mirroring the native server's kMaxRespPayload:
    # reject before reading so an oversized request can't build a frame the
    # client Reassembler drops (>1 GiB tears down the shared pipelined
    # connection) or that wraps the u32 frame length past 4 GiB. Multi-
    # block groups are client-capped at shuffle_read_block_size, so the cap
    # tracks that config (floor 256 MiB, matching the native server); a
    # group with at most one non-empty block (the fetcher's oversized-fetch
    # escape, shuffle/fetcher.py:291 — possibly with zero-length riders) is
    # allowed up to a Reassembler-safe bound.
    _MAX_RESP_PAYLOAD = 256 << 20
    _MAX_SINGLE_BLOCK = (1 << 30) - (1 << 20)

    def _credits_of(self, conn: Connection) -> ByteCredits:
        with self._credits_lock:
            credits = self._conn_credits.get(conn)
            if credits is None:
                credits = ByteCredits(self.conf.serve_credit_bytes)
                self._conn_credits[conn] = credits
            return credits

    def serve_stats(self) -> dict:
        """Audit view of the serving windows (tests assert a stalled
        consumer bounds server-held bytes; ops dashboards watch parking)."""
        with self._credits_lock:
            creds = list(self._conn_credits.values())
        return {
            "budget": self.conf.serve_credit_bytes,
            "peak_reserved": max((c.peak_reserved for c in creds),
                                 default=0),
            "parked": sum(c.parked for c in creds),
            "credit_timeouts": self._credit_timeouts,
        }

    def _ensure_serve_pool(self):
        if self._serve_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._serve_pool_lock:
                if self._serve_pool is None:
                    self._serve_pool = ThreadPoolExecutor(
                        max_workers=self.conf.serve_threads,
                        thread_name_prefix=(
                            f"serve-{self.manager_id.executor_id.executor}"))
        return self._serve_pool

    def _serve_async(self, handler, conn: Connection, msg: RpcMsg) -> None:
        """Run one disk-touching handler on the serve pool (push-merge
        appends/finalizes share the block-serving workers — a reader
        thread must never block on disk)."""

        def work():
            try:
                handler(conn, msg)
            except Exception:  # noqa: BLE001 — serving thread must not die
                log.exception("%s handler failed", type(msg).__name__)

        self._ensure_serve_pool().submit(work)

    def _ensure_serve_drr(self):
        if self._serve_drr is None:
            from sparkrdma_tpu_torch.shuffle.tenancy import DeficitRoundRobin

            with self._serve_pool_lock:
                if self._serve_drr is None:
                    self._serve_drr = DeficitRoundRobin(
                        self.conf.fair_share_quantum_bytes)
        return self._serve_drr

    def _serve_blocks_async(self, conn: Connection,
                            msg: M.FetchBlocksReq) -> None:
        """Hand one data request to the serve pool — FIFO when fair
        share is off, else through the per-tenant DRR queue: requests
        queue under the OWNING tenant of the shuffle being served and
        each pool worker dispatches the next request by byte-cost
        deficit round robin, so one tenant's deep fan-in backlog cannot
        starve another tenant's small latency-sensitive fetch. With a
        single active tenant DRR order IS arrival order (= the FIFO
        path exactly)."""
        if not self.conf.fair_share_serving:
            self._ensure_serve_pool().submit(self._serve_blocks, conn, msg)
            return
        drr = self._ensure_serve_drr()
        cost = sum(length for _, _, length in msg.blocks)
        drr.push(self.tenant_of(msg.shuffle_id), cost, (conn, msg))
        self._ensure_serve_pool().submit(self._serve_next_fair)

    def _serve_next_fair(self) -> None:
        item = self._serve_drr.pop()
        if item is None:
            return  # a sibling worker drained the queue
        conn, msg = item
        tenant = self.tenant_of(msg.shuffle_id)
        with self._tenant_lock:
            self.fair_served[tenant] = self.fair_served.get(tenant, 0) + 1
        self.tracer.instant("tenant.serve", "tenant",
                            shuffle=msg.shuffle_id, tenant=tenant)
        self._serve_blocks(conn, msg)

    def _serve_blocks(self, conn: Connection, msg: M.FetchBlocksReq) -> None:
        """One data response under the connection's credit window: reserve
        the response's logical size BEFORE building it, send, and let the
        reader's CreditReport — sent on receipt — replenish. A request
        that doesn't fit parks as a QUEUED continuation (the serving
        thread is freed; a stalled connection can't head-of-line-block
        other connections' serving), expiring with STATUS_ERROR after the
        park timeout instead of growing server memory."""
        credits = self._credits_of(conn)
        total = sum(length for _, _, length in msg.blocks)

        def resume():  # reservation already taken by release()
            self._serve_pool.submit(self._serve_reserved, credits, conn,
                                    msg, total)

        def expire():
            self._credit_timeouts += 1
            log.warning("fetch parked past the credit window for %.1fs; "
                        "failing it (consumer stalled?)",
                        self.conf.connect_timeout_ms / 1000)
            try:
                conn.send(M.FetchBlocksResp(msg.req_id, M.STATUS_ERROR,
                                            b""))
            except TransportError:
                pass

        if credits.reserve_or_park(
                total, time.monotonic() + self.conf.connect_timeout_ms / 1000,
                resume, expire):
            self._serve_reserved(credits, conn, msg, total)
            return
        self._ensure_park_sweeper()

    def _serve_reserved(self, credits: ByteCredits, conn: Connection,
                        msg: M.FetchBlocksReq, total: int) -> None:
        try:
            resp = self._on_fetch_blocks(msg)
        except Exception:  # noqa: BLE001 — serving thread must not die
            credits.release(total)
            log.exception("block serving failed")
            return
        delivered = False
        try:
            conn.send(resp)
            delivered = True
        except TransportError:
            pass
        # non-OK responses carry no data (no report will come) and a dead
        # connection never reports: hand those credits straight back
        if resp.status != M.STATUS_OK or not delivered:
            credits.release(total)

    def _ensure_park_sweeper(self) -> None:
        with self._serve_pool_lock:
            if self._park_sweeper is None:
                self._park_sweeper = threading.Thread(
                    target=self._sweep_parked, daemon=True,
                    name=f"park-sweep-"
                         f"{self.manager_id.executor_id.executor}")
                self._park_sweeper.start()

    def _sweep_parked(self) -> None:
        while not self.server.stopped:
            time.sleep(0.2)
            now = time.monotonic()
            with self._credits_lock:
                creds = list(self._conn_credits.values())
            for credits in creds:
                for expire in credits.expire_stale(now):
                    try:
                        expire()
                    except Exception:  # noqa: BLE001 — sweeper must live
                        log.exception("park expiry callback failed")
            try:
                self._expire_shard_waiters(now=now)
            except Exception:  # noqa: BLE001 — sweeper must live
                log.exception("shard waiter expiry failed")

    def _on_fetch_blocks(self, msg: M.FetchBlocksReq) -> RpcMsg:
        """Serve a scatter data read (DCN fallback of the one-sided READ,
        scala/RdmaShuffleFetcherIterator.scala:119-180)."""
        if self.data_source is None:
            return M.FetchBlocksResp(msg.req_id, M.STATUS_ERROR, b"")
        total = sum(length for _, _, length in msg.blocks)
        nonempty = sum(1 for _, _, length in msg.blocks if length)
        cap = (self._MAX_SINGLE_BLOCK if nonempty <= 1
               else max(self._MAX_RESP_PAYLOAD,
                        self.conf.shuffle_read_block_size))
        if total > min(cap, self._MAX_SINGLE_BLOCK):
            return M.FetchBlocksResp(msg.req_id, M.STATUS_BAD_RANGE, b"")
        from sparkrdma_tpu_torch.utils.integrity import CorruptOutputError
        parts = []
        for token, offset, length in msg.blocks:
            try:
                data = self.data_source.read_block(msg.shuffle_id, token,
                                                   offset, length)
            except CorruptOutputError as e:
                # the serve-time spot check caught at-rest rot: NEVER send
                # the torn bytes — answer CORRUPT (retryable) so the
                # reducer's envelope escalates into map re-execution
                self._corrupt_served(msg.shuffle_id, -1, str(e))
                return M.FetchBlocksResp(msg.req_id, M.STATUS_CORRUPT, b"")
            except OSError as e:
                # serve-time disk error (EIO on the mapped file): a
                # transient answer — the refetch may land on healthy media
                log.warning("serve-time read error for shuffle %d: %s",
                            msg.shuffle_id, e)
                return M.FetchBlocksResp(msg.req_id, M.STATUS_ERROR, b"")
            if data is None:
                return M.FetchBlocksResp(msg.req_id, M.STATUS_UNKNOWN_SHUFFLE, b"")
            parts.append(data)
        payload = b"".join(parts)
        flags = 0
        if self.conf.fetch_checksum and msg.blocks:
            # per-block CRC32 trailer, appended BEFORE compression/codec
            # so the check spans server read -> client consume (a zlib or
            # codec layer already fails loudly on ITS OWN wire bytes, but
            # says nothing about corruption before the encode). Blocks
            # whose range tiles the at-rest sidecar's attested ranges
            # reuse the committed CRCs (resolver.block_crc — the same
            # contract the native server's CRC table implements in C)
            # instead of re-hashing the bytes on every serve.
            import struct
            import zlib
            flags |= M.FLAG_CRC32
            attested = getattr(self.data_source, "block_crc", None)
            crcs = []
            for (token, offset, length), p in zip(msg.blocks, parts):
                crc = (attested(msg.shuffle_id, token, offset, length)
                       if attested is not None else None)
                crcs.append(zlib.crc32(p) if crc is None else crc)
            payload += struct.pack(f"<{len(parts)}I", *crcs)
        # DCN wire compression — the analogue of the engine-level shuffle
        # block compression the reference inherits from Spark's serializer
        # (scala/RdmaShuffleReader.scala:54-69 wraps streams the same way).
        if (self.conf.wire_compress
                and len(payload) >= self.conf.wire_compress_min):
            import zlib
            compressed = zlib.compress(payload, level=1)
            if len(compressed) < len(payload):
                # OR into flags: the CRC32 trailer (if any) rides inside
                # the compressed bytes and must stay flagged for the
                # reader to verify and strip after decompressing
                payload, flags = compressed, flags | M.FLAG_ZLIB
        if self._codec is not None:
            flags |= M.FLAG_WRAPPED
            payload = self._codec.wrap(payload, self._codec_key,
                                       _codec_aad(msg, flags))
        return M.FetchBlocksResp(msg.req_id, M.STATUS_OK, payload, flags)

    # -- push-merge serving + client calls (shuffle/push_merge.py) -------

    def _on_push_blocks(self, conn: Connection,
                        msg: "M.PushBlocksReq") -> None:
        store = self.merge_store
        if store is None:
            resp = M.PushBlocksResp(msg.req_id, M.STATUS_ERROR, 0, b"")
        elif msg.kind == M.PUSH_KIND_OVERFLOW:
            status, token = store.push_overflow(
                msg.shuffle_id, msg.map_id, msg.fence, msg.data)
            resp = M.PushBlocksResp(msg.req_id, status, token, b"")
        else:
            status, accepted = store.push(
                msg.shuffle_id, msg.map_id, msg.fence,
                msg.start_partition, msg.sizes, msg.data,
                reopen=msg.kind == M.PUSH_KIND_DRAIN)
            resp = M.PushBlocksResp(msg.req_id, status, 0, accepted)
        try:
            conn.send(resp)
        except TransportError as e:
            log.debug("push response lost: %s", e)

    def _on_push_planned(self, conn: Connection,
                         msg: "M.PushPlannedReq") -> None:
        store = self.pushed_store
        if store is None:
            # feature off here: FINALIZED stops the sender for good (a
            # mixed-version fleet degrades to pull, never errors)
            resp = M.PushPlannedResp(msg.req_id, M.STATUS_FINALIZED, b"")
        else:
            status, accepted = store.push(
                msg.shuffle_id, msg.map_id, msg.fence, msg.plan_epoch,
                msg.start_partition, msg.sizes, msg.data)
            resp = M.PushPlannedResp(msg.req_id, status, accepted)
        try:
            conn.send(resp)
        except TransportError as e:
            log.debug("planned-push response lost: %s", e)

    def push_planned(self, peer: ShuffleManagerId, shuffle_id: int,
                     map_id: int, fence: int, plan_epoch: int,
                     start_partition: int, sizes, data: bytes
                     ) -> "M.PushPlannedResp":
        """Client half of the planned-push protocol (SegmentPusher)."""
        conn = self._clients.get(peer.rpc_host, peer.rpc_port)
        resp = conn.request(
            M.PushPlannedReq(conn.next_req_id(), shuffle_id, map_id,
                             fence, plan_epoch, start_partition,
                             list(sizes), data),
            timeout=self.conf.resolved_request_deadline_s())
        assert isinstance(resp, M.PushPlannedResp)
        return resp

    def _on_finalize_segments(self, conn: Connection,
                              msg: "M.FinalizeSegmentsReq") -> None:
        """Seal one shuffle's segments. The broadcast form (req_id=0) is
        one-sided; an explicit request gets the finalized count back.
        A short idle-grace wait lets in-flight pushes land first — the
        finalize broadcast races the LAST map's pushes by construction
        (pushes are queued at commit, the broadcast at its publish)."""
        store = self.merge_store
        if store is None:
            if msg.req_id:
                try:
                    conn.send(M.FinalizeSegmentsResp(msg.req_id,
                                                     M.STATUS_ERROR, 0))
                except TransportError:
                    pass
            return
        grace = min(0.25, self.conf.push_deadline_ms / 1000)
        deadline = time.monotonic() + self.conf.push_deadline_ms / 1000
        # a target whose FIRST push is still in flight has no state yet
        # (idle_for = inf): give it the same grace before sealing, or
        # the broadcast racing the pusher's queue would tombstone the
        # shuffle with zero segments
        first_wait = time.monotonic() + grace
        while (store.idle_for(msg.shuffle_id) == float("inf")
               and time.monotonic() < first_wait):
            time.sleep(0.02)
        while (store.idle_for(msg.shuffle_id) < grace
               and time.monotonic() < deadline):
            time.sleep(0.02)
        try:
            count = store.finalize(
                msg.shuffle_id,
                self.exec_index(
                    timeout=self.conf.connect_timeout_ms / 1000),
                publish=self._publish_merged,
                tracer=self.tracer)
        except Exception:  # noqa: BLE001 — dedicated thread, must not
            # die silently; the shuffle just stays unfinalized here
            log.exception("merge finalize of shuffle %d failed",
                          msg.shuffle_id)
            count = 0
        if msg.req_id:
            try:
                conn.send(M.FinalizeSegmentsResp(msg.req_id, M.STATUS_OK,
                                                 count))
            except TransportError:
                pass

    def push_blocks(self, peer: ShuffleManagerId, shuffle_id: int,
                    map_id: int, fence: int, kind: int,
                    start_partition: int, sizes, data: bytes
                    ) -> "M.PushBlocksResp":
        """Client half of the push protocol (SegmentPusher/MergeClient)."""
        conn = self._clients.get(peer.rpc_host, peer.rpc_port)
        resp = conn.request(
            M.PushBlocksReq(conn.next_req_id(), shuffle_id, map_id, fence,
                            kind, start_partition, list(sizes), data),
            timeout=self.conf.resolved_request_deadline_s())
        assert isinstance(resp, M.PushBlocksResp)
        return resp

    def get_merged_directory(self, shuffle_id: int, metrics=None,
                             fresh: bool = False):
        """The shuffle's merged-segment directory, cache-first: the
        location plane's epoch-validated copy when current, else ONE
        pull from the driver (cached under the response epoch when
        non-empty — an empty directory re-pulls next stage, since
        finalize may land any moment). Returns a
        :class:`~sparkrdma_tpu_torch.shuffle.push_merge.MergedDirectory` or
        None (driver unreachable / shuffle unknown / feature off)."""
        if not self.conf.push_merge:
            return None
        cached = None if fresh else self.location_plane.merged(shuffle_id)
        if cached is not None:
            return cached
        from sparkrdma_tpu_torch.shuffle.push_merge import MergedDirectory
        try:
            if metrics is not None:
                metrics.record_metadata_rpc()
                metrics.record_request()
            resp = self.driver.request(
                lambda c: M.FetchMergedReq(c.next_req_id(), shuffle_id),
                timeout=self.conf.resolved_request_deadline_s())
        except (TransportError, TimeoutError) as e:
            log.debug("merged-directory fetch for shuffle %d failed: %s",
                      shuffle_id, e)
            return None
        assert isinstance(resp, M.FetchMergedResp)
        if resp.status != M.STATUS_OK:
            return None
        directory = MergedDirectory.from_bytes(resp.data)
        if len(directory):
            self.location_plane.put_merged(shuffle_id, directory,
                                           resp.epoch)
        return directory

    def get_tiered_directory(self, shuffle_id: int, metrics=None):
        """The shuffle's cold-tier directory: ONE pull from the driver
        per resolve (no cache — the tiered rung is the last resort
        before re-execution, consulted rarely and always wanting the
        freshest coverage). Returns a
        :class:`~sparkrdma_tpu_torch.shuffle.cold_tier.TieredDirectory` or
        None (driver unreachable / shuffle unknown / feature off)."""
        if not self.conf.cold_tier:
            return None
        from sparkrdma_tpu_torch.shuffle.cold_tier import TieredDirectory
        try:
            if metrics is not None:
                metrics.record_metadata_rpc()
                metrics.record_request()
            resp = self.driver.request(
                lambda c: M.FetchTieredReq(c.next_req_id(), shuffle_id),
                timeout=self.conf.resolved_request_deadline_s())
        except (TransportError, TimeoutError) as e:
            log.debug("tiered-directory fetch for shuffle %d failed: %s",
                      shuffle_id, e)
            return None
        assert isinstance(resp, M.FetchTieredResp)
        if resp.status != M.STATUS_OK:
            return None
        return TieredDirectory.from_bytes(resp.data)

    # -- client-side fetch calls (used by the fetcher iterator) ----------

    def publish_map_output(self, shuffle_id: int, map_id: int,
                           table_token: int, fence: int = 0,
                           lengths=None) -> None:
        """(scala/RdmaShuffleManager.scala:384-418). ``fence`` is the
        committing attempt's fencing token — the driver rejects a publish
        naming the same executor with an older fence, so a zombie
        speculative attempt can't clobber the winner's location.
        ``lengths`` (with ``adaptive_plan``) rides the publish so the
        driver's size histogram sees every committed output's
        per-partition bytes without an extra round trip."""
        entry = DriverTable.pack_entry(
            table_token,
            self.exec_index(timeout=self.conf.connect_timeout_ms / 1000))
        if self._send_owner_publish(shuffle_id, map_id, entry, fence,
                                    lengths):
            # landed at (or on) the owning shard host — the owner's
            # batch converges it into the driver table asynchronously
            return
        msg = M.PublishMsg(shuffle_id, map_id, entry, fence=fence,
                           lengths=lengths)
        # retry envelope: a publish racing a failover lands on the new
        # primary; the fence token makes the duplicate (one per primary
        # that received it) idempotent, so at-least-once is safe
        self.driver.send(msg)

    def get_driver_table(self, shuffle_id: int, expect_published: int,
                         timeout: Optional[float] = None,
                         metrics=None) -> DriverTable:
        """The table of :meth:`get_driver_table_v` (compat shape)."""
        return self.get_driver_table_v(shuffle_id, expect_published,
                                       timeout, metrics)[0]

    def get_driver_table_v(self, shuffle_id: int, expect_published: int,
                           timeout: Optional[float] = None,
                           metrics=None) -> Tuple[DriverTable, int]:
        """``(table, epoch)`` for one shuffle — warm path first.

        Warm: the location plane holds a complete epoch-current table —
        zero RPCs. Cold: with a shard map, one long-poll per SHARD HOST
        (fan-in spreads off the driver; any shard failure falls back);
        else the driver long-poll — the driver holds the response until
        the expected publishes have landed (push on publish, not client
        polling — the event-driven analogue of the reference's
        READ-once-after-known-complete,
        scala/RdmaShuffleManager.scala:341-376; wait budget
        partitionLocationFetchTimeout). Complete tables memoize into the
        plane under the response's epoch, unless an invalidation raced
        the poll. ``metrics`` (a fetcher's ReadMetrics) counts the
        metadata RPCs actually issued — a cache hit counts zero."""
        cached = self.location_plane.table(shuffle_id)
        if cached is not None and cached[0].num_published >= expect_published:
            return cached
        with self._table_lock:
            gen = self._table_gen
        tmo = (timeout if timeout is not None
               else self.conf.partition_location_fetch_timeout_ms / 1000)
        deadline = time.monotonic() + tmo
        shard_map = self.location_plane.shard_map(shuffle_id)
        if shard_map is not None:
            # the shard phase may spend at most HALF the budget: a shard
            # replica that never satisfies its long-poll (a lost forward
            # — pushes are one-attempt) must leave the authoritative
            # driver fallback real time, or one lost push would turn
            # every cold sync into a TimeoutError
            sharded = self._fetch_table_sharded(
                shuffle_id, shard_map, expect_published,
                deadline - tmo / 2, metrics)
            if sharded is not None:
                table, epoch = sharded
                if table.num_published == table.num_maps:
                    with self._table_lock:
                        if self._table_gen == gen:
                            self.location_plane.put_table(shuffle_id,
                                                          table, epoch)
                return table, epoch
            # fall through: shard host lost/lagging — the driver is
            # authoritative
            if metrics is not None:
                metrics.record_shard_fallback()
            self.tracer.instant("meta.shard_fallback", "meta",
                                shuffle=shuffle_id)
        while True:
            remaining = deadline - time.monotonic()
            if metrics is not None:
                metrics.record_metadata_rpc()
            resp = self.driver.request(
                lambda c: M.FetchTableReq(
                    c.next_req_id(), shuffle_id,
                    min_published=expect_published,
                    timeout_ms=max(1, int(remaining * 1000))),
                timeout=max(0.05, remaining) + 5.0,  # grace over the
                # server-side hold so the sweeper answers before we give up
                deadline_s=max(0.05, remaining))
            assert isinstance(resp, M.FetchTableResp)
            if resp.num_published >= expect_published:
                table = DriverTable.from_bytes(resp.table)
                if table.num_published == table.num_maps:
                    with self._table_lock:
                        # memoize only if no invalidation raced this poll
                        # (recovery may have repaired the driver table
                        # after our response was cut)
                        if self._table_gen == gen:
                            self.location_plane.put_table(
                                shuffle_id, table, resp.epoch)
                return table, resp.epoch
            if resp.num_published < 0:
                # driver doesn't know the shuffle (unregistered mid-poll or
                # never registered): re-arming would spin, fail now
                raise TimeoutError(
                    f"shuffle {shuffle_id} is not registered at the driver")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shuffle {shuffle_id}: only {resp.num_published}/"
                    f"{expect_published} map outputs published")
            # partial answer before the deadline (sweeper raced a publish
            # burst): re-arm the long-poll for the remaining budget

    def _fetch_table_sharded(self, shuffle_id: int, shard_map,
                             expect_published: int, deadline: float,
                             metrics=None
                             ) -> Optional[Tuple[DriverTable, int]]:
        """Assemble the driver table from shard-host replicas: one
        long-poll per shard (contiguous map ranges concatenate back into
        the positional table). Returns None on ANY shard miss — dead
        host, no replica, lagging count — and the caller falls back to
        the authoritative driver. The assembled epoch is the MINIMUM
        across shards: a lagging replica must make the view look older,
        never newer, so a pushed bump still invalidates it."""
        parts: List[bytes] = []
        total = 0
        epoch: Optional[int] = None
        for shard in range(shard_map.num_shards):
            lo, hi = shard_map.range_of(shard)
            # distribute the completeness expectation: a full-table
            # expectation holds each shard for its whole range; anything
            # lower (recovery's expect=0 probes) reads what's there
            min_pub = (hi - lo) if expect_published >= shard_map.num_maps \
                else 0
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                peer = self.member_at(shard_map.shard_slots[shard])
                conn = self._clients.get(peer.rpc_host, peer.rpc_port)
                if metrics is not None:
                    metrics.record_metadata_rpc()
                resp = conn.request(
                    M.FetchShardReq(conn.next_req_id(), shuffle_id, lo, hi,
                                    min_published=min_pub,
                                    timeout_ms=max(1, int(remaining * 1000))),
                    timeout=max(0.05, remaining) + 5.0)
            except (DeadExecutorError, IndexError, TransportError,
                    TimeoutError) as e:
                log.debug("shard %d of shuffle %d unreadable (%s); driver "
                          "fallback", shard, shuffle_id, e)
                return None
            if not isinstance(resp, M.FetchShardResp) \
                    or resp.num_published < min_pub \
                    or len(resp.table) != (hi - lo) * MAP_ENTRY_SIZE:
                return None
            parts.append(resp.table)
            total += resp.num_published
            epoch = resp.epoch if epoch is None else min(epoch, resp.epoch)
        if total < expect_published:
            return None
        return DriverTable.from_bytes(b"".join(parts)), epoch or 0

    def invalidate_shuffle(self, shuffle_id: int) -> None:
        """Drop every cached location view of the shuffle (stage recovery
        repaired it, or the shuffle unregistered; ids can be reused by
        the engine). Bumps the generation so an in-flight long-poll
        answered with the pre-invalidation table cannot re-memoize it,
        and drops the worker-process shuffle cache (mesh results + warm
        partition ranges) — stale bytes must not serve after a map
        recomputes."""
        with self._table_lock:
            self._table_gen += 1
        self.location_plane.invalidate(shuffle_id)
        from sparkrdma_tpu_torch.shuffle import dist_cache
        dist_cache.drop(shuffle_id)

    def _failed_fetch(self, exc: TransportError) -> AsyncFetch:
        """An AsyncFetch that already failed (the dial threw before a
        request existed): issue paths stay non-raising so EVERY transport
        failure — connect refusal included — surfaces at ``result()``,
        where the fetcher's one retry envelope owns the policy."""
        from concurrent.futures import Future

        fut: Future = Future()
        fut.set_exception(exc)
        return AsyncFetch(fut, self.conf.resolved_request_deadline_s(),
                          lambda resp: resp)

    def fetch_output_range_async(self, peer: ShuffleManagerId,
                                 shuffle_id: int, map_id: int, start: int,
                                 end: int) -> AsyncFetch:
        """Issue one block-location read without waiting for it: the
        fetcher's read-ahead window keeps several of these in flight per
        peer over the pipelined connection."""
        try:
            conn = self._clients.get(peer.rpc_host, peer.rpc_port)
        except TransportError as e:
            return self._failed_fetch(e)
        fut = conn.request_async(
            M.FetchOutputReq(conn.next_req_id(), shuffle_id, map_id,
                             start, end))

        def complete(resp):
            assert isinstance(resp, M.FetchOutputResp)
            if resp.status != M.STATUS_OK:
                # the owner answered authoritatively: it does not have the
                # map/range the driver table promised — a refetch re-fails
                # identically, only a recompute heals it. CORRUPT is the
                # retryable demotion of at-rest rot (the bounded refetch
                # re-fails fast, then escalates with a corrupt_output
                # verdict into map re-execution); ERROR is the transient
                # serving class (verify-time disk hiccup) — same
                # semantics as the blocks path
                raise FetchStatusError(
                    "fetch_output", resp.status,
                    retryable=resp.status in (M.STATUS_ERROR,
                                              M.STATUS_CORRUPT))
            return MapTaskOutput.locations_from_range(resp.entries)

        return AsyncFetch(fut, self.conf.resolved_request_deadline_s(),
                          complete)

    def fetch_output_range(self, peer: ShuffleManagerId, shuffle_id: int,
                           map_id: int, start: int, end: int):
        return self.fetch_output_range_async(peer, shuffle_id, map_id,
                                             start, end).result()

    # One batched-location response stays well under the serving payload
    # cap; the client chunks its map list so even a 100k-map shuffle with a
    # wide reduce range asks in a few bounded requests, not one huge one.
    _MAX_OUTPUTS_BATCH_BYTES = 4 << 20

    def outputs_batch_maps(self, start: int, end: int) -> int:
        """How many maps one FetchOutputsReq may carry for this reduce
        range (entry bytes bounded by ``_MAX_OUTPUTS_BATCH_BYTES``)."""
        from sparkrdma_tpu_torch.shuffle.map_output import ENTRY_SIZE

        span_bytes = max(1, (end - start) * ENTRY_SIZE)
        return max(1, self._MAX_OUTPUTS_BATCH_BYTES // span_bytes)

    def fetch_outputs_async(self, peer: ShuffleManagerId, shuffle_id: int,
                            map_ids, start: int, end: int) -> AsyncFetch:
        """Issue ONE batched location read covering many maps of one peer
        (the metadata half of the coalesced dataplane). ``result()``
        returns ``{map_id: [BlockLocation, ...]}``; any per-map non-OK
        status raises a non-retryable :class:`FetchStatusError` carrying
        ``map_id`` so the fetcher blames the right map (the owner
        answered authoritatively — only a recompute heals it)."""
        map_ids = list(map_ids)
        try:
            conn = self._clients.get(peer.rpc_host, peer.rpc_port)
        except TransportError as e:
            return self._failed_fetch(e)
        fut = conn.request_async(
            M.FetchOutputsReq(conn.next_req_id(), shuffle_id, map_ids,
                              start, end))

        def complete(resp):
            assert isinstance(resp, M.FetchOutputsResp)
            if resp.status != M.STATUS_OK:
                raise FetchStatusError("fetch_outputs", resp.status,
                                       retryable=False)
            out = {}
            for map_id, mstatus, entries in resp.records:
                if mstatus != M.STATUS_OK:
                    err = FetchStatusError(
                        f"fetch_outputs map {map_id}", mstatus,
                        retryable=mstatus in (M.STATUS_ERROR,
                                              M.STATUS_CORRUPT))
                    err.map_id = map_id
                    raise err
                out[map_id] = MapTaskOutput.locations_from_range(entries)
            missing = [m for m in map_ids if m not in out]
            if missing:
                # a malformed/short reply must not silently truncate the
                # reduce input; treat like a lost response (refetchable)
                raise TransportError(
                    f"fetch_outputs reply missing maps {missing[:4]}"
                    f"{'...' if len(missing) > 4 else ''}")
            return out

        return AsyncFetch(fut, self.conf.resolved_request_deadline_s(),
                          complete)

    def fetch_outputs(self, peer: ShuffleManagerId, shuffle_id: int,
                      map_ids, start: int, end: int):
        return self.fetch_outputs_async(peer, shuffle_id, map_ids,
                                        start, end).result()

    def _register_credit(self, conn: Connection,
                         req: "M.FetchBlocksReq", credited: bool) -> bool:
        """Receipt-credit accounting, issue half: remember the request's
        logical size BEFORE it hits the wire. The pending entry is keyed
        by (conn, req_id) so a response that arrives ORPHANED — our wait
        timed out but the server's send succeeded — still gets its
        report from the unsolicited-message path instead of leaking
        window forever. Native block-server responses aren't credited
        (``credited=False`` there; that path has its own caps)."""
        if not (credited and self.conf.sw_flow_control):
            return False
        total = sum(length for _, _, length in req.blocks)
        with self._fetch_credit_lock:
            self._fetch_credit_pending.setdefault(conn, {})[req.req_id] = \
                total
        return True

    def _settle_credit(self, conn: Connection, req: "M.FetchBlocksReq",
                       resp: RpcMsg) -> None:
        """Receipt-credit accounting, completion half: on an OK response
        report the logical size so the server's serving window
        replenishes (the server freed its copy the moment we have
        ours)."""
        with self._fetch_credit_lock:
            pending = self._fetch_credit_pending.get(conn, {}).pop(
                req.req_id, None)
        if pending is not None and resp.status == M.STATUS_OK:
            self._queue_credit_report(conn, pending)

    def _queue_credit_report(self, conn: Connection, total: int) -> None:
        """Hand a CreditReport send to the dedicated worker so the
        callers — connection reader threads via the receipt-time settle
        and orphan paths — can never block in ``sendall`` when both TCP
        directions are full; a blocked reader would stop draining the
        very responses whose receipt replenishes the window."""
        if self._credit_worker is None:
            with self._credit_worker_lock:
                if self._credit_worker is None and not self._stopping:
                    self._credit_worker = threading.Thread(
                        target=self._credit_loop, daemon=True,
                        name=f"credit-"
                             f"{self.manager_id.executor_id.executor}")
                    self._credit_worker.start()
        self._credit_q.put((conn, total))

    def _credit_loop(self) -> None:
        while True:
            item = self._credit_q.get()
            if item is None:
                return
            conn, total = item
            try:
                conn.send(M.CreditReport(total))
            except TransportError:
                pass  # conn died post-response; server releases on its own

    def _drop_credit(self, conn: Connection,
                     req: "M.FetchBlocksReq") -> None:
        """The connection died mid-request: no orphan will ever arrive,
        and the server releases on its own failed send."""
        with self._fetch_credit_lock:
            self._fetch_credit_pending.get(conn, {}).pop(req.req_id, None)

    def _credited_request(self, conn: Connection,
                          req: "M.FetchBlocksReq", credited: bool) -> RpcMsg:
        """``conn.request`` with receipt-credit accounting (see
        ``_register_credit``/``_settle_credit``). A TIMEOUT leaves the
        pending entry in place on purpose — the orphan path owns it."""
        registered = self._register_credit(conn, req, credited)
        try:
            resp = conn.request(req)
        except TransportError:
            if registered:
                self._drop_credit(conn, req)
            raise
        if registered:
            self._settle_credit(conn, req, resp)
        return resp

    def _on_orphan_blocks_resp(self, conn: Connection,
                               msg: "M.FetchBlocksResp") -> None:
        """A data response whose requester gave up waiting: its Future is
        gone, but the server is still holding window for it — report the
        credits it carried."""
        with self._fetch_credit_lock:
            total = self._fetch_credit_pending.get(conn, {}).pop(
                msg.req_id, None)
        if total is not None and msg.status == M.STATUS_OK:
            self._queue_credit_report(conn, total)

    def fetch_blocks_async(self, peer: ShuffleManagerId, shuffle_id: int,
                           blocks) -> AsyncFetch:
        """Issue one grouped data fetch without waiting for it — the
        measured fetch fast path. The request multiplexes onto the shared
        pipelined connection by req_id; the returned handle's
        ``result()`` settles credits, handles the native-server size-cap
        retry, and decodes, all on the calling (peer fetch) thread.

        Prefers the peer's native block server when advertised: same wire
        protocol, no Python on the serving side. The native server
        doesn't compress or wrap, so when wire compression or a wire
        codec is configured stay on the control path which does."""
        blocks = list(blocks)
        port = (peer.block_port
                if peer.block_port and not self.conf.wire_compress
                and self._codec is None
                else peer.rpc_port)
        try:
            conn = self._clients.get(peer.rpc_host, port)
        except TransportError as e:
            return self._failed_fetch(e)
        req = M.FetchBlocksReq(conn.next_req_id(), shuffle_id, blocks)
        registered = self._register_credit(conn, req,
                                           credited=port == peer.rpc_port)
        fut = conn.request_async(req)
        if registered:
            # CreditReport ON RECEIPT (reader thread), not at completion:
            # a read-ahead window completes oldest-issued-first, but the
            # server may serve out of order — landed-but-uncompleted
            # responses must replenish the window immediately or a parked
            # older response could deadlock against its own window until
            # the park timeout. (The orphan path already reports from the
            # reader thread for the same reason.)
            def _on_wire(f) -> None:
                if f.cancelled():
                    return  # orphan path owns the pending entry
                exc = f.exception()
                if exc is not None:
                    if isinstance(exc, TransportError):
                        # dead connection: no orphan will ever arrive
                        self._drop_credit(conn, req)
                    return
                self._settle_credit(conn, req, f.result())

            fut.add_done_callback(_on_wire)

        def complete(resp):
            assert isinstance(resp, M.FetchBlocksResp)
            final_req = req
            if resp.status == M.STATUS_BAD_RANGE and port != peer.rpc_port:
                # only the size-cap case is worth retrying: the native
                # server enforces a stricter response-size cap than the
                # Python path. Other statuses (unknown token/shuffle)
                # would fail identically on the control connection —
                # retrying would just double the failure-path load during
                # an executor-loss storm
                rconn = self._clients.get(peer.rpc_host, peer.rpc_port)
                final_req = M.FetchBlocksReq(rconn.next_req_id(),
                                             shuffle_id, blocks)
                resp = self._credited_request(rconn, final_req,
                                              credited=True)
                assert isinstance(resp, M.FetchBlocksResp)
            if resp.status != M.STATUS_OK:
                # STATUS_ERROR is the transient class (credit-window
                # expiry under a stalled consumer, serving hiccup) — a
                # refetch usually heals it; STATUS_CORRUPT retries within
                # the same budget then escalates with a corrupt_output
                # verdict (at-rest rot heals only by re-execution);
                # unknown-token/shuffle and bad-range answers are
                # authoritative re-failures
                raise FetchStatusError(
                    "fetch_blocks", resp.status,
                    retryable=resp.status in (M.STATUS_ERROR,
                                              M.STATUS_CORRUPT))
            return self._decode_blocks_resp(final_req, resp)

        return AsyncFetch(fut, self.conf.resolved_request_deadline_s(),
                          complete)

    def fetch_blocks(self, peer: ShuffleManagerId, shuffle_id: int,
                     blocks) -> bytes:
        return self.fetch_blocks_async(peer, shuffle_id, blocks).result()

    def _decode_blocks_resp(self, req: "M.FetchBlocksReq",
                            resp: "M.FetchBlocksResp") -> bytes:
        with self._wire_lock:
            self.wire_bytes_in += len(resp.data)
        data = resp.data
        if self._codec is not None and not (resp.flags & M.FLAG_WRAPPED):
            # a stripped FLAG_WRAPPED must not downgrade the channel to
            # accepting unauthenticated bytes
            raise TransportError(
                "peer sent an unwrapped payload but wire_codec is "
                "configured (downgrade or peer config drift)")
        if resp.flags & M.FLAG_WRAPPED:
            from sparkrdma_tpu_torch.utils.codecs import CodecError
            if self._codec is None:
                raise TransportError(
                    "peer wrapped the payload but no wire_codec is "
                    "configured here")
            try:
                data = self._codec.unwrap(data, self._codec_key,
                                          _codec_aad(req, resp.flags))
            except CodecError as e:
                raise TransportError(f"fetch_blocks unwrap failed: {e}") from e
        if resp.flags & M.FLAG_ZLIB:
            import zlib
            try:
                data = zlib.decompress(data)
            except zlib.error as e:
                # a wire bit-flip lands here on compressed payloads; the
                # retryable-checksum class routes it into the bounded
                # refetch path like an uncompressed CRC mismatch
                raise ChecksumError(
                    f"fetch_blocks payload failed to decompress: {e}") from e
        if resp.flags & M.FLAG_CRC32:
            data = self._verify_block_crcs(req, data)
        return data

    def _verify_block_crcs(self, req: "M.FetchBlocksReq",
                           data: bytes) -> bytes:
        """Check and strip the per-block CRC32 trailer. Block lengths come
        from the REQUEST (both sides derive the layout independently —
        the trailer can't lie about where blocks start). Raises the
        retryable :class:`ChecksumError`; every block is checked (not
        fail-fast) so the error carries the FULL list of bad block
        indices plus the stripped body — a vectored fetch salvages the
        clean sub-ranges and refetches only the corrupt ones, blaming the
        map that owns them."""
        import struct
        import zlib
        n = len(req.blocks)
        lengths = [length for _, _, length in req.blocks]
        body_len = len(data) - 4 * n
        if body_len != sum(lengths):
            self.checksum_failures += 1
            raise ChecksumError(
                f"fetch_blocks payload size mismatch: {body_len} data "
                f"bytes for {sum(lengths)} requested")
        crcs = struct.unpack_from(f"<{n}I", data, body_len)
        body = memoryview(data)[:body_len]
        bad = []
        pos = 0
        for i, length in enumerate(lengths):
            if zlib.crc32(body[pos:pos + length]) != crcs[i]:
                bad.append(i)
            pos += length
        if bad:
            self.checksum_failures += len(bad)
            raise ChecksumError(
                f"fetch_blocks blocks {bad[:8]}"
                f"{'...' if len(bad) > 8 else ''} of {n} failed CRC32 "
                f"(corruption in flight or at the server)",
                bad_blocks=bad, body=bytes(body))
        return bytes(body)
