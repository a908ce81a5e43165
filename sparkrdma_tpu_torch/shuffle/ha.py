"""Driver HA: the control plane as a replicated, lease-fenced state
machine.

One Python process holding every authoritative table (location epochs,
merged directory, membership plane, plans, admission state) is the last
single point of failure (ROADMAP item 3). The fix follows the paper's
one-sided discipline rather than a request/reply consensus path ("RPC
Considered Harmful", PAPERS.md): driver state is ALREADY a stream of
small fence/epoch-ordered publishes, so it replicates the same way map
outputs reach the driver — as an ordered op-log pushed over the
existing announce-style channel (per RAMC's remote-channel framing,
PAPERS.md), with snapshots for cold-standby catch-up.

Three primitives live here, deliberately free of any endpoint import so
the model checker (analysis/modelcheck.py) exercises the REAL classes:

* **epoch composition** — ``driver_incarnation`` becomes the leading
  component of every epoch comparison: ``compose_epoch(inc, seq)``
  packs the incarnation into the high bits of the i64 epochs already on
  the wire. Incarnation 0 leaves every existing epoch numerically
  unchanged; a takeover at incarnation N makes every new epoch strictly
  greater than ANY epoch a zombie old primary can mint, so the monotone
  keep-highest guards that exist today (LocationPlane.note_epoch, plan
  epochs, membership epochs, AnnounceMsg) fence zombie writes with no
  wire-format change. ``EPOCH_DEAD`` (-1) stays a sentinel.

* **LeaseStore** — a tiny CAS register ``(holder, term, expires_at)``.
  ``try_acquire`` succeeds only for term = current+1 against a dead or
  same-holder lease (single holder per term, ever); ``renew`` fails the
  instant a higher term exists, which is how a zombie primary learns it
  is fenced. Backends: in-memory (tests, model checker) and local-file
  (atomic rename under an exclusive lock file).

* **OpLog** — monotone ``(incarnation, seq)``-stamped records of every
  driver mutation. Wire-shaped mutations (publishes, merged publishes,
  joins) log the encoded frame verbatim and replay through the same
  handler — fence floors and epoch guards make the second application a
  no-op, which is the whole idempotency story. Mutations with no wire
  form (register, unregister, plan install, tombstone, drain steps) log
  small structured payloads. A snapshot every ``oplog_snapshot_every``
  appends bounds the tail a cold standby must replay.

Ordering discipline (model-checked by ``failover_vs_ttl_sweep``): an op
is appended to the log — and its standby stream push queued — BEFORE
any executor-facing push for the same mutation. The broadcaster drains
its queue in FIFO order from one thread, so a standby holds the
unregister before any executor sees the ``EPOCH_DEAD`` it caused; a
takeover therefore can never resurrect a shuffle some reducer already
observed dead.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("sparkrdma_tpu_torch.ha")

# -- epoch composition ------------------------------------------------------

INCARNATION_SHIFT = 32
EPOCH_SEQ_MASK = (1 << INCARNATION_SHIFT) - 1


def compose_epoch(incarnation: int, seq: int) -> int:
    """Pack ``incarnation`` into the high bits of an i64 epoch. At
    incarnation 0 this is the identity, so pre-HA epochs are unchanged;
    any incarnation-N epoch strictly dominates every incarnation-<N one
    under the plain integer comparisons the receivers already do."""
    if incarnation < 0 or seq < 0:
        raise ValueError(f"negative epoch component ({incarnation}, {seq})")
    return (incarnation << INCARNATION_SHIFT) | (seq & EPOCH_SEQ_MASK)


def incarnation_of(epoch: int) -> int:
    """The incarnation component of a composed epoch (0 for every
    pre-HA epoch; sentinels like EPOCH_DEAD are the caller's problem)."""
    if epoch < 0:
        return 0
    return epoch >> INCARNATION_SHIFT


def epoch_seq(epoch: int) -> int:
    """The per-incarnation sequence component of a composed epoch."""
    if epoch < 0:
        return 0
    return epoch & EPOCH_SEQ_MASK


def rebase_epoch(epoch: int, incarnation: int) -> int:
    """The first epoch the new primary publishes for state restored at
    ``incarnation``: one past the restored sequence, under the new
    leading component — executors observe the takeover as one more
    ordinary bump."""
    return compose_epoch(incarnation, epoch_seq(epoch) + 1)


# -- lease store ------------------------------------------------------------

@dataclass(frozen=True)
class Lease:
    holder: str
    term: int
    expires_at: float  # seconds, same clock the store's callers pass as now


class LeaseStore:
    """CAS register for the driver lease. ``term`` is the fencing token:
    it only ever moves forward, by exactly one, through ``try_acquire``;
    incarnation N is the endpoint built after winning term N."""

    def now(self) -> float:
        """The clock ``expires_at`` lives on. Backends choose: in-memory
        uses the monotonic clock (single process); the file backend uses
        wall-clock time, the one clock the host's processes share. Every
        expiry comparison must use THIS clock, never a hardcoded one."""
        return time.monotonic()

    def read(self) -> Optional[Lease]:
        raise NotImplementedError

    def try_acquire(self, holder: str, term: int, ttl_s: float,
                    now: Optional[float] = None) -> bool:
        raise NotImplementedError

    def renew(self, holder: str, term: int, ttl_s: float,
              now: Optional[float] = None) -> bool:
        raise NotImplementedError


def _admit(cur: Optional[Lease], holder: str, term: int,
           now: float) -> bool:
    """The one CAS rule both backends share: term must be exactly
    current+1 (0 starts the world), against a lease that is expired or
    our own. A live lease held by someone else — or ANY lease at or
    past the proposed term — refuses."""
    cur_term = -1 if cur is None else cur.term
    if term != cur_term + 1:
        return False
    if cur is not None and cur.holder != holder and now < cur.expires_at:
        return False
    return True


class InMemoryLeaseStore(LeaseStore):
    """Single-process backend for tests and the model checker; the lock
    makes try_acquire atomic, so two racing standbys resolve to exactly
    one winner per term."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lease: Optional[Lease] = None

    def read(self) -> Optional[Lease]:
        with self._lock:
            return self._lease

    def try_acquire(self, holder: str, term: int, ttl_s: float,
                    now: Optional[float] = None) -> bool:
        now = self.now() if now is None else now
        with self._lock:
            if not _admit(self._lease, holder, term, now):
                return False
            self._lease = Lease(holder, term, now + ttl_s)
            return True

    def renew(self, holder: str, term: int, ttl_s: float,
              now: Optional[float] = None) -> bool:
        now = self.now() if now is None else now
        with self._lock:
            cur = self._lease
            if cur is None or cur.holder != holder or cur.term != term:
                return False  # a higher term exists: the renewer is a zombie
            self._lease = Lease(holder, term, now + ttl_s)
            return True


class FileLeaseStore(LeaseStore):
    """Local-file backend: the lease is a JSON blob replaced atomically
    (write-tmp + os.replace) under a short-lived O_EXCL lock file, so
    processes on one host CAS against each other. expires_at uses
    time.time() — the shared clock the host's processes agree on."""

    _LOCK_STALE_S = 5.0

    def __init__(self, path: str) -> None:
        self.path = path
        self._lockpath = path + ".lock"

    def now(self) -> float:
        return time.time()

    def _read_unlocked(self) -> Optional[Lease]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                d = json.load(f)
            return Lease(str(d["holder"]), int(d["term"]),
                         float(d["expires_at"]))
        except (OSError, ValueError, KeyError):
            return None

    def read(self) -> Optional[Lease]:
        return self._read_unlocked()

    def _locked(self, fn: Callable[[], bool]) -> bool:
        deadline = time.monotonic() + 1.0
        while True:
            try:
                fd = os.open(self._lockpath,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                try:  # break a lock left by a crashed holder
                    if (time.time() - os.path.getmtime(self._lockpath)
                            > self._LOCK_STALE_S):
                        os.unlink(self._lockpath)
                        continue
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.005)
        try:
            return fn()
        finally:
            os.close(fd)
            try:
                os.unlink(self._lockpath)
            except OSError:
                pass

    def _write(self, lease: Lease) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"holder": lease.holder, "term": lease.term,
                       "expires_at": lease.expires_at}, f)
        os.replace(tmp, self.path)

    def try_acquire(self, holder: str, term: int, ttl_s: float,
                    now: Optional[float] = None) -> bool:
        now = self.now() if now is None else now

        def cas() -> bool:
            if not _admit(self._read_unlocked(), holder, term, now):
                return False
            self._write(Lease(holder, term, now + ttl_s))
            return True

        return self._locked(cas)

    def renew(self, holder: str, term: int, ttl_s: float,
              now: Optional[float] = None) -> bool:
        now = self.now() if now is None else now

        def cas() -> bool:
            cur = self._read_unlocked()
            if cur is None or cur.holder != holder or cur.term != term:
                return False
            self._write(Lease(holder, term, now + ttl_s))
            return True

        return self._locked(cas)


# -- op-log -----------------------------------------------------------------

# op kinds; OP_WIRE replays the encoded frame through the driver's own
# message handler (idempotent by fence floors / epoch guards), the rest
# are mutations with no wire form.
OP_WIRE = 1        # payload: one encoded driver-bound frame
OP_REGISTER = 2    # <iiiid> shuffle_id, num_maps, num_partitions,
#                    tenant, wall-clock registration time (the TTL
#                    re-derive clock — see failover_vs_ttl_sweep)
OP_UNREGISTER = 3  # <i> shuffle_id
OP_BUMP = 4        # <i> shuffle_id (out-of-band epoch bump)
OP_TOMBSTONE = 5   # serialized ShuffleManagerId
OP_DRAIN = 6       # <ii> slot, step (0 begin / 1 abort / 2 retire)
OP_PLAN = 7        # ReducePlan.to_bytes() (install + push)
OP_FINALIZE = 8    # <i> shuffle_id

# Per-SHARD op kinds (shard_ownership mode, shuffle/shard_plane.py):
# each shard owner streams its own OpLog — keyed (shard, owner_gen,
# seq), with the ownership generation standing in for the driver
# incarnation — to its standby. Distinct namespace from OP_* above:
# these records never enter the driver's replicated log.
SHARD_OP_PUBLISH = 1  # pack_shard_publish payload
SHARD_OP_MERGED = 2   # opaque MergedPublishMsg payload

_OP_REGISTER_S = struct.Struct("<iiiid")
_OP_SID_S = struct.Struct("<i")
_OP_DRAIN_S = struct.Struct("<ii")
_SHARD_PUB_S = struct.Struct("<iq")  # map_id, fence (then entry + lengths)
_REC_HEAD = struct.Struct("<IQI")  # incarnation, seq, kind

DRAIN_BEGIN, DRAIN_ABORT, DRAIN_RETIRE = 0, 1, 2


@dataclass(frozen=True)
class OpRecord:
    incarnation: int
    seq: int
    kind: int
    payload: bytes

    def to_bytes(self) -> bytes:
        return (_REC_HEAD.pack(self.incarnation, self.seq, self.kind)
                + self.payload)

    @classmethod
    def from_bytes(cls, data: bytes) -> "OpRecord":
        inc, seq, kind = _REC_HEAD.unpack_from(data, 0)
        return cls(inc, seq, kind, bytes(data[_REC_HEAD.size:]))


class OpLog:
    """The ordered mutation log. Appends are stamped (incarnation, seq)
    with seq monotone within the incarnation; a snapshot installed at
    seq S lets the tail before S be dropped, bounding both memory and
    cold-standby catch-up."""

    def __init__(self, incarnation: int = 0,
                 snapshot_every: int = 256) -> None:
        self.incarnation = incarnation
        self.snapshot_every = max(1, int(snapshot_every))
        self._lock = threading.Lock()
        self._seq = 0
        self._tail: List[OpRecord] = []
        self._snapshot: Optional[Tuple[int, bytes]] = None  # (seq, blob)
        self.appended = 0

    def append(self, kind: int, payload: bytes) -> OpRecord:
        with self._lock:
            self._seq += 1
            rec = OpRecord(self.incarnation, self._seq, kind, payload)
            self._tail.append(rec)
            self.appended += 1
            return rec

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def snapshot_due(self) -> bool:
        with self._lock:
            snap_seq = self._snapshot[0] if self._snapshot else 0
            return self._seq - snap_seq >= self.snapshot_every

    def install_snapshot(self, seq: int, blob: bytes) -> None:
        """Record a state snapshot taken at ``seq`` and compact the tail
        it covers (restore = snapshot + remaining tail)."""
        with self._lock:
            self._snapshot = (seq, blob)
            self._tail = [r for r in self._tail if r.seq > seq]

    def snapshot(self) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            return self._snapshot

    def entries_since(self, seq: int) -> List[OpRecord]:
        with self._lock:
            return [r for r in self._tail if r.seq > seq]

    def restore_point(self) -> Tuple[Optional[bytes], List[OpRecord]]:
        """What a cold standby needs: the newest snapshot blob (or None)
        plus every op after it, in order."""
        with self._lock:
            if self._snapshot is None:
                return None, list(self._tail)
            seq, blob = self._snapshot
            return blob, [r for r in self._tail if r.seq > seq]


# -- snapshot codec ---------------------------------------------------------
#
# The snapshot is a JSON envelope with base64 blobs for the binary
# sub-states that already have their own codecs (DriverTable,
# MergedDirectory, ReducePlan, ShuffleManagerId). Control-plane sized,
# versioned, and debuggable with `python -m json.tool`.

SNAPSHOT_VERSION = 1


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode("ascii"))


def encode_snapshot(state: Dict) -> bytes:
    """``state`` is the plain-dict form DriverEndpoint.snapshot_state()
    builds (ints, strings, and raw ``bytes`` leaves; bytes are base64'd
    here). Kept endpoint-agnostic so tests and the model checker can
    round-trip synthetic states."""

    def enc(v):
        if isinstance(v, bytes):
            return {"__b64__": _b64(v)}
        if isinstance(v, dict):
            return {str(k): enc(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        return v

    return json.dumps({"version": SNAPSHOT_VERSION,
                       "state": enc(state)},
                      separators=(",", ":")).encode("utf-8")


def decode_snapshot(blob: bytes) -> Dict:
    def dec(v):
        if isinstance(v, dict):
            if set(v.keys()) == {"__b64__"}:
                return _unb64(v["__b64__"])
            return {k: dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    d = json.loads(blob.decode("utf-8"))
    if int(d.get("version", -1)) != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {d.get('version')!r} != "
                         f"{SNAPSHOT_VERSION}")
    return dec(d["state"])


def op_register(shuffle_id: int, num_maps: int, num_partitions: int,
                tenant: int, reg_unix: float = 0.0) -> bytes:
    return _OP_REGISTER_S.pack(shuffle_id, num_maps, num_partitions,
                               tenant, reg_unix)


def unpack_register(payload: bytes) -> Tuple[int, int, int, int, float]:
    return _OP_REGISTER_S.unpack_from(payload, 0)


def op_sid(shuffle_id: int) -> bytes:
    return _OP_SID_S.pack(shuffle_id)


def unpack_sid(payload: bytes) -> int:
    return _OP_SID_S.unpack_from(payload, 0)[0]


def op_drain(slot: int, step: int) -> bytes:
    return _OP_DRAIN_S.pack(slot, step)


def unpack_drain(payload: bytes) -> Tuple[int, int]:
    return _OP_DRAIN_S.unpack_from(payload, 0)


def pack_shard_publish(map_id: int, fence: int, entry: bytes,
                       lengths=None) -> bytes:
    """SHARD_OP_PUBLISH payload: one applied positional write, with the
    optional per-partition lengths the driver-side histogram wants."""
    out = _SHARD_PUB_S.pack(map_id, fence) + entry
    if lengths is None:
        out += struct.pack("<i", -1)
    else:
        out += struct.pack(f"<i{len(lengths)}I", len(lengths), *lengths)
    return out


def unpack_shard_publish(payload: bytes):
    map_id, fence = _SHARD_PUB_S.unpack_from(payload, 0)
    entry = bytes(payload[12:24])
    (nlen,) = struct.unpack_from("<i", payload, 24)
    lengths = None
    if nlen >= 0:
        lengths = list(struct.unpack_from(f"<{nlen}I", payload, 28))
    return map_id, fence, entry, lengths


# -- standby ----------------------------------------------------------------

class DriverStandby:
    """A cold standby: buffers the snapshot + op stream the primary
    pushes at it, watches the lease, and on expiry CAS-takes the next
    term, replays, and promotes into a full DriverEndpoint at
    incarnation = won term (executors are re-pointed by the promoted
    endpoint's TakeoverMsg).

    The standby runs its own ControlServer; pre-promotion the handler
    accepts only the replication frames, post-promotion it delegates to
    the promoted endpoint, so the address executors learn from
    TakeoverMsg is live the moment the lease is won."""

    def __init__(self, conf, lease_store: LeaseStore, name: str,
                 primary_addr: Tuple[str, int], host: str = "127.0.0.1",
                 port: int = 0) -> None:
        # endpoint/transport imports are deferred: endpoints imports
        # this module for the primitives above
        from sparkrdma_tpu_torch.parallel.transport import (ConnectionCache,
                                                      ControlServer,
                                                      TransportError)
        from sparkrdma_tpu_torch.utils import trace as trace_mod
        self.conf = conf
        self.lease_store = lease_store
        self.name = name
        self.primary_addr = primary_addr
        self._transport_error = TransportError
        self.tracer = trace_mod.get(conf)
        self._lock = threading.Lock()
        self._snapshot: Optional[bytes] = None
        self._snapshot_seq = 0
        self._tail: List[OpRecord] = []
        self._last: Tuple[int, int] = (0, 0)  # (incarnation, seq)
        self.endpoint = None  # set on promotion
        self._promoted = threading.Event()
        self._stop = threading.Event()
        self._clients = ConnectionCache(conf)
        self.server = ControlServer(host, port, conf, self._handle,
                                    name=f"standby-{name}")
        self._watcher = threading.Thread(target=self._watch_lease,
                                         name=f"ha-standby-{name}",
                                         daemon=True)

    @property
    def address(self) -> Tuple[str, int]:
        return (self.server.host, self.server.port)

    def start(self) -> "DriverStandby":
        from sparkrdma_tpu_torch.parallel import messages as M
        try:
            conn = self._clients.get(*self.primary_addr)
            conn.send(M.StandbyHelloMsg(self.name, self.server.host,
                                        self.server.port, self._last[1]))
        except self._transport_error:
            log.warning("standby %s: primary %s unreachable at start; "
                        "waiting on the lease alone", self.name,
                        self.primary_addr)
        self._watcher.start()
        return self

    # -- replication ingest --------------------------------------------

    def _handle(self, conn, msg):
        from sparkrdma_tpu_torch.parallel import messages as M
        ep = self.endpoint
        if ep is not None:  # promoted: the standby server IS the driver
            return ep._handle(conn, msg)
        if isinstance(msg, M.SnapshotMsg):
            with self._lock:
                self._snapshot = msg.blob
                self._snapshot_seq = msg.seq
                self._tail = [r for r in self._tail if r.seq > msg.seq]
                self._last = (msg.incarnation, max(self._last[1], msg.seq))
        elif isinstance(msg, M.OpLogAppendMsg):
            rec = OpRecord(msg.incarnation, msg.seq, msg.kind, msg.blob)
            with self._lock:
                if (rec.incarnation, rec.seq) > self._last:
                    self._tail.append(rec)
                    self._last = (rec.incarnation, rec.seq)
        elif isinstance(msg, M.PingMsg):
            conn.send(M.PongMsg(msg.req_id))
        # anything else pre-promotion is a stray; drop it

    def lag(self) -> int:
        """Entries applied locally vs the newest seq heard — the
        oplog_lag_entries gauge a promoted primary reports as the replay
        cost a failover at this instant would pay."""
        with self._lock:
            return len(self._tail)

    # -- lease watch + takeover ----------------------------------------

    def _watch_lease(self) -> None:
        ttl_s = self.conf.driver_lease_ms / 1000.0
        poll = max(0.01, ttl_s / 4.0)
        while not self._stop.is_set():
            if self._promoted.is_set():
                return
            cur = self.lease_store.read()
            now = self.lease_store.now()
            if cur is None or now >= cur.expires_at:
                term = (cur.term if cur else 0) + 1
                if self.lease_store.try_acquire(self.name, term, ttl_s,
                                                now=now):
                    try:
                        self.promote(term)
                    except Exception:  # noqa: BLE001 — keep the watcher alive
                        log.exception("standby %s: promotion at term %d "
                                      "failed", self.name, term)
                    return
            self._stop.wait(poll)

    def promote(self, term: int):
        """Replay snapshot + tail into a fresh DriverEndpoint at
        incarnation = ``term`` and swap it behind our server. Returns
        the endpoint."""
        from sparkrdma_tpu_torch.parallel.endpoints import DriverEndpoint
        with self._lock:
            snapshot = self._snapshot
            tail = sorted(self._tail, key=lambda r: (r.incarnation, r.seq))
            lag = len(tail)
        self.tracer.instant("driver.takeover", "driver", term=term,
                            lag=lag)
        self.tracer.counter("ha_failovers", 1)
        self.tracer.counter("oplog_lag_entries", lag)
        ep = DriverEndpoint(self.conf, host=self.server.host,
                            incarnation=term, server=self.server,
                            lease_store=self.lease_store,
                            lease_holder=self.name,
                            restore=(snapshot, tail))
        self.endpoint = ep
        self._promoted.set()
        log.warning("standby %s promoted to primary at incarnation %d "
                    "(replayed %d tail ops)", self.name, term, lag)
        return ep

    def stop(self) -> None:
        self._stop.set()
        self._watcher.join(timeout=2.0)
        ep = self.endpoint
        if ep is not None:
            ep.stop()
        else:
            self.server.stop()
        self._clients.close_all()
