"""Push-merge shuffle dataplane: background per-partition segment merge.

The reduce side's remaining fan-in problem: PR 3's coalescing batches the
REQUESTS per peer, but the bytes themselves stay scattered across M map
files — a reducer still drives M small server-side reads per partition,
and a lost executor still re-executes every map it owned (ROADMAP item
5). This module is the Magnet-style fix, one mechanism for both:

* **Push** (:class:`SegmentPusher`): after a map commits, a bounded
  background pusher streams its per-partition blocks — fence attached,
  sizes already in hand from the commit's partition lengths — to
  ``merge_replicas`` peer executors chosen by partition-range
  (:func:`merge_targets`). Pushes start at map COMMIT, overlapping the
  rest of the map stage, and are backpressured through
  :class:`~sparkrdma_tpu_torch.runtime.pool.BufferPool` leases so they can
  never starve foreground writes; a push older than
  ``push_deadline_ms`` is dropped (the straggler stays per-map-fetched,
  never blocks the stage).
* **Merge** (:class:`MergeStore`): each target appends pushed blocks
  into a per-(shuffle, partition) segment file with a per-block
  CRC+fence LEDGER — a stale attempt's push is rejected, a newer fence
  supersedes the stale bytes (excluded from the finalized ranges).
  Finalize (driver broadcast at map-stage completion, or the
  ``push_deadline_ms`` idle backstop) seals each segment, registers it
  with the ordinary block resolver/server, and publishes a
  :class:`MergedEntry` into the driver's :class:`MergedDirectory` —
  ONE-SIDED, under the existing epoch machinery, per "RPC Considered
  Harmful" (PAPERS.md): the serving path stays the existing block
  server with no extra server CPU per read.
* **Serve**: reducers resolve merged-segment-FIRST
  (shuffle/fetcher.py): one sequential vectored read per partition
  instead of an M-way per-map fan-in, entry-CRC verified reducer-side;
  a CRC-bad or unreachable segment degrades to the per-map dataplane
  for exactly that partition, riding PR 3's sub-block healing.
* **Recover**: executor loss becomes a location-table flip — maps every
  live replica covers are RE-POINTED (shuffle/recovery.py), only what
  no replica covers re-executes.
* **Overflow**: tiered spill may overflow to a merge peer on ENOSPC
  (:class:`MergeClient.overflow_spill`) instead of failing the attempt;
  the writer fetches the blob back at merge time over the ordinary data
  plane.
"""

from __future__ import annotations

import logging
import os
import queue
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel.transport import TransportError

log = logging.getLogger(__name__)


# -- coverage bitmaps ------------------------------------------------------

def bitmap_set(bitmap: bytearray, i: int) -> None:
    bitmap[i >> 3] |= 1 << (i & 7)


def bitmap_get(bitmap: bytes, i: int) -> bool:
    byte = i >> 3
    return byte < len(bitmap) and bool(bitmap[byte] & (1 << (i & 7)))


def bitmap_new(nbits: int) -> bytearray:
    return bytearray((nbits + 7) >> 3)


def bitmap_members(bitmap: bytes, nbits: int) -> List[int]:
    return [m for m in range(nbits) if bitmap_get(bitmap, m)]


# -- target assignment -----------------------------------------------------

def merge_targets(num_partitions: int, live_slots: Sequence[int],
                  my_slot: int, replicas: int
                  ) -> Dict[int, List[Tuple[int, int]]]:
    """``{target_slot: [(p_lo, p_hi), ...]}`` — which peer hosts which
    contiguous partition ranges, for ``replicas`` copies.

    Partition-range assignment over the candidate slots (live, excluding
    the pusher itself so a replica always survives its producer):
    partition ``p``'s primary candidate is ``p * C // P`` and replica
    ``r`` the next candidate round-robin. Deterministic per membership
    snapshot; pushers with briefly divergent views scatter segments over
    MORE targets, which the driver directory absorbs (coverage is
    whatever actually published — assignment needs no global agreement).
    """
    candidates = sorted(s for s in live_slots if s != my_slot)
    if not candidates and live_slots:
        candidates = sorted(live_slots)  # single-executor degenerate case
    if not candidates or replicas <= 0 or num_partitions <= 0:
        return {}
    k = min(replicas, len(candidates))
    out: Dict[int, List[Tuple[int, int]]] = {}
    for r in range(k):
        run_slot = None
        run_lo = 0
        for p in range(num_partitions):
            idx = (p * len(candidates) // num_partitions + r) \
                % len(candidates)
            slot = candidates[idx]
            if slot != run_slot:
                if run_slot is not None:
                    out.setdefault(run_slot, []).append((run_lo, p))
                run_slot, run_lo = slot, p
        if run_slot is not None:
            out.setdefault(run_slot, []).append((run_lo, num_partitions))
    return out


# -- the driver's merged directory ----------------------------------------

_ENTRY_HEAD = struct.Struct("<iiqqIII")  # partition, slot, token, nbytes,
#                                          crc32, ncovered, nranges
_RANGE = struct.Struct("<QI")


class MergedEntry:
    """One finalized merged segment: partition ``partition_id``'s bytes
    from the maps in ``covered``, held by executor ``slot`` as the byte
    ``ranges`` of serving token ``token`` (``crc32`` over their
    concatenation, checked reducer-side)."""

    __slots__ = ("partition_id", "slot", "token", "nbytes", "crc32",
                 "covered", "ranges")

    def __init__(self, partition_id: int, slot: int, token: int,
                 nbytes: int, crc32: int, covered: bytes,
                 ranges: Sequence[Tuple[int, int]]):
        self.partition_id = partition_id
        self.slot = slot
        self.token = token
        self.nbytes = nbytes
        self.crc32 = crc32
        self.covered = bytes(covered)
        self.ranges = tuple((int(o), int(ln)) for o, ln in ranges)

    def covers(self, map_id: int) -> bool:
        return bitmap_get(self.covered, map_id)

    def covered_maps(self, num_maps: int) -> List[int]:
        return bitmap_members(self.covered, num_maps)

    def to_bytes(self) -> bytes:
        head = _ENTRY_HEAD.pack(self.partition_id, self.slot, self.token,
                                self.nbytes, self.crc32,
                                len(self.covered), len(self.ranges))
        return head + self.covered + b"".join(
            _RANGE.pack(o, ln) for o, ln in self.ranges)

    @staticmethod
    def from_bytes(payload: bytes, off: int = 0
                   ) -> Tuple["MergedEntry", int]:
        (partition, slot, token, nbytes, crc, ncov,
         nranges) = _ENTRY_HEAD.unpack_from(payload, off)
        off += _ENTRY_HEAD.size
        covered = payload[off:off + ncov]
        off += ncov
        ranges = []
        for _ in range(nranges):
            o, ln = _RANGE.unpack_from(payload, off)
            ranges.append((o, ln))
            off += _RANGE.size
        return MergedEntry(partition, slot, token, nbytes, crc, covered,
                           ranges), off


class MergedDirectory:
    """Per-shuffle ``partition -> [MergedEntry, ...]`` view.

    Driver-side it is the authoritative aggregation of one-sided
    ``MergedPublishMsg`` applies; reducer-side a decoded, epoch-cached
    snapshot. One entry per (partition, slot): a re-finalize from the
    same slot overwrites (newest token wins, exactly like a repair
    publish overwrites a driver-table entry)."""

    def __init__(self):
        self._parts: Dict[int, Dict[int, MergedEntry]] = {}

    def apply(self, entry: MergedEntry) -> None:
        self._parts.setdefault(entry.partition_id, {})[entry.slot] = entry

    def entries(self, partition: int) -> List[MergedEntry]:
        """Entries for one partition, widest coverage first (slot index
        breaks ties, deterministically)."""
        per = self._parts.get(partition, {})
        return sorted(per.values(),
                      key=lambda e: (-sum(bin(b).count("1")
                                          for b in e.covered), e.slot))

    def partitions(self) -> List[int]:
        return sorted(self._parts)

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts.values())

    def drop_map(self, map_id: int) -> int:
        """Remove entries covering ``map_id`` (a repair publish replaced
        the map's output — deterministic re-execution writes identical
        bytes, but a corrupt-output repair may not, so the directory
        stays conservative). Returns the number dropped."""
        dropped = 0
        for partition in list(self._parts):
            per = self._parts[partition]
            for slot in [s for s, e in per.items() if e.covers(map_id)]:
                del per[slot]
                dropped += 1
            if not per:
                del self._parts[partition]
        return dropped

    def drop_slot(self, slot: int) -> int:
        """Remove entries hosted by a tombstoned executor."""
        dropped = 0
        for partition in list(self._parts):
            per = self._parts[partition]
            if per.pop(slot, None) is not None:
                dropped += 1
            if not per:
                del self._parts[partition]
        return dropped

    def covering_slots(self, map_id: int, partition: int) -> List[int]:
        return [s for s, e in self._parts.get(partition, {}).items()
                if e.covers(map_id)]

    def to_bytes(self) -> bytes:
        entries = [e for p in sorted(self._parts)
                   for _, e in sorted(self._parts[p].items())]
        return struct.pack("<I", len(entries)) + b"".join(
            e.to_bytes() for e in entries)

    @staticmethod
    def from_bytes(payload: bytes) -> "MergedDirectory":
        d = MergedDirectory()
        if not payload:
            return d
        (n,) = struct.unpack_from("<I", payload, 0)
        off = 4
        for _ in range(n):
            entry, off = MergedEntry.from_bytes(payload, off)
            d.apply(entry)
        return d


# -- the merge target ------------------------------------------------------

class _Ledger:
    """One segment's append ledger: (map, fence, offset, length, crc32)
    rows in arrival order. Fence supersession is resolved at finalize:
    for each map the NEWEST fence's row serves, older rows' byte ranges
    are excluded from the finalized range list. ``fd`` is the segment
    file's cached write descriptor (positional pwrites are offset-
    explicit and thread-safe, so one fd serves concurrent pushes);
    opened at first reservation, closed at finalize/drop."""

    __slots__ = ("path", "size", "rows", "fd")

    def __init__(self, path: str):
        self.path = path
        self.size = 0
        self.rows: List[Tuple[int, int, int, int, int]] = []
        self.fd: Optional[int] = None

    def close_fd(self) -> None:
        if self.fd is not None:
            try:
                os.close(self.fd)
            except OSError:
                pass
            self.fd = None

    def newest_fence(self, map_id: int) -> Optional[int]:
        fences = [f for m, f, _, _, _ in self.rows if m == map_id]
        return max(fences) if fences else None

    def final_rows(self) -> List[Tuple[int, int, int, int, int]]:
        newest = {}
        for row in self.rows:
            m, f = row[0], row[1]
            if m not in newest or f >= newest[m][1]:
                newest[m] = row
        return sorted(newest.values(), key=lambda r: r[2])  # offset order


class _ShuffleSegments:
    """One shuffle's state on a merge target."""

    __slots__ = ("ledgers", "num_maps", "finalized", "last_push",
                 "overflow_tokens", "writing", "charged")

    def __init__(self):
        self.ledgers: Dict[int, _Ledger] = {}  # partition -> ledger
        self.num_maps = 0
        self.finalized = False
        self.last_push = time.monotonic()
        self.overflow_tokens: List[int] = []
        self.writing = 0  # reserved-but-unwritten segment appends
        # disk-ledger charges BY TENANT: early pushes can land before
        # the TenantMapMsg teaches this target's resolver (charged to
        # DEFAULT_TENANT), later ones after — the release at drop must
        # repay each ledger exactly what was charged to it, or one
        # tenant retains phantom bytes while another's quota erases
        self.charged: Dict[int, int] = {}


class MergeStore:
    """Executor-side merge target: accepts pushes, owns segment files +
    ledgers, finalizes into the resolver's serving token space.

    Segment files live under ``<spill_dir>/merge/`` so they share the
    executor's storage-health machinery's namespace without colliding
    with the resolver's committed-output naming (``recover()`` ignores
    them; cleanup rides ``drop_shuffle``, driven by unregister/epoch
    death)."""

    def __init__(self, resolver, conf):
        self.resolver = resolver
        self.conf = conf
        self.dir = os.path.join(resolver.spill_dir, "merge")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._shuffles: Dict[int, _ShuffleSegments] = {}
        # shuffles already dropped here (unregister processed): a push
        # racing the unregister broadcast used to re-create state and
        # charge disk bytes NOTHING would ever release (drop_shuffle had
        # already run; reap_orphans deletes files, not ledger charges) —
        # the modelcheck finalize_vs_push ledger-conserve invariant.
        # Count- and time-bounded (utils/tombstones.py): zombie pushes
        # are bounded by push deadlines, and engine shuffle ids are
        # reused — an expiring marker restores push-merge for the new
        # incarnation even in deployments with no registration push.
        # A push-delivered registration signal re-arms immediately
        # (note_registered: TenantMapMsg / ShardMapMsg / pushed plan).
        from sparkrdma_tpu_torch.utils.tombstones import TombstoneCache
        self._dropped = TombstoneCache(ttl_s=30.0, cap=1024)
        self.max_segment = int(conf.merge_segment_max_bytes)
        self._ovf_seq = 0  # uniquifies overflow blob names (one map
        # attempt may overflow several spills — they must not collide)
        # audit counters
        self.pushes_accepted = 0
        self.pushes_rejected = 0
        self.segments_finalized = 0
        self.reopens = 0  # drain re-pushes that reopened a sealed shuffle

    # -- push side -------------------------------------------------------

    def _segment_path(self, shuffle_id: int, partition: int) -> str:
        return os.path.join(self.dir, f"seg_{shuffle_id}_{partition}.bin")

    def push(self, shuffle_id: int, map_id: int, fence: int,
             start_partition: int, sizes: Sequence[int],
             data: bytes, reopen: bool = False) -> Tuple[int, bytes]:
        """Append one map's blocks for partitions [start, start+len);
        returns ``(status, accepted)`` — one byte per pushed partition.

        ``reopen`` is the graceful-drain path (``PUSH_KIND_DRAIN``): a
        drain re-push may land AFTER this target sealed the shuffle —
        instead of the STATUS_FINALIZED rejection the segment REOPENS
        (the driver re-broadcasts finalize once the drainee's pass
        completes, so the new rows still publish). Ledger fences dedupe
        as always, so re-pushing what background replication already
        delivered appends nothing.

        Disk never happens under the store lock: the lock covers ledger
        bookkeeping only (fence checks, byte-range RESERVATION, row
        append), then each segment writes positionally (``pwrite``) at
        its reserved offset — concurrent pushes to one segment cannot
        interleave bytes, and a push to shuffle A never stalls behind
        shuffle B's disk (the serve pool shares these threads with
        foreground reads)."""
        accepted = bytearray(len(sizes))
        # (ledger, offset, segment view, result index, row) to write
        writes: List[tuple] = []
        segs = []
        pos = 0
        view = memoryview(data)
        for size in sizes:
            segs.append(view[pos:pos + size])
            pos += size
        with self._lock:
            if shuffle_id in self._dropped:
                # the unregister broadcast already dropped this shuffle
                # here: accepting would charge disk bytes no drop will
                # ever release. FINALIZED stops the pusher for good.
                self.pushes_rejected += len(sizes)
                return M.STATUS_FINALIZED, bytes(accepted)
            state = self._shuffles.get(shuffle_id)
            if state is None:
                state = _ShuffleSegments()
                self._shuffles[shuffle_id] = state
            if state.finalized:
                if not reopen:
                    self.pushes_rejected += len(sizes)
                    return M.STATUS_FINALIZED, bytes(accepted)
                state.finalized = False
                self.reopens += 1
            state.last_push = time.monotonic()
            state.num_maps = max(state.num_maps, map_id + 1)
            for i, size in enumerate(sizes):
                p = start_partition + i
                ledger = state.ledgers.get(p)
                if ledger is None:
                    ledger = _Ledger(self._segment_path(shuffle_id, p))
                    state.ledgers[p] = ledger
                newest = ledger.newest_fence(map_id)
                if newest is not None and fence <= newest:
                    self.pushes_rejected += 1
                    continue  # duplicate or stale attempt's push
                if ledger.size + size > self.max_segment:
                    self.pushes_rejected += 1
                    continue  # segment full: this map stays per-map here
                # tenancy: merged-segment disk charges the OWNING tenant
                # (resolver.disk_ledger); past its spill quota the push
                # is shed exactly like a full segment — the map stays
                # per-map-fetched, nothing breaks
                tenant = self.resolver.tenant_of(shuffle_id)
                try:
                    # analysis: leak-ok(accepted rows transfer to state.charged; drop_shuffle repays per tenant)
                    self.resolver.disk_ledger.charge(tenant, size)
                except Exception:
                    self.pushes_rejected += 1
                    continue
                state.charged[tenant] = state.charged.get(tenant, 0) + size
                if ledger.fd is None:
                    try:
                        ledger.fd = os.open(
                            ledger.path, os.O_WRONLY | os.O_CREAT, 0o644)
                    except OSError as e:
                        log.warning("merge segment open %s failed: %s",
                                    ledger.path, e)
                        self.pushes_rejected += 1
                        # un-charge: no bytes will land for this push
                        state.charged[tenant] -= size
                        self.resolver.disk_ledger.release(tenant, size)
                        continue
                row = (map_id, fence, ledger.size, size,
                       zlib.crc32(segs[i]))
                ledger.rows.append(row)
                ledger.size += size
                writes.append((ledger, row[2], segs[i], i, row, tenant))
            state.writing += len(writes)
        ok = 0
        for ledger, off, seg, i, row, row_tenant in writes:
            try:
                os.pwrite(ledger.fd, seg, off)
                accepted[i] = 1
                ok += 1
            except OSError as e:
                log.warning("merge push append to %s failed: %s",
                            ledger.path, e)
                with self._lock:
                    # un-reserve: a row without bytes must never reach a
                    # finalized range list (the hole it leaves in the
                    # file is excluded with it)
                    try:
                        ledger.rows.remove(row)
                    except ValueError:
                        pass
                    self.pushes_rejected += 1
                    state.charged[row_tenant] = \
                        state.charged.get(row_tenant, 0) - row[3]
                self.resolver.disk_ledger.release(row_tenant, row[3])
        with self._lock:
            self.pushes_accepted += ok
            state.writing -= len(writes)
        return M.STATUS_OK, bytes(accepted)

    def push_overflow(self, shuffle_id: int, map_id: int, fence: int,
                      data: bytes) -> Tuple[int, int]:
        """Store one spill-overflow blob; returns (status, serving
        token). The blob is registered with the resolver so the writer
        fetches it back over the ordinary block dataplane."""
        with self._lock:
            if shuffle_id in self._dropped:
                return M.STATUS_FINALIZED, 0  # unregistered: no parking
            seq = self._ovf_seq
            self._ovf_seq += 1
        # tenancy: overflow blobs are disk the owning tenant parks here
        tenant = self.resolver.tenant_of(shuffle_id)
        try:
            # analysis: leak-ok(stored blobs transfer to state.charged; drop_shuffle repays per tenant)
            self.resolver.disk_ledger.charge(tenant, len(data))
        except Exception:
            return M.STATUS_ERROR, 0
        path = os.path.join(
            self.dir, f"ovf_{shuffle_id}_{map_id}_{fence}.{seq}.bin")
        try:
            with open(path, "wb") as f:
                f.write(data)
            token = self.resolver.register_external(shuffle_id, path,
                                                    len(data))
        except OSError as e:
            log.warning("overflow blob store failed: %s", e)
            self.resolver.disk_ledger.release(tenant, len(data))
            return M.STATUS_ERROR, 0
        with self._lock:
            if shuffle_id in self._dropped:
                # the unregister broadcast landed in the window between
                # the entry check and here (disk + registration happen
                # OUTSIDE the lock): unwind everything this call did —
                # recording the charge in a re-created state would park
                # bytes no drop will ever repay (push() is immune: its
                # check, charge, and record share one lock block)
                unwind = True
            else:
                unwind = False
                state = self._shuffles.get(shuffle_id)
                if state is None:
                    state = _ShuffleSegments()
                    self._shuffles[shuffle_id] = state
                state.overflow_tokens.append(token)
                state.charged[tenant] = state.charged.get(tenant, 0) \
                    + len(data)
        if unwind:
            self.resolver.disk_ledger.release(tenant, len(data))
            # the dropped shuffle's other externals are already gone;
            # this releases (and deletes) only the blob just parked
            self.resolver.release_externals(shuffle_id)
            return M.STATUS_FINALIZED, 0
        return M.STATUS_OK, token

    def hosted_shuffles(self) -> List[int]:
        """Shuffle ids with at least one non-empty ledger here — the
        cheap metadata pass a drain uses to prefetch directories before
        streaming :meth:`export_rows` (which reads file payloads and
        must stay lazy)."""
        with self._lock:
            return sorted(sid for sid, state in self._shuffles.items()
                          if any(ledger.rows
                                 for ledger in state.ledgers.values()))

    def export_rows(self):
        """Yield every surviving ledger row as ``(shuffle_id, partition,
        map_id, fence, bytes)`` — the graceful-drain HANDOFF source: a
        retiring target re-pushes the rows it hosts for other
        executors' maps to surviving peers, so replicas this fleet
        already paid for don't silently die with the slot. Fence
        supersession is resolved (``final_rows``), bookkeeping is
        snapshotted under the lock, file reads happen outside it."""
        with self._lock:
            items = [(sid, p, ledger.path, ledger.final_rows())
                     for sid, state in self._shuffles.items()
                     for p, ledger in state.ledgers.items()]
        for sid, partition, path, rows in sorted(
                items, key=lambda it: (it[0], it[1])):
            if not rows:
                continue
            try:
                f = open(path, "rb")
            except OSError as e:
                log.warning("drain export of %s failed: %s", path, e)
                continue
            with f:
                for map_id, fence, off, ln, _crc in rows:
                    try:
                        f.seek(off)
                        data = f.read(ln)
                    except OSError:
                        continue
                    if len(data) == ln:
                        yield sid, partition, map_id, fence, data

    # -- finalize --------------------------------------------------------

    def idle_for(self, shuffle_id: int) -> float:
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            return (time.monotonic() - state.last_push
                    if state is not None else float("inf"))

    def finalize(self, shuffle_id: int, exec_index: int,
                 publish: Callable[[M.MergedPublishMsg], None],
                 tracer=None) -> int:
        """Seal every segment of the shuffle: resolve fence supersession
        into the final range list, CRC the surviving bytes, register the
        file for serving, and publish one :class:`MergedPublishMsg` per
        partition. Idempotent — a second finalize is a no-op."""
        with self._lock:
            state = self._shuffles.get(shuffle_id)
            if state is None:
                # the broadcast beat every push to this target: leave a
                # FINALIZED tombstone so later pushes answer
                # STATUS_FINALIZED (the pusher stops) instead of being
                # accepted into segments nothing will ever seal
                state = _ShuffleSegments()
                state.finalized = True
                self._shuffles[shuffle_id] = state
                return 0
            if state.finalized:
                return 0
            state.finalized = True
        # reserved rows whose pwrite is still in flight must land before
        # the seal reads the file, or the published CRC would cover a
        # hole (harmless — the reducer's CRC check degrades it — but a
        # needless coverage loss); new pushes are already barred
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._lock:
                if state.writing == 0:
                    break
            time.sleep(0.005)
        with self._lock:
            ledgers = dict(state.ledgers)
            num_maps = state.num_maps
        published = 0
        for partition, ledger in sorted(ledgers.items()):
            ledger.close_fd()  # writes quiesced above; seal the file
            rows = ledger.final_rows()
            if not rows:
                continue
            covered = bitmap_new(num_maps)
            ranges: List[Tuple[int, int]] = []
            range_crcs: List[int] = []  # one per coalesced range
            crc = 0
            try:
                with open(ledger.path, "rb") as f:
                    for m, _fence, off, ln, _row_crc in rows:
                        bitmap_set(covered, m)
                        f.seek(off)
                        seg = f.read(ln)
                        crc = zlib.crc32(seg, crc)
                        if ranges and ranges[-1][0] + ranges[-1][1] == off:
                            ranges[-1] = (ranges[-1][0],
                                          ranges[-1][1] + ln)
                            range_crcs[-1] = zlib.crc32(seg, range_crcs[-1])
                        else:
                            ranges.append((off, ln))
                            range_crcs.append(zlib.crc32(seg))
                # the reducer's merged read requests EXACTLY these
                # coalesced ranges, so attesting them here lets the
                # serving side reuse the CRCs (zero-copy with trailers
                # on) instead of re-hashing the segment every serve
                token = self.resolver.register_external(
                    shuffle_id, ledger.path, ledger.size,
                    crc_ranges=[(o, ln, c) for (o, ln), c
                                in zip(ranges, range_crcs)])
            except OSError as e:
                log.warning("finalize of %s failed: %s", ledger.path, e)
                continue
            nbytes = sum(ln for _, ln in ranges)
            try:
                publish(M.MergedPublishMsg(shuffle_id, partition,
                                           exec_index, token, nbytes, crc,
                                           bytes(covered), ranges))
            except TransportError as e:
                # one-sided like every publish: a lost one costs coverage
                log.debug("merged publish for shuffle %d partition %d "
                          "lost: %s", shuffle_id, partition, e)
            published += 1
            if tracer is not None:
                tracer.instant("merge.finalize", "merge",
                               shuffle=shuffle_id, partition=partition,
                               maps=len(rows), bytes=nbytes)
        with self._lock:
            self.segments_finalized += published
        return published

    # -- lifecycle -------------------------------------------------------

    def note_registered(self, shuffle_id: int) -> None:
        """Re-arm a dropped id: the driver's registration pushes
        (TenantMapMsg, ShardMapMsg, a pushed ReducePlanMsg) ride the
        same broadcast channel as the unregister that dropped it, so
        their arrival is authoritative evidence the id was reused for
        a NEW shuffle."""
        with self._lock:
            self._dropped.discard(shuffle_id)

    def drop_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            state = self._shuffles.pop(shuffle_id, None)
            self._dropped.add(shuffle_id)
        if state is None:
            return
        for tenant, nbytes in state.charged.items():
            if nbytes > 0:
                self.resolver.disk_ledger.release(tenant, nbytes)
        for ledger in state.ledgers.values():
            ledger.close_fd()
            try:
                os.unlink(ledger.path)
            except OSError:
                pass
        # finalized segments + overflow blobs were registered with the
        # resolver; external release unregisters serving and deletes
        self.resolver.release_externals(shuffle_id)

    def reap_orphans(self, live_shuffle_ids, min_age_s: float = 60.0
                     ) -> int:
        """GC sweep of ``<spill>/merge/``: delete segment files and
        overflow blobs whose shuffle is neither registered at the driver
        (``live_shuffle_ids``) nor known to this store — leftovers of a
        crashed process no unregister push will ever name. ``min_age_s``
        guards the snapshot race (a push landing for a shuffle
        registered after the live set was taken); only files older than
        it are eligible. Returns the number of files reaped."""
        import re
        live = set(int(s) for s in live_shuffle_ids)
        with self._lock:
            local = set(self._shuffles)
        pat = re.compile(r"^(?:seg|ovf)_(\d+)_")
        cutoff = time.time() - min_age_s
        reaped = 0
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        for name in names:
            m = pat.match(name)
            if m is None or int(m.group(1)) in live \
                    or int(m.group(1)) in local:
                continue
            path = os.path.join(self.dir, name)
            try:
                if os.stat(path).st_mtime > cutoff:
                    continue  # too fresh: may be a racing push
                os.unlink(path)
                reaped += 1
            except OSError:
                pass
        return reaped

    def stop(self) -> None:
        with self._lock:
            sids = list(self._shuffles)
        for sid in sids:
            self.drop_shuffle(sid)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "shuffles": len(self._shuffles),
                "pushes_accepted": self.pushes_accepted,
                "pushes_rejected": self.pushes_rejected,
                "segments_finalized": self.segments_finalized,
            }


# -- the pusher ------------------------------------------------------------

class _PushTask:
    __slots__ = ("shuffle_id", "map_id", "fence", "partition_lengths",
                 "num_partitions", "submitted", "planned_only")

    def __init__(self, shuffle_id: int, map_id: int, fence: int,
                 partition_lengths: Sequence[int],
                 planned_only: bool = False):
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.fence = fence
        self.partition_lengths = [int(n) for n in partition_lengths]
        self.num_partitions = len(self.partition_lengths)
        self.submitted = time.monotonic()
        # replay entries (a plan landed after the map committed, or a
        # re-plan re-routed it) redo ONLY the planned push — the merge
        # push already happened at commit time
        self.planned_only = planned_only


class SegmentPusher:
    """The bounded background pusher: one worker drains a queue of
    committed maps, reading each map's partition-range bytes out of the
    LOCAL resolver (serve-path reads, so at-rest spot checks apply — a
    rotted local file is never replicated) staged through a
    :class:`BufferPool` lease (foreground writes hold pool priority: an
    exhausted pool makes the PUSHER wait, bounded, then degrade to an
    unleased copy), and sending one ``PushBlocksReq`` per (target,
    partition-range). Queue entries are descriptors, not bytes — memory
    is bounded by one staged range at a time."""

    def __init__(self, endpoint, resolver, conf, pool=None, tracer=None,
                 pushed_store=None):
        from sparkrdma_tpu_torch.utils import trace as trace_mod
        self.endpoint = endpoint
        self.resolver = resolver
        self.conf = conf
        self.pool = pool
        self.tracer = tracer or trace_mod.NULL
        # the LOCAL PushedInputStore: a planned range whose destination
        # is this executor lands directly (no RPC, no wire copy)
        self.pushed_store = pushed_store
        self._q: "queue.Queue[Optional[_PushTask]]" = queue.Queue()
        self._idle = threading.Condition()
        self._inflight = 0
        self._stopped = False
        self._worker: Optional[threading.Thread] = None
        # planned push: submitted maps logged per shuffle so a plan that
        # lands (or re-plans) AFTER the commit replays them against the
        # fresh placements; (sid, map) -> plan epoch already pushed at,
        # so the eager path and the replay never double-push one epoch
        self._planned_log: Dict[int, List[Tuple[int, int, List[int]]]] = {}
        self._planned_done: Dict[Tuple[int, int], int] = {}
        # native raw-frame sender (csrc/fetchclient.cpp, fc_submit_raw):
        # planned-push frames batch per doorbell on persistent raw-mode
        # connections — created lazily ON the worker thread (one engine
        # per thread), torn down when the worker exits
        self._push_engine = None
        self._push_conns: Dict[int, int] = {}  # slot -> conn id
        self._push_req_id = 0
        # audit counters
        self.pushes_sent = 0
        self.push_bytes = 0
        self.pushes_dropped = 0
        self.push_failures = 0
        self.planned_sent = 0
        self.planned_bytes = 0
        self.planned_local = 0
        self.planned_failures = 0
        self.planned_native = 0  # planned sends carried by the raw engine

    def _planned_on(self) -> bool:
        # planned routing needs a ReducePlan, which needs adaptive_plan
        return bool(self.conf.planned_push) and bool(self.conf.adaptive_plan)

    def _merge_on(self) -> bool:
        return bool(self.conf.push_merge) \
            and int(self.conf.merge_replicas) > 0

    def submit(self, shuffle_id: int, map_id: int, fence: int,
               partition_lengths: Sequence[int]) -> None:
        if not self._merge_on() and not self._planned_on():
            return
        task = _PushTask(shuffle_id, map_id, fence, partition_lengths)
        with self._idle:
            if self._stopped:
                return
            if self._planned_on():
                self._planned_log.setdefault(shuffle_id, []).append(
                    (map_id, fence, task.partition_lengths))
            self._inflight += 1
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, daemon=True, name="merge-pusher")
                self._worker.start()
        self._q.put(task)

    def on_plan(self, shuffle_id: int) -> None:
        """A ReducePlan landed for ``shuffle_id`` (initial publish or
        re-plan): replay every committed map's PLANNED push against the
        fresh placements. Replay entries carry a fresh deadline clock —
        the plan's arrival, not the original commit, started their
        usefulness window — and the per-epoch dedupe in
        :meth:`_push_planned` makes an already-eager-pushed epoch a
        no-op."""
        if not self._planned_on():
            return
        with self._idle:
            if self._stopped:
                return
            entries = list(self._planned_log.get(shuffle_id, ()))
            if not entries:
                return
            self._inflight += len(entries)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, daemon=True, name="merge-pusher")
                self._worker.start()
        for map_id, fence, lengths in entries:
            self._q.put(_PushTask(shuffle_id, map_id, fence, lengths,
                                  planned_only=True))

    def forget(self, shuffle_id: int) -> None:
        """Drop the shuffle's replay log (unregister / epoch death)."""
        with self._idle:
            self._planned_log.pop(shuffle_id, None)
            for key in [k for k in self._planned_done
                        if k[0] == shuffle_id]:
                del self._planned_done[key]

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted push has been sent or dropped
        (test/bench determinism hook). True = drained."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(timeout=min(0.05, remaining))
        return True

    def stop(self) -> None:
        with self._idle:
            self._stopped = True
        self._q.put(None)

    def _run(self) -> None:
        try:
            while True:
                task = self._q.get()
                if task is None:
                    return
                try:
                    self._push_map(task)
                except Exception:  # noqa: BLE001 — a push must never
                    # kill the worker; the map stays per-map-fetched
                    self.push_failures += 1
                    log.exception("push of shuffle %d map %d failed",
                                  task.shuffle_id, task.map_id)
                finally:
                    with self._idle:
                        self._inflight -= 1
                        self._idle.notify_all()
        finally:
            self._close_push_engine()

    def _targets(self, task: _PushTask) -> Dict[int, List[Tuple[int, int]]]:
        from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
        members = self.endpoint.members()
        # live AND not draining: a slot the membership plane marked
        # DRAINING is about to leave — replicas parked there would need
        # an immediate handoff, so stop choosing it now (the drainee
        # itself is excluded by my_slot as always). Pre-elastic drivers
        # never push states, so slot_draining is uniformly False.
        draining = getattr(self.endpoint, "slot_draining", None)
        live = [i for i, m in enumerate(members) if m != TOMBSTONE
                and not (draining is not None and draining(i))]
        try:
            my = self.endpoint.exec_index()
        except KeyError:
            my = -1
        return merge_targets(task.num_partitions, live, my,
                             int(self.conf.merge_replicas))

    def _stage(self, nbytes: int, tenant: int = 0):
        """A staging lease for one partition-range: pool-leased when the
        pool admits it within a short bounded wait (foreground writers
        win contention), else a plain buffer — the pusher degrades,
        never blocks the write path. A tenant over its lease quota
        degrades the same way (the push still happens, unleased)."""
        if self.pool is None or nbytes == 0:
            return None
        from sparkrdma_tpu_torch.shuffle.tenancy import TenantQuotaError
        for _ in range(3):
            try:
                return self.pool.get(nbytes, tenant=tenant)
            except TenantQuotaError:
                return None
            except MemoryError:
                time.sleep(0.005)
        return None

    def _push_map(self, task: _PushTask) -> None:
        if self._planned_on():
            self._push_planned(task)
        if task.planned_only or not self._merge_on():
            return
        deadline_s = self.conf.push_deadline_ms / 1000
        targets = self._targets(task)
        for slot, p_ranges in sorted(targets.items()):
            for lo, hi in p_ranges:
                if time.monotonic() - task.submitted > deadline_s:
                    self.pushes_dropped += 1
                    self.tracer.instant("push.drop", "merge",
                                        shuffle=task.shuffle_id,
                                        map=task.map_id, target=slot)
                    return
                # NOTE: all-empty ranges still push — the ledger must
                # record the map as covered even where it wrote nothing,
                # or coverage checks would treat empty maps as stragglers
                sizes = task.partition_lengths[lo:hi]
                try:
                    data = self.resolver.local_blocks(
                        task.shuffle_id, task.map_id, lo, hi)
                except Exception as e:  # noqa: BLE001 — corrupt/EIO
                    # local outputs must not replicate rot; the map
                    # stays per-map-fetched and the serve path's own
                    # verdict machinery owns the escalation
                    self.push_failures += 1
                    log.warning("push read of shuffle %d map %d [%d,%d) "
                                "failed: %s", task.shuffle_id,
                                task.map_id, lo, hi, e)
                    return
                if data is None:
                    return  # output gone (unregistered/superseded)
                # the lease is a pure BACKPRESSURE token: it charges the
                # push's in-flight bytes against the pool gauge (so the
                # pusher waits when foreground writers hold the pool)
                # without copying — `data` itself rides the wire
                lease = self._stage(len(data),
                                    tenant=self.resolver.tenant_of(
                                        task.shuffle_id))
                try:
                    ok = self._send(slot, task, lo, sizes, data)
                finally:
                    if lease is not None:
                        lease.free()
                if not ok:
                    break  # next replica target still gets its copy

    def _send(self, slot: int, task: _PushTask, lo: int,
              sizes: List[int], data: bytes) -> bool:
        try:
            peer = self.endpoint.member_at(slot)
        except Exception:  # noqa: BLE001 — tombstoned mid-push
            return False
        try:
            with self.tracer.span("push.map", "merge",
                                  shuffle=task.shuffle_id,
                                  map=task.map_id, target=slot,
                                  bytes=len(data)):
                resp = self.endpoint.push_blocks(
                    peer, task.shuffle_id, task.map_id, task.fence,
                    M.PUSH_KIND_MERGE, lo, sizes, data)
        except (TransportError, TimeoutError) as e:
            self.push_failures += 1
            log.debug("push to slot %d failed: %s", slot, e)
            return False
        if resp.status == M.STATUS_FINALIZED:
            return False
        self.pushes_sent += 1
        self.push_bytes += len(data)
        return True

    # -- planned push (shuffle/pushed_store.py receive path) -------------

    def _push_planned(self, task: _PushTask) -> None:
        """Push this committed map's bytes to the PLANNED reducer slot
        of every plan task whose map range covers it (split tasks
        included — their map slices tile the map space). Cache-only plan
        resolution: no plan yet means no push now — :meth:`on_plan`
        replays this map when the broadcast lands. One epoch pushes at
        most once per map (the receive-side fence dedupe backstops the
        race between the eager path and a replay)."""
        plane = getattr(self.endpoint, "location_plane", None)
        plan = plane.plan(task.shuffle_id) if plane is not None else None
        if plan is None:
            return
        done_key = (task.shuffle_id, task.map_id)
        with self._idle:
            if self._planned_done.get(done_key, 0) >= plan.plan_epoch:
                return
            self._planned_done[done_key] = plan.plan_epoch
        try:
            my = self.endpoint.exec_index()
        except Exception:  # noqa: BLE001 — not yet joined
            my = -1
        deadline_s = self.conf.push_deadline_ms / 1000
        # remote sends collect here and go out as ONE doorbell batch on
        # the native raw engine (falling back per-send to the Python
        # RPC); leases stay staged until the batch settles
        sends: List[tuple] = []
        for t in plan.tasks:
            if t.placement < 0:
                continue  # no planned destination: stays pull-fetched
            if not (t.map_start <= task.map_id < t.map_end):
                continue  # a split sibling owns this map's slice
            if time.monotonic() - task.submitted > deadline_s:
                self.pushes_dropped += 1
                self.tracer.instant("push.drop", "merge",
                                    shuffle=task.shuffle_id,
                                    map=task.map_id, target=t.placement)
                break  # already-collected sends still go out
            lo, hi = t.start_partition, t.end_partition
            sizes = task.partition_lengths[lo:hi]
            try:
                data = self.resolver.local_blocks(
                    task.shuffle_id, task.map_id, lo, hi)
            except Exception as e:  # noqa: BLE001 — corrupt/EIO: local
                # rot must not replicate; the range stays pull-fetched
                self.planned_failures += 1
                log.warning("planned push read of shuffle %d map %d "
                            "[%d,%d) failed: %s", task.shuffle_id,
                            task.map_id, lo, hi, e)
                break
            if data is None:
                break  # output gone (unregistered/superseded)
            if t.placement == my:
                # destination is THIS executor: land directly in the
                # local store — zero RPCs, zero wire copies
                if self.pushed_store is not None:
                    self.pushed_store.push(
                        task.shuffle_id, task.map_id, task.fence,
                        plan.plan_epoch, lo, sizes, data)
                    self.planned_local += 1
                continue
            lease = self._stage(len(data),
                                tenant=self.resolver.tenant_of(
                                    task.shuffle_id))
            sends.append((t.placement, task, plan.plan_epoch, lo, sizes,
                          data, lease))
        self._send_planned_batch(sends)

    def _send_planned(self, slot: int, task: _PushTask, plan_epoch: int,
                      lo: int, sizes: List[int], data: bytes) -> bool:
        try:
            peer = self.endpoint.member_at(slot)
        except Exception:  # noqa: BLE001 — tombstoned mid-push: the
            # range stays a hole the reducer pull-fills
            return False
        try:
            with self.tracer.span("push.planned", "push",
                                  shuffle=task.shuffle_id,
                                  map=task.map_id, target=slot,
                                  epoch=plan_epoch, bytes=len(data)):
                resp = self.endpoint.push_planned(
                    peer, task.shuffle_id, task.map_id, task.fence,
                    plan_epoch, lo, sizes, data)
        except (TransportError, TimeoutError) as e:
            self.planned_failures += 1
            log.debug("planned push to slot %d failed: %s", slot, e)
            return False
        if resp.status != M.STATUS_OK:
            return False
        self.planned_sent += 1
        self.planned_bytes += len(data)
        return True

    # -- native raw-frame sender (shared fc engine, fc_submit_raw) -------

    def _native_push_engine(self):
        """The worker thread's raw-frame engine, created lazily; None
        when the native client isn't built or the wire isn't plain
        (compression/codec transform frames the C side won't)."""
        if self._push_engine is not None:
            return self._push_engine
        if (not self.conf.native_fetch or self.conf.wire_compress
                or getattr(self.endpoint, "_codec", None) is not None):
            return None
        from sparkrdma_tpu_torch.shuffle.native_fetch import NativeFetchEngine
        if not NativeFetchEngine.available():
            return None
        try:
            self._push_engine = NativeFetchEngine()
        except RuntimeError:
            return None
        return self._push_engine

    def _close_push_engine(self) -> None:
        eng, self._push_engine = self._push_engine, None
        self._push_conns.clear()
        if eng is not None:
            eng.close()

    def _native_push_conn(self, eng, slot: int) -> int:
        """A cached raw-mode connection to ``slot``'s control port (the
        Python server speaks the same frames; replies are FIFO per
        connection). 0 = unreachable."""
        conn = self._push_conns.get(slot)
        if conn and eng.alive(conn):
            return conn
        self._push_conns.pop(slot, None)
        try:
            peer = self.endpoint.member_at(slot)
        except Exception:  # noqa: BLE001 — tombstoned mid-push
            return 0
        conn = eng.connect(peer.rpc_host, peer.rpc_port, raw=True,
                           timeout_ms=self.conf.connect_timeout_ms)
        if conn:
            self._push_conns[slot] = conn
        return conn

    def _send_planned_batch(self, sends: List[tuple]) -> None:
        """Send one map's collected planned pushes: doorbell-batched
        raw frames on the native engine where possible, the per-send
        Python RPC for the rest. Any native anomaly (dead connection,
        undecodable reply, deadline) re-sends that item over the Python
        path — the receive-side fence/epoch dedupe makes the replay
        idempotent. Staging leases free only after the batch settles."""
        try:
            eng = self._native_push_engine() if sends else None
            fallback = []
            if eng is None:
                fallback = sends
            else:
                pending = {}  # req_id -> (item, resp_buf)
                batch = max(1, self.conf.fetch_doorbell_batch)
                unsent = 0
                for item in sends:
                    slot, task, plan_epoch, lo, sizes, data, _lease = item
                    conn = self._native_push_conn(eng, slot)
                    if not conn:
                        fallback.append(item)
                        continue
                    self._push_req_id += 1
                    req = M.PushPlannedReq(self._push_req_id,
                                           task.shuffle_id, task.map_id,
                                           task.fence, plan_epoch, lo,
                                           list(sizes), data)
                    # reply: _QI head + one verdict byte per partition
                    resp_buf = bytearray(64 + len(sizes))
                    if eng.submit_raw(conn, req.req_id, req.encode(),
                                      resp_buf) != 0:
                        fallback.append(item)
                        continue
                    pending[req.req_id] = (item, resp_buf)
                    unsent += 1
                    if unsent >= batch:
                        eng.flush()
                        unsent = 0
                if unsent:
                    eng.flush()
                deadline = (time.monotonic()
                            + self.conf.resolved_request_deadline_s())
                while pending and time.monotonic() < deadline:
                    for c in eng.poll(50):
                        ent = pending.pop(c.req_id, None)
                        if ent is None:
                            continue
                        item, buf = ent
                        if not self._settle_native_push(item, c, buf):
                            fallback.append(item)
                if pending:
                    # server stalled under the batch: redial next map,
                    # replay these over the Python path
                    self._close_push_engine()
                    fallback.extend(item for item, _ in pending.values())
            for item in fallback:
                slot, task, plan_epoch, lo, sizes, data, _lease = item
                self._send_planned(slot, task, plan_epoch, lo, sizes,
                                   data)
        finally:
            for *_rest, lease in sends:
                if lease is not None:
                    lease.free()

    def _settle_native_push(self, item: tuple, comp, buf: bytearray
                            ) -> bool:
        """One raw completion -> the Python sender's verdict accounting.
        False = replay this item over the Python RPC."""
        from sparkrdma_tpu_torch.shuffle.native_fetch import NativeFetchEngine
        slot, task, plan_epoch, _lo, _sizes, data, _lease = item
        if comp.status != 0 or comp.nbytes <= 0:
            return False  # connection died under the request
        try:
            resp = NativeFetchEngine.decode_reply(
                comp.frame_type, bytes(buf[:comp.nbytes]))
        except Exception:  # noqa: BLE001 — undecodable reply
            return False
        if not isinstance(resp, M.PushPlannedResp):
            return False
        self.planned_native += 1
        self.tracer.instant("push.planned_native", "push",
                            shuffle=task.shuffle_id, map=task.map_id,
                            target=slot, epoch=plan_epoch,
                            bytes=len(data))
        if resp.status != M.STATUS_OK:
            return True  # an authoritative rejection, not a failure
        self.planned_sent += 1
        self.planned_bytes += len(data)
        return True


def wait_for_coverage(driver_endpoint, shuffle_id: int, num_maps: int,
                      num_partitions: int, timeout: float = 10.0) -> bool:
    """Poll the driver's merged directory until every (map, partition)
    is covered by some entry (tests/benches need a deterministic point
    past the asynchronous push+finalize pipeline). True = full
    coverage."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        directory = driver_endpoint.merged_directory(shuffle_id)
        if directory is not None:
            full = all(
                set(range(num_maps)) == set().union(
                    set(), *[set(e.covered_maps(num_maps))
                             for e in directory.entries(p)])
                for p in range(num_partitions))
            if full:
                return True
        time.sleep(0.02)
    return False


# -- writer-side overflow client ------------------------------------------

class RemoteSpillHandle:
    """One spill-overflow blob parked on a merge peer: fetched back at
    merge time over the ordinary data plane."""

    __slots__ = ("endpoint", "peer", "shuffle_id", "token", "size")

    def __init__(self, endpoint, peer, shuffle_id: int, token: int,
                 size: int):
        self.endpoint = endpoint
        self.peer = peer
        self.shuffle_id = shuffle_id
        self.token = token
        self.size = size

    def fetch(self) -> bytes:
        return self.endpoint.fetch_blocks(
            self.peer, self.shuffle_id, [(self.token, 0, self.size)])


class MergeClient:
    """The writer-facing half of push-merge on one executor: overflow
    spills to a merge peer when local disks are exhausted. Installed by
    the manager as the writer's ``overflow_spill`` hook."""

    def __init__(self, endpoint, conf):
        self.endpoint = endpoint
        self.conf = conf
        self.overflow_spills = 0  # audit

    def overflow_spill(self, shuffle_id: int, map_id: int, fence: int,
                       data: bytes) -> Optional[RemoteSpillHandle]:
        """Park one rendered spill on a live peer; None = no peer could
        take it (the caller falls back to failing the attempt)."""
        from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
        members = self.endpoint.members()
        try:
            my = self.endpoint.exec_index()
        except KeyError:
            my = -1
        draining = getattr(self.endpoint, "slot_draining", None)
        candidates = [i for i, m in enumerate(members)
                      if m != TOMBSTONE and i != my
                      and not (draining is not None and draining(i))]
        for slot in candidates:
            try:
                peer = self.endpoint.member_at(slot)
                resp = self.endpoint.push_blocks(
                    peer, shuffle_id, map_id, fence, M.PUSH_KIND_OVERFLOW,
                    0, [len(data)], data)
            except (TransportError, TimeoutError) as e:
                log.debug("overflow push to slot %d failed: %s", slot, e)
                continue
            if resp.status == M.STATUS_OK:
                self.overflow_spills += 1
                return RemoteSpillHandle(self.endpoint, peer, shuffle_id,
                                         resp.token, len(data))
        return None
