"""Disaggregated cold shuffle tier: merge segments that outlive the fleet.

ROADMAP item 5 (the spot-instance / preemptible scenario): losing ALL K
replicas of a partition range used to mean map re-execution, and a
full-fleet restart lost everything. This module adds a cold tier UNDER
the push-merge ledger — finalized merged segments (already CRC-ledgered,
fence-superseded, token-addressable) asynchronously tier to external
storage through a narrow blob contract, per RAMC's remote-channel
framing (PAPERS.md):

* **BlobStore** — put/get/list/delete with etag-style tokens. The
  in-tree backend is a local filesystem (:class:`FSBlobStore`), but the
  contract is shaped so an object store slots in later: keys are flat
  ``/``-separated strings, puts are atomic-visible (tmp + rename), etags
  are content-derived, and list is prefix-scoped. Every operation
  consults the :class:`~sparkrdma_tpu_torch.parallel.faults.BlobFaultInjector`
  hooks, so unavailability, slow stores, torn uploads, at-rest rot, and
  quota exhaustion are reproducible on the production path.
* **TieringService** — a bounded background uploader: when a merge
  target finalizes a segment it enqueues the published descriptor here;
  the worker reads the segment's surviving ranges back through the
  ordinary resolver serve path (fence-superseded bytes are ALREADY
  excluded — ``final_rows`` resolved supersession at finalize), uploads
  them as one blob with retry+backoff, and publishes a one-sided
  ``TieredPublishMsg`` into the driver's :class:`TieredDirectory`.
  Upload failure degrades gracefully: the segment simply stays
  hot-only; tiering never fails a job.
* **TieredDirectory** — the driver's ``partition -> [TieredEntry]``
  view, HA-replicated through the PR-17 op log so cold locations
  survive driver failover. Unlike the merged directory there is no
  per-slot keying and no ``drop_slot`` pruning: blobs do NOT die with
  the executor that uploaded them — that is the whole point. Multiple
  entries per partition union their coverage (drain rows are
  per-(partition, map) blobs).
* **Resolve** — reducers resolve the TIERED location class LAST: after
  pushed staging, merged replicas, and per-map, before re-execution
  (shuffle/fetcher.py). Restores ride the ordinary BufferPool-leased
  read path with ledger-CRC verification: a rotten or torn blob
  degrades exactly that partition to the next rung, never corrupts
  output.
* **Reap** — unregister / TTL / EPOCH_DEAD delete the shuffle's blobs
  through the same tombstone discipline as the merge store: a dead
  shuffle id is tombstoned so an upload racing the unregister reaps its
  own blob and skips the publish.
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

from sparkrdma_tpu_torch.parallel import faults as fault_mod
from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel.transport import TransportError
from sparkrdma_tpu_torch.shuffle.push_merge import (
    bitmap_members,
    bitmap_new,
    bitmap_set,
)

log = logging.getLogger(__name__)


# -- the blob contract -----------------------------------------------------

class BlobMeta:
    """One listed blob: key, byte size, content etag, and last-modified
    wall time (an object store's LastModified; the FS backend's mtime)."""

    __slots__ = ("key", "size", "etag", "mtime")

    def __init__(self, key: str, size: int, etag: str, mtime: float = 0.0):
        self.key = key
        self.size = size
        self.etag = etag
        self.mtime = mtime

    def __repr__(self):
        return f"BlobMeta({self.key!r}, {self.size}, {self.etag!r})"


class BlobStore:
    """The narrow put/get/list/delete contract an object store
    implements. Keys are flat ``/``-separated strings (no ``..``, no
    leading ``/``); ``put`` is atomic-visible (a concurrent ``get``
    sees the old blob or the new one, never a torn middle) and returns
    a content-derived etag; ``get`` raises ``OSError`` on
    unavailability and ``KeyError`` on absence; ``list`` is
    prefix-scoped; ``delete`` is idempotent (False = was absent)."""

    def put(self, key: str, data: bytes) -> str:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[BlobMeta]:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _etag(data: bytes) -> str:
    return f"{zlib.crc32(data):08x}-{len(data)}"


class FSBlobStore(BlobStore):
    """Local-filesystem backend: keys map to paths under ``root``.

    The tmp + rename commit gives the atomic-visibility half of the
    contract on POSIX; the etag is content-derived (CRC32 + length) so
    a re-put of identical bytes is etag-stable, like an object store's
    content hash. Every op consults the blob fault hooks
    (:func:`~sparkrdma_tpu_torch.parallel.faults.blob_check` /
    ``blob_write_cap`` / ``blob_corrupt``) — a single attribute load
    when no injector is installed."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if not key or key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"bad blob key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, data: bytes) -> str:
        path = self._path(key)
        fault_mod.blob_check("put", key)
        cap = fault_mod.blob_write_cap("put", key, len(data))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                if cap is not None:
                    # torn upload: some bytes land, then the store errors
                    # — the tmp file never renames, so the torn middle is
                    # never visible (the atomicity half of the contract)
                    f.write(data[:cap])
                    raise OSError("fault injection: torn upload")
                f.write(data)
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        fault_mod.blob_corrupt("put", path)
        return _etag(data)

    def get(self, key: str) -> bytes:
        path = self._path(key)
        fault_mod.blob_check("get", key)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def list(self, prefix: str = "") -> List[BlobMeta]:
        fault_mod.blob_check("list", prefix)
        out: List[BlobMeta] = []
        for dirpath, _dirs, names in os.walk(self.root):
            for name in names:
                if ".tmp." in name:
                    continue
                path = os.path.join(dirpath, name)
                key = os.path.relpath(path, self.root).replace(os.sep, "/")
                if not key.startswith(prefix):
                    continue
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                    mtime = os.path.getmtime(path)
                except OSError:
                    continue
                out.append(BlobMeta(key, len(data), _etag(data), mtime))
        return sorted(out, key=lambda m: m.key)

    def delete(self, key: str) -> bool:
        path = self._path(key)
        fault_mod.blob_check("delete", key)
        try:
            os.unlink(path)
            return True
        except FileNotFoundError:
            return False


def open_store(conf) -> Optional[BlobStore]:
    """The configured blob store, or None when the cold tier is off.
    ``cold_tier_path`` names the FS backend root (an object-store URL
    scheme slots in here later)."""
    if not bool(conf.cold_tier):
        return None
    root = str(conf.cold_tier_path) or os.path.join(
        os.path.expanduser("~"), ".sparkrdma_cold")
    return FSBlobStore(root)


# -- the driver's tiered directory ----------------------------------------

_TENTRY_HEAD = struct.Struct("<iQIII")  # partition, nbytes, crc32,
#                                         key length, covered length


class TieredEntry:
    """One tiered blob: partition ``partition_id``'s bytes from the
    maps in ``covered``, stored as blob ``blob_key`` (``crc32`` over the
    whole blob, checked reducer-side on restore). No slot field — a
    blob has no owner to die."""

    __slots__ = ("partition_id", "blob_key", "nbytes", "crc32", "covered")

    def __init__(self, partition_id: int, blob_key: str, nbytes: int,
                 crc32: int, covered: bytes):
        self.partition_id = partition_id
        self.blob_key = blob_key
        self.nbytes = nbytes
        self.crc32 = crc32
        self.covered = bytes(covered)

    def covers(self, map_id: int) -> bool:
        from sparkrdma_tpu_torch.shuffle.push_merge import bitmap_get
        return bitmap_get(self.covered, map_id)

    def covered_maps(self, num_maps: int) -> List[int]:
        return bitmap_members(self.covered, num_maps)

    def to_bytes(self) -> bytes:
        key = self.blob_key.encode("utf-8")
        return (_TENTRY_HEAD.pack(self.partition_id, self.nbytes,
                                  self.crc32, len(key), len(self.covered))
                + key + self.covered)

    @staticmethod
    def from_bytes(payload: bytes, off: int = 0
                   ) -> Tuple["TieredEntry", int]:
        (partition, nbytes, crc, nkey,
         ncov) = _TENTRY_HEAD.unpack_from(payload, off)
        off += _TENTRY_HEAD.size
        key = payload[off:off + nkey].decode("utf-8")
        off += nkey
        covered = payload[off:off + ncov]
        off += ncov
        return TieredEntry(partition, key, nbytes, crc, covered), off


class TieredDirectory:
    """Per-shuffle ``partition -> {blob_key: TieredEntry}`` view.

    Driver-side the authoritative aggregation of one-sided
    ``TieredPublishMsg`` applies (HA-replicated through the op log);
    reducer-side a decoded snapshot. Keyed by blob key, NOT slot:
    multiple entries per partition union their coverage (whole-segment
    blobs from different merge targets, per-map drain rows), and a
    re-publish of the same key overwrites (newest upload wins). There
    is deliberately no ``drop_slot`` — blobs outlive executors."""

    def __init__(self):
        self._parts: Dict[int, Dict[str, TieredEntry]] = {}

    def apply(self, entry: TieredEntry) -> None:
        self._parts.setdefault(entry.partition_id, {})[entry.blob_key] \
            = entry

    def entries(self, partition: int) -> List[TieredEntry]:
        """Entries for one partition, widest coverage first (blob key
        breaks ties, deterministically)."""
        per = self._parts.get(partition, {})
        return sorted(per.values(),
                      key=lambda e: (-sum(bin(b).count("1")
                                          for b in e.covered), e.blob_key))

    def partitions(self) -> List[int]:
        return sorted(self._parts)

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts.values())

    def drop_map(self, map_id: int) -> int:
        """Remove entries covering ``map_id`` (a repair publish replaced
        the map's output — the cold copy of the OLD bytes must never
        resolve). Returns the number dropped."""
        dropped = 0
        for partition in list(self._parts):
            per = self._parts[partition]
            for key in [k for k, e in per.items() if e.covers(map_id)]:
                del per[key]
                dropped += 1
            if not per:
                del self._parts[partition]
        return dropped

    def covering(self, map_id: int, partition: int) -> List[TieredEntry]:
        return [e for e in self._parts.get(partition, {}).values()
                if e.covers(map_id)]

    def to_bytes(self) -> bytes:
        entries = [e for p in sorted(self._parts)
                   for _, e in sorted(self._parts[p].items())]
        return struct.pack("<I", len(entries)) + b"".join(
            e.to_bytes() for e in entries)

    @staticmethod
    def from_bytes(payload: bytes) -> "TieredDirectory":
        d = TieredDirectory()
        if not payload:
            return d
        (n,) = struct.unpack_from("<I", payload, 0)
        off = 4
        for _ in range(n):
            entry, off = TieredEntry.from_bytes(payload, off)
            d.apply(entry)
        return d


# -- the background uploader ----------------------------------------------

class _TierTask:
    __slots__ = ("shuffle_id", "partition", "exec_index", "token",
                 "nbytes", "crc32", "covered", "ranges", "submitted")

    def __init__(self, msg: "M.MergedPublishMsg"):
        self.shuffle_id = msg.shuffle_id
        self.partition = msg.partition_id
        self.exec_index = msg.exec_index
        self.token = msg.token
        self.nbytes = msg.nbytes
        self.crc32 = msg.crc32
        self.covered = bytes(msg.covered)
        self.ranges = list(msg.ranges)
        self.submitted = time.monotonic()


class TieringService:
    """Bounded background segment uploader on one merge target.

    ``submit(msg)`` is called alongside the one-sided merged publish at
    finalize time with the SAME descriptor the driver got: the
    surviving ranges (fence-superseded bytes already excluded), the
    serving token, and the CRC over their concatenation. The worker
    reads the bytes back through the resolver's serve path (at-rest
    spot checks apply — local rot never tiers), uploads one blob with
    ``tier_retry_budget`` retries + exponential backoff, charges the
    owning tenant's disk ledger for the cold bytes, and publishes a
    one-sided ``TieredPublishMsg``.

    The queue is bounded by ``tier_upload_budget`` in-flight BYTES:
    past it, submits are shed (the segment stays hot-only — tiering is
    strictly best-effort and never fails a job). A shuffle dropped here
    (unregister / EPOCH_DEAD) is tombstoned: a late upload for a dead
    sid deletes its own blob and skips the publish, the same discipline
    the merge store applies to zombie pushes."""

    def __init__(self, store: BlobStore, resolver, conf,
                 publish: Callable[["M.TieredPublishMsg"], None],
                 tracer=None):
        from sparkrdma_tpu_torch.utils import trace as trace_mod
        from sparkrdma_tpu_torch.utils.tombstones import TombstoneCache
        self.store = store
        self.resolver = resolver
        self.conf = conf
        self.publish = publish
        self.tracer = tracer or trace_mod.NULL
        self._q: "queue.Queue[Optional[_TierTask]]" = queue.Queue()
        self._idle = threading.Condition()
        self._inflight = 0
        self._inflight_bytes = 0
        self._stopped = False
        self._worker: Optional[threading.Thread] = None
        self._dropped = TombstoneCache(ttl_s=30.0, cap=1024)
        # cold-tier disk charges BY (shuffle, tenant), repaid at drop —
        # same conservation discipline as the merge store's ledgers
        self._charged: Dict[int, Dict[int, int]] = {}
        self.max_inflight_bytes = int(conf.tier_upload_budget)
        self.retry_budget = int(conf.tier_retry_budget)
        # audit counters
        self.uploads_done = 0
        self.uploads_failed = 0
        self.uploads_shed = 0
        self.uploads_reaped = 0  # finished for an already-dead shuffle
        self.upload_bytes = 0
        self.rows_tiered = 0  # drain rows tiered synchronously

    # -- segment uploads (async, from the finalize publish path) ---------

    def submit(self, msg: "M.MergedPublishMsg") -> bool:
        """Enqueue one finalized segment for upload; False = shed
        (budget exhausted or service stopped) — never an error."""
        task = _TierTask(msg)
        with self._idle:
            if self._stopped or msg.shuffle_id in self._dropped:
                return False
            if (self._inflight_bytes + task.nbytes
                    > self.max_inflight_bytes and self._inflight > 0):
                self.uploads_shed += 1
                return False
            self._inflight += 1
            self._inflight_bytes += task.nbytes
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, daemon=True, name="cold-tier")
                self._worker.start()
        self._q.put(task)
        return True

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            try:
                self._upload(task)
            except Exception:  # noqa: BLE001 — an upload must never
                # kill the worker; the segment stays hot-only
                self.uploads_failed += 1
                log.exception("cold-tier upload of shuffle %d partition "
                              "%d failed", task.shuffle_id, task.partition)
            finally:
                with self._idle:
                    self._inflight -= 1
                    self._inflight_bytes -= task.nbytes
                    self._idle.notify_all()

    def _segment_key(self, task: _TierTask) -> str:
        # slot + token uniquified: tokens are PER-EXECUTOR counters, so
        # two targets' segments for sibling partitions can share a
        # token — the uploader's slot disambiguates; a re-finalize
        # (drain reopen) re-registers under a fresh token, so its blob
        # never overwrites in place
        return (f"{task.shuffle_id}/p{task.partition}"
                f"/seg_{task.exec_index}_{task.token}")

    def _upload(self, task: _TierTask) -> None:
        data = bytearray()
        for off, ln in task.ranges:
            chunk = self.resolver.read_block(task.shuffle_id, task.token,
                                             off, ln)
            if chunk is None:
                return  # segment gone (dropped under the upload)
            data.extend(chunk)
        blob = bytes(data)
        if zlib.crc32(blob) != task.crc32 & 0xFFFFFFFF:
            # local rot detected before replication — the resolver's
            # verdict machinery owns escalation; nothing tiers
            self.uploads_failed += 1
            return
        key = self._segment_key(task)
        if not self._put_with_retry(key, blob):
            self.uploads_failed += 1
            return
        with self._idle:
            dead = task.shuffle_id in self._dropped
        if dead:
            # unregister/EPOCH_DEAD landed under the upload: reap the
            # blob we just wrote, skip the publish — the tombstone
            # discipline (modelcheck tier_vs_unregister)
            try:
                self.store.delete(key)
            except OSError:
                pass
            self.uploads_reaped += 1
            return
        self._charge(task.shuffle_id, len(blob))
        entry = TieredEntry(task.partition, key, len(blob), task.crc32,
                            task.covered)
        self._publish_entry(task.shuffle_id, entry)
        self.uploads_done += 1
        self.upload_bytes += len(blob)
        self.tracer.instant("cold.upload", "cold", shuffle=task.shuffle_id,
                            partition=task.partition, bytes=len(blob))

    def _put_with_retry(self, key: str, blob: bytes) -> bool:
        backoff = self.conf.retry_backoff_base_ms / 1000
        cap = self.conf.retry_backoff_cap_ms / 1000
        for attempt in range(1 + max(0, self.retry_budget)):
            try:
                self.store.put(key, blob)
                return True
            except (OSError, ValueError) as e:
                log.debug("cold-tier put %s attempt %d failed: %s",
                          key, attempt + 1, e)
                if attempt < self.retry_budget:
                    time.sleep(min(backoff * (2 ** attempt), cap))
        return False

    def _charge(self, shuffle_id: int, nbytes: int) -> None:
        tenant = self.resolver.tenant_of(shuffle_id)
        try:
            # analysis: leak-ok(cold bytes transfer to _charged; drop_shuffle repays per tenant)
            self.resolver.disk_ledger.charge(tenant, nbytes)
        except Exception:  # noqa: BLE001 — over quota: the blob still
            # serves (it is already durable); the charge is best-effort
            return
        with self._idle:
            per = self._charged.setdefault(shuffle_id, {})
            per[tenant] = per.get(tenant, 0) + nbytes

    def _publish_entry(self, shuffle_id: int, entry: TieredEntry) -> None:
        try:
            self.publish(M.TieredPublishMsg(
                shuffle_id, entry.partition_id, entry.blob_key,
                entry.nbytes, entry.crc32, entry.covered))
        except TransportError as e:
            # one-sided like every publish: a lost one costs coverage
            log.debug("tiered publish for shuffle %d partition %d lost: "
                      "%s", shuffle_id, entry.partition_id, e)

    # -- drain rows (synchronous, from the drain pass) -------------------

    def tier_row(self, shuffle_id: int, partition: int, map_id: int,
                 fence: int, data: bytes, num_maps: int) -> bool:
        """The elastic drain's cheaper exit: tier ONE only-copy ledger
        row as its own blob instead of re-pushing it to a peer.
        Synchronous (the drain deadline owns pacing); False = the store
        is down or the shuffle is dead — the caller falls back to the
        peer push."""
        with self._idle:
            if self._stopped or shuffle_id in self._dropped:
                return False
        key = f"{shuffle_id}/p{partition}/drain_m{map_id}_{fence}"
        if not self._put_with_retry(key, data):
            return False
        with self._idle:
            if shuffle_id in self._dropped:
                try:
                    self.store.delete(key)
                except OSError:
                    pass
                return False
        self._charge(shuffle_id, len(data))
        covered = bitmap_new(max(num_maps, map_id + 1))
        bitmap_set(covered, map_id)
        self._publish_entry(shuffle_id, TieredEntry(
            partition, key, len(data), zlib.crc32(data), bytes(covered)))
        self.rows_tiered += 1
        return True

    # -- lifecycle -------------------------------------------------------

    def note_registered(self, shuffle_id: int) -> None:
        """Re-arm a dropped id on authoritative registration evidence
        (same channel discipline as ``MergeStore.note_registered``)."""
        with self._idle:
            self._dropped.discard(shuffle_id)

    def drop_shuffle(self, shuffle_id: int) -> None:
        """Unregister / TTL / EPOCH_DEAD: tombstone the id, delete its
        blobs, repay the tenant charges."""
        with self._idle:
            self._dropped.add(shuffle_id)
            charged = self._charged.pop(shuffle_id, {})
        for tenant, nbytes in charged.items():
            if nbytes > 0:
                self.resolver.disk_ledger.release(tenant, nbytes)
        try:
            for meta in self.store.list(f"{shuffle_id}/"):
                try:
                    self.store.delete(meta.key)
                except OSError:
                    pass
        except OSError as e:
            log.debug("cold-tier reap of shuffle %d failed: %s",
                      shuffle_id, e)

    def reap_orphans(self, live_shuffle_ids, min_age_s: float = 60.0
                     ) -> int:
        """GC sweep (manager.gc_orphans): delete blobs of shuffles
        absent from the driver's live set — debris of dead fleets no
        unregister push will ever name. ``min_age_s`` skips blobs fresh
        enough to be an upload racing the live-set snapshot. Returns
        blobs reaped."""
        live = {int(s) for s in live_shuffle_ids}
        now = time.time()
        reaped = 0
        try:
            metas = self.store.list()
        except OSError as e:
            log.debug("cold-tier orphan sweep skipped (store down): %s", e)
            return 0
        for meta in metas:
            head = meta.key.split("/", 1)[0]
            try:
                sid = int(head)
            except ValueError:
                continue  # not ours
            if sid in live or now - meta.mtime < min_age_s:
                continue
            try:
                if self.store.delete(meta.key):
                    reaped += 1
            except OSError:
                pass
        return reaped

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted upload finished (test/bench
        determinism hook). True = drained."""
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
            sids = list(self._charged)
        for sid in sids:
            with self._idle:
                charged = self._charged.pop(sid, {})
            for tenant, nbytes in charged.items():
                if nbytes > 0:
                    self.resolver.disk_ledger.release(tenant, nbytes)
        self._q.put(None)

    def snapshot(self) -> dict:
        with self._idle:
            return {
                "uploads_done": self.uploads_done,
                "uploads_failed": self.uploads_failed,
                "uploads_shed": self.uploads_shed,
                "uploads_reaped": self.uploads_reaped,
                "upload_bytes": self.upload_bytes,
                "rows_tiered": self.rows_tiered,
            }


def wait_for_tiered_coverage(driver_endpoint, shuffle_id: int,
                             num_maps: int, num_partitions: int,
                             timeout: float = 10.0) -> bool:
    """Poll the driver's tiered directory until every (map, partition)
    is covered by some blob (tests/benches need a deterministic point
    past the asynchronous upload pipeline). True = full coverage."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        directory = driver_endpoint.tiered_directory(shuffle_id)
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
