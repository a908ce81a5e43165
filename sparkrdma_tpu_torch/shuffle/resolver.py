"""Shuffle block resolver: owns staged map-output data on one executor.

Commit writes a sidecar ``.index`` file (little-endian u64 partition
lengths) next to the data file — the same durability contract Spark's
``IndexShuffleBlockResolver`` provides in the reference's stack (the plugin
intercepts ``writeIndexFileAndCommit``, scala/RdmaShuffleBlockResolver.scala:
59-65, precisely because those index files exist). ``recover()`` rebuilds
the in-memory state from those files after an executor restart, enabling
elastic rejoin without recomputing committed maps.

Hardened storage semantics (the serving path is one-sided — no server CPU
notices a bad block, PAPER §0 — so integrity and fencing live in the data
and the commit protocol itself):

* **Commit fencing**: every writer attempt holds a fencing token
  (:meth:`begin_attempt`); commit is a compare-and-swap on it. A zombie
  speculative attempt that commits after a newer attempt gets
  :class:`StaleAttemptError` (its tmp reaped) instead of clobbering the
  winner's committed file, and its publish is rejected at the driver
  (``DriverTable.publish`` fence check).
* **At-rest integrity** (``at_rest_checksum``): commit writes a CRC32
  sidecar (``<data>.crc``, per-partition + whole-file CRCs + the fence;
  ``utils/integrity.py``) BEFORE the index, so index-present implies
  sidecar-present across every crash window. ``recover()`` verifies the
  whole file on mmap-open; serve time spot-checks each partition on its
  first Python-path read, or the whole file on first location serve when
  a native block server carries the data bytes (the only Python
  touchpoint on that dataplane). A corrupt output is QUARANTINED —
  unregistered from the native server, every later serve raising
  :class:`~sparkrdma_tpu_torch.utils.integrity.CorruptOutputError`, demoted on
  the wire to the retryable ``STATUS_CORRUPT`` — and heals only by map
  re-execution (shuffle/recovery.py).
* **Spill-dir health**: the writer's fallback-directory selection and
  quarantine bookkeeping (``spill_dirs``/``spill_dir_max_failures``)
  live here, shared by every writer of the executor.

Re-design of ``scala/RdmaShuffleBlockResolver.scala`` + the data-ownership
half of ``writer/wrapper/RdmaWrapperShuffleWriter.scala`` (its
``RdmaWrapperShuffleData`` owns ``mapId -> RdmaMappedFile``, :36):

* ``commit`` renames the written temp file over the data file and maps it
  for serving (rename-commit, RdmaWrapperShuffleWriter.scala:58-63;
  mapping + location-table fill, RdmaMappedFile.java:95-157),
* remote peers read locations and bytes through the ``ShuffleDataSource``
  protocol the control plane serves,
* ``remove_shuffle`` disposes mappings and deletes files
  (scala/RdmaShuffleBlockResolver.scala:45-53).

File **tokens** are executor-unique ints naming each committed spill file —
the role the registered MR's rkey plays in the reference.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel import faults as fault_mod
from sparkrdma_tpu_torch.runtime.staging import SpillFile
from sparkrdma_tpu_torch.shuffle.map_output import MapTaskOutput
from sparkrdma_tpu_torch.utils import integrity

log = logging.getLogger(__name__)

CorruptOutputError = integrity.CorruptOutputError


class StaleAttemptError(RuntimeError):
    """A commit lost the fencing compare-and-swap: a NEWER attempt of the
    same map already committed. The loser's tmp file is reaped before
    this is raised; the caller (writer.close) reaps its spills and must
    NOT publish."""

    def __init__(self, shuffle_id: int, map_id: int, fence: int,
                 committed_fence: int):
        super().__init__(
            f"shuffle {shuffle_id} map {map_id}: attempt fence {fence} is "
            f"stale (fence {committed_fence} already committed)")
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.fence = fence
        self.committed_fence = committed_fence


class _SpillIntegrity:
    """Serve-time verification state of one committed spill."""

    __slots__ = ("part_crcs", "part_verified", "full_verified", "corrupt",
                 "lock")

    def __init__(self, part_crcs: Optional[List[int]], num_partitions: int,
                 full_verified: bool):
        self.part_crcs = part_crcs  # None = unattested (no sidecar data)
        self.part_verified = bytearray(num_partitions)
        self.full_verified = full_verified
        self.corrupt = False
        self.lock = threading.Lock()


class TpuShuffleBlockResolver:
    """shuffle_id -> map_id -> committed SpillFile; implements
    ShuffleDataSource for the executor's control server."""

    def __init__(self, spill_dir: str, block_server=None,
                 conf: Optional[TpuShuffleConf] = None):
        self.conf = conf or TpuShuffleConf()
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self._shuffles: Dict[int, Dict[int, SpillFile]] = {}
        self._by_token: Dict[int, SpillFile] = {}
        # externally-owned served files (push-merge segments, spill
        # overflow blobs): token-addressable for the block dataplane but
        # NOT map outputs — no location-table entry, no at-rest spot
        # checks (merged integrity is entry-CRC-verified reducer-side)
        self._external: Dict[int, List[SpillFile]] = {}
        self._lock = threading.Lock()
        self._tokens = itertools.count(1)
        # attempt/fence allocator: a plain guarded int (not
        # itertools.count) because recover() must be able to BUMP it past
        # fences recovered from sidecars — a restarted executor whose
        # counter restarted at 1 would otherwise lose the commit CAS to
        # its own pre-crash commits (every re-execution of a recovered
        # map would raise StaleAttemptError forever)
        self._attempt_lock = threading.Lock()
        self._next_attempt = 1
        self._commit_lock = threading.Lock()  # serializes the on-disk
        # unlink-index/rename-data/write-sidecar/write-index sequence AND
        # the fence CAS: concurrent attempts of one map must not
        # interleave into a mismatched durable set
        self._map_fences: Dict[Tuple[int, int], int] = {}
        self._integrity: Dict[int, _SpillIntegrity] = {}
        # attested (offset, length, crc32) ranges per served token — the
        # at-rest sidecar's partition CRCs (or a merge ledger's row CRCs)
        # re-shaped for serve-time reuse: a CRC-trailer serve over blocks
        # that tile these ranges combines the committed CRCs instead of
        # re-hashing the bytes, on BOTH serving dataplanes (the native
        # server gets the same table via bs_set_file_crcs)
        self._crc_ranges: Dict[int, list] = {}
        self.at_rest_checksum = bool(self.conf.at_rest_checksum)
        # spill-dir health, shared by every writer of this executor:
        # consecutive-failure counts; a dir past spill_dir_max_failures
        # is quarantined for the resolver's lifetime. Each configured
        # fallback is NAMESPACED by a digest of the primary spill dir:
        # co-hosted executors share one spill_dirs conf value, and an
        # un-namespaced sweep (recover/remove_shuffle — spill names carry
        # no executor identity) would delete a live sibling's in-flight
        # spill files. A restarted executor adopting the same primary dir
        # maps to the same namespace, so ITS orphans still get swept.
        import hashlib
        ns = "spill-" + hashlib.sha1(
            os.path.abspath(spill_dir).encode()).hexdigest()[:12]
        self.fallback_spill_dirs: List[str] = []
        for d in self.conf.resolved_spill_dirs():
            d = os.path.join(d, ns)
            try:
                os.makedirs(d, exist_ok=True)
                self.fallback_spill_dirs.append(d)
            except OSError as e:
                log.warning("fallback spill dir %s unusable at startup: %s",
                            d, e)
        self._dir_lock = threading.Lock()
        self._dir_failures: Dict[str, int] = {}
        self._dir_quarantined: set = set()
        # failure-path audit counters
        self.fenced_commits = 0
        self.corrupt_outputs = 0
        # tenancy (shuffle/tenancy.py): shuffle -> owning tenant, taught
        # by the manager at writer/reader creation and by the driver's
        # TenantMapMsg push; the disk ledger charges committed outputs,
        # merged segments and overflow blobs to their owner so one
        # tenant filling its spill quota fails ITS commit cleanly
        # instead of ENOSPCing every co-hosted tenant's spill dir.
        from sparkrdma_tpu_torch.shuffle.tenancy import TenantLedger
        self._tenant_map: Dict[int, int] = {}
        self.disk_ledger = TenantLedger("spill", self.conf.tenant_spill_quota)
        self._token_disk: Dict[int, Tuple[int, int]] = {}  # token -> (tenant, bytes)
        # native epoll server (runtime/blockserver.py): committed files are
        # registered there so peers fetch bytes without Python in the path
        self.block_server = block_server

    # -- tenancy ---------------------------------------------------------

    def note_tenant(self, shuffle_id: int, tenant: int) -> None:
        """Record the shuffle's owning tenant (idempotent)."""
        with self._lock:
            self._tenant_map[shuffle_id] = int(tenant)

    def tenant_of(self, shuffle_id: int) -> int:
        """The shuffle's owning tenant (DEFAULT_TENANT when untaught —
        a lost TenantMapMsg push degrades fairness, never correctness)."""
        with self._lock:
            return self._tenant_map.get(shuffle_id, 0)

    def _release_disk(self, token: int) -> None:
        with self._lock:
            entry = self._token_disk.pop(token, None)
        if entry is not None:
            self.disk_ledger.release(*entry)

    # -- write side ------------------------------------------------------

    def begin_attempt(self, shuffle_id: int, map_id: int) -> int:
        """Allocate this attempt's fencing token. Monotone per resolver —
        across restarts too (recover() bumps the allocator past every
        fence it reads back from a sidecar) — so attempts of one map ON
        THIS EXECUTOR are totally ordered; the commit CAS and the
        driver's publish fence compare within that order (cross-executor
        overwrites always apply — recovery depends on last-writer-wins
        across executors)."""
        with self._attempt_lock:
            a = self._next_attempt
            self._next_attempt += 1
            return a

    def _bump_attempts(self, floor: int) -> None:
        """Never hand out an attempt/fence at or below ``floor``."""
        with self._attempt_lock:
            self._next_attempt = max(self._next_attempt, floor + 1)

    def data_tmp_path(self, shuffle_id: int, map_id: int,
                      fence: Optional[int] = None) -> str:
        # attempt-unique: concurrent speculative attempts of one map task
        # must not interleave writes in a shared tmp file. The streaming
        # writer derives its spill-file names from this path
        # (``<tmp>.s<seq>.tmp``) — everything an uncommitted attempt puts
        # on disk ends in ``.tmp``, so recover() and remove_shuffle() can
        # reap orphans without knowing the writer's internals.
        attempt = (fence if fence is not None
                   else self.begin_attempt(shuffle_id, map_id))
        return os.path.join(self.spill_dir,
                            f"shuffle_{shuffle_id}_{map_id}.{attempt}.tmp")

    # -- spill-dir health (consulted by writers) -------------------------

    def spill_dir_candidates(self) -> List[str]:
        """Healthy spill directories in preference order (primary first).
        Empty only when EVERY directory is quarantined — the writer then
        fails its attempt cleanly instead of spinning."""
        with self._dir_lock:
            return [d for d in [self.spill_dir] + self.fallback_spill_dirs
                    if d not in self._dir_quarantined]

    def record_spill_dir_failure(self, d: str) -> bool:
        """Count one failure against ``d``; returns True when this crossed
        ``spill_dir_max_failures`` and quarantined it."""
        with self._dir_lock:
            n = self._dir_failures.get(d, 0) + 1
            self._dir_failures[d] = n
            if (n >= self.conf.spill_dir_max_failures
                    and d not in self._dir_quarantined):
                self._dir_quarantined.add(d)
                log.warning("spill dir %s quarantined after %d consecutive "
                            "failures", d, n)
                return True
        return False

    def record_spill_dir_success(self, d: str) -> None:
        with self._dir_lock:
            self._dir_failures.pop(d, None)

    def spill_dir_health(self) -> dict:
        with self._dir_lock:
            return {"failures": dict(self._dir_failures),
                    "quarantined": sorted(self._dir_quarantined)}

    # -- commit ----------------------------------------------------------

    def committed_fence(self, shuffle_id: int, map_id: int) -> int:
        with self._commit_lock:
            return self._map_fences.get((shuffle_id, map_id), 0)

    def commit(self, shuffle_id: int, map_id: int, tmp_path: str,
               partition_lengths: Iterable[int],
               fence: Optional[int] = None,
               partition_crcs: Optional[List[int]] = None
               ) -> Tuple[SpillFile, int]:
        """Rename-commit + map for serving. Returns (spill, file_token).

        ``fence`` arms the commit CAS: a stale attempt (an OLDER fence
        than the committed one for this map) raises
        :class:`StaleAttemptError` with its tmp reaped — it can neither
        clobber the winner's data file nor reach publication. ``None``
        skips the CAS (fence-less callers, kept for compatibility).

        Durable ordering, including RE-commits of the same map: drop the
        old index (and sidecar), rename the data, write the sidecar, then
        atomically publish the new index. Every crash window leaves data
        WITHOUT an index, which recover() treats as lost (recompute) —
        never a mismatched set.
        """
        final = os.path.join(self.spill_dir,
                             f"shuffle_{shuffle_id}_{map_id}.data")
        lengths_arr = np.asarray(list(partition_lengths), dtype=np.uint64)
        if self.at_rest_checksum and partition_crcs is None:
            # callers that didn't stream CRCs during their writes (the
            # monolithic baseline) pay one read of the tmp here
            partition_crcs = integrity.partition_crcs_of_file(
                tmp_path, lengths_arr.tolist())
        index = final + ".index"
        sidecar = integrity.sidecar_path(final)
        # tenancy: the commit's disk bytes charge the owning tenant
        # BEFORE anything durable happens — past the spill quota the
        # attempt fails cleanly (tmp reaped, TenantQuotaError; NOT a
        # transient disk error, so no retry envelope burns on it)
        total_bytes = int(lengths_arr.sum())
        tenant = self.tenant_of(shuffle_id)
        try:
            # analysis: leak-ok(ownership transfers to _token_disk on success; _release_disk repays at unregister)
            self.disk_ledger.charge(tenant, total_bytes)
        except Exception:
            self._reap_quietly(tmp_path)
            raise
        with self._commit_lock:
            if fence is not None:
                committed = self._map_fences.get((shuffle_id, map_id), 0)
                if fence <= committed:
                    self.fenced_commits += 1
                    self._reap_quietly(tmp_path)
                    self.disk_ledger.release(tenant, total_bytes)
                    raise StaleAttemptError(shuffle_id, map_id, fence,
                                            committed)
            fault_mod.storage_check("commit", final)
            if os.path.exists(index):
                os.unlink(index)
            if os.path.exists(sidecar):
                os.unlink(sidecar)
            os.replace(tmp_path, final)
            try:
                if self.at_rest_checksum:
                    fault_mod.storage_check("index_write", sidecar)
                    integrity.write_sidecar(final, fence or 0,
                                            partition_crcs,
                                            lengths_arr.tolist())
                fault_mod.storage_check("index_write", index)
                lengths_arr.tofile(index + ".tmp")
                os.replace(index + ".tmp", index)
            except BaseException:
                # UN-commit: the rename already consumed the tmp, so a
                # failed sidecar/index write would otherwise orphan a
                # full-size index-less .data no sweep ever reaps (the
                # writer's cleanup only knows .tmp names). Either the
                # commit returns registered, or this attempt leaves
                # nothing on disk.
                for p in (final, sidecar, sidecar + ".tmp",
                          index, index + ".tmp"):
                    self._reap_quietly(p)
                self.disk_ledger.release(tenant, total_bytes)
                raise
            if fence is not None:
                self._map_fences[(shuffle_id, map_id)] = fence
        token = next(self._tokens)
        crc_ranges = (integrity.partition_crc_ranges(lengths_arr.tolist(),
                                                     partition_crcs)
                      if self.at_rest_checksum and partition_crcs else None)
        try:
            fault_mod.storage_check("mmap_open", final)
            spill = SpillFile(final, lengths_arr.tolist(), file_token=token)
            if self.block_server is not None:
                self.block_server.register_file(token, final,
                                                crc_ranges=crc_ranges,
                                                tenant=tenant)
        except BaseException:
            # same invariant past the durable writes: a commit that can't
            # be mapped/served is no commit — a durable triplet that never
            # registers would leak (remove_shuffle only reaps registered
            # spills), and the re-execution replaces it anyway
            for p in (final, sidecar, index):
                self._reap_quietly(p)
            with self._commit_lock:
                recorded = self._map_fences.get((shuffle_id, map_id))
                # analysis: epoch-eq-ok(identity check, not ordering: un-commit only the fence THIS attempt recorded)
                if fence is not None and recorded == fence:
                    del self._map_fences[(shuffle_id, map_id)]
            self.disk_ledger.release(tenant, total_bytes)
            raise
        with self._lock:
            # speculative/retried map task: replace and dispose the old
            # mapping (its file was already clobbered by the rename)
            old = self._shuffles.setdefault(shuffle_id, {}).get(map_id)
            self._shuffles[shuffle_id][map_id] = spill
            self._by_token[token] = spill
            self._token_disk[token] = (tenant, total_bytes)
            if crc_ranges:
                self._crc_ranges[token] = crc_ranges
            self._integrity[token] = _SpillIntegrity(
                partition_crcs if self.at_rest_checksum else None,
                len(lengths_arr),
                # just written and attested by the commit itself; serve
                # spot-checks re-verify only what could have rotted since
                full_verified=not self.at_rest_checksum)
            if old is not None:
                self._by_token.pop(old.file_token, None)
                self._integrity.pop(old.file_token, None)
                self._crc_ranges.pop(old.file_token, None)
        if old is not None:
            if self.block_server is not None:
                self.block_server.unregister_file(old.file_token)
            old._delete = False  # the path now belongs to the new spill
            old.dispose()
            self._release_disk(old.file_token)
        # at-rest corruption chaos hook: bit-rot of the COMMITTED bytes,
        # after the (clean) sidecar landed — exactly what verification
        # exists to catch
        fault_mod.storage_corrupt("commit", final)
        return spill, token

    def _reap_quietly(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- at-rest verification --------------------------------------------

    def _integrity_of(self, spill: SpillFile) -> Optional[_SpillIntegrity]:
        with self._lock:
            return self._integrity.get(spill.file_token)

    def _quarantine(self, spill: SpillFile, integ: _SpillIntegrity,
                    detail: str) -> None:
        """Demote a corrupt committed output: the native server stops
        serving its raw bytes, every later serve answers CORRUPT fast,
        and only a re-execution (re-commit) replaces it."""
        integ.corrupt = True
        self.corrupt_outputs += 1
        log.error("at-rest corruption in %s: %s (quarantined; the map "
                  "will be re-executed)", spill.path, detail)
        with self._lock:
            # its committed CRCs attest bytes the file no longer holds —
            # no serve may reuse them for a trailer again
            self._crc_ranges.pop(spill.file_token, None)
        if self.block_server is not None:
            # pin-safe: the native server withdraws the token immediately
            # but defers the munmap until in-flight serve pins drain, so
            # quarantining never unmaps under a concurrent vectored read
            self.block_server.unregister_file(spill.file_token)

    def _verify_file(self, spill: SpillFile, integ: _SpillIntegrity) -> None:
        """Whole-file CRC check (one streamed read), once."""
        with integ.lock:
            if integ.corrupt:
                raise CorruptOutputError(spill.path, "previously quarantined")
            if integ.full_verified or integ.part_crcs is None:
                return
            expected = integrity.combine_parts(
                integ.part_crcs, spill.partition_lengths.tolist())
            actual = integrity.file_crc32(spill.path)
            if actual != expected:
                self._quarantine(spill, integ,
                                 f"file CRC {actual:#x} != committed "
                                 f"{expected:#x}")
                raise CorruptOutputError(
                    spill.path, "whole-file CRC mismatch at serve time")
            integ.full_verified = True
            for p in range(len(integ.part_verified)):
                integ.part_verified[p] = 1

    def _spot_check_range(self, spill: SpillFile, integ: _SpillIntegrity,
                          offset: int, length: int) -> None:
        """Verify (once) each partition a served byte range touches.
        Serving reads the partition's bytes anyway; the first serve pays
        one CRC pass over the partitions it covers."""
        if integ.part_crcs is None:
            return
        with integ.lock:
            if integ.corrupt:
                raise CorruptOutputError(spill.path, "previously quarantined")
            if integ.full_verified or length == 0:
                return
            offs = spill.partition_offsets
            lens = spill.partition_lengths
            first = int(np.searchsorted(offs, offset, side="right")) - 1
            first = max(0, first)
            end = offset + length
            import zlib
            for p in range(first, len(offs)):
                if int(offs[p]) >= end:
                    break
                if integ.part_verified[p] or int(lens[p]) == 0:
                    continue
                buf = np.empty(int(lens[p]), dtype=np.uint8)
                spill.gather([int(offs[p])], [int(lens[p])], buf)
                if zlib.crc32(memoryview(buf)) != integ.part_crcs[p]:
                    self._quarantine(
                        spill, integ,
                        f"partition {p} CRC mismatch on first serve")
                    raise CorruptOutputError(
                        spill.path, f"partition {p} failed its at-rest "
                        f"CRC spot check")
                integ.part_verified[p] = 1

    # -- ShuffleDataSource (served to remote peers) ----------------------

    def get_output_table(self, shuffle_id: int, map_id: int) -> Optional[MapTaskOutput]:
        with self._lock:
            spill = self._shuffles.get(shuffle_id, {}).get(map_id)
        if spill is None:
            return None
        integ = self._integrity_of(spill)
        if integ is not None:
            if integ.corrupt:
                raise CorruptOutputError(spill.path,
                                         "previously quarantined")
            if self.block_server is not None and not integ.full_verified:
                # the native server serves the data bytes with no CPU in
                # the loop: this location serve is the ONLY Python
                # touchpoint on that dataplane, so the whole-file check
                # happens here (first serve of each output)
                self._verify_file(spill, integ)
        return spill.map_output

    def read_block(self, shuffle_id: int, buf_token: int, offset: int,
                   length: int) -> Optional[bytes]:
        with self._lock:
            spill = self._by_token.get(buf_token)
        if spill is None or offset + length > spill.size or offset < 0:
            return None
        fault_mod.storage_check("serve_read", spill.path)
        integ = self._integrity_of(spill)
        if integ is not None:
            self._spot_check_range(spill, integ, offset, length)
        if length == 0:
            return b""
        out = np.empty(length, dtype=np.uint8)
        spill.gather([offset], [length], out)
        return out.tobytes()

    def block_crc(self, shuffle_id: int, buf_token: int, offset: int,
                  length: int) -> Optional[int]:
        """The attested CRC32 of one served block when committed ranges
        (sidecar partitions / ledger rows) tile ``[offset, offset +
        length)`` exactly; None = not covered, the server recomputes.
        The Python serve loop's half of the CRC-reuse contract the
        native server implements in C (parity-tested both paths)."""
        with self._lock:
            ranges = self._crc_ranges.get(buf_token)
        if not ranges:
            return None
        return integrity.ranges_crc(ranges, offset, length)

    # -- local reads (short-circuit path) --------------------------------

    def local_blocks(self, shuffle_id: int, map_id: int,
                     start_partition: int, end_partition: int) -> Optional[bytes]:
        """Concatenated local partitions [start, end) of one map output
        (scala/RdmaShuffleFetcherIterator.scala:327-337 short-circuit)."""
        with self._lock:
            spill = self._shuffles.get(shuffle_id, {}).get(map_id)
        if spill is None:
            return None
        fault_mod.storage_check("serve_read", spill.path)
        offs = spill.partition_offsets[start_partition:end_partition]
        lens = spill.partition_lengths[start_partition:end_partition]
        integ = self._integrity_of(spill)
        if integ is not None and len(offs):
            self._spot_check_range(spill, integ, int(offs[0]),
                                   int(lens.sum()))
        out = np.empty(int(lens.sum()), dtype=np.uint8)
        spill.gather(offs, lens, out)
        return out.tobytes()

    def map_ids(self, shuffle_id: int):
        with self._lock:
            return sorted(self._shuffles.get(shuffle_id, {}).keys())

    def local_shuffles(self):
        """Shuffle ids with committed outputs on this resolver (the
        graceful-drain replication pass enumerates from here)."""
        with self._lock:
            return sorted(self._shuffles)

    def committed_outputs(self, shuffle_id: int) -> Dict[int, list]:
        """``map_id -> per-partition byte lengths`` for every committed
        output of the shuffle — exactly the vector a push-merge
        ``SegmentPusher.submit`` needs, so a draining executor can
        re-push everything it owns without re-reading index files."""
        with self._lock:
            return {m: [int(x) for x in s.partition_lengths]
                    for m, s in self._shuffles.get(shuffle_id, {}).items()}

    def local_output_bytes(self, shuffle_id: int) -> Dict[int, int]:
        """``map_id -> committed data bytes`` this resolver holds for the
        shuffle (per-partition length sums from the in-memory index, no
        file I/O) — the device-plane cost model's stage-size input.
        Per-map so callers can dedupe the copies speculation/retry leave
        on two executors."""
        with self._lock:
            return {m: int(s.partition_lengths.sum())
                    for m, s in self._shuffles.get(shuffle_id, {}).items()}

    # -- externally-owned served files (push-merge) ----------------------

    def register_external(self, shuffle_id: int, path: str,
                          length: int, crc_ranges=None) -> int:
        """Make one externally-owned file (a finalized merged segment or
        an overflow blob, shuffle/push_merge.py) token-addressable on
        BOTH serving dataplanes — the Python ``read_block`` path and the
        native block server — without entering the map-output tables.
        ``crc_ranges`` — optional attested ``(offset, length, crc32)``
        ranges (the merge ledger's surviving rows) — feeds the same
        serve-time CRC reuse committed outputs get from their sidecar.
        The caller owns the file's content; :meth:`release_externals`
        (or ``remove_shuffle``) unregisters and deletes it."""
        token = next(self._tokens)
        spill = SpillFile(path, [length], file_token=token)
        if self.block_server is not None:
            self.block_server.register_file(token, path,
                                            crc_ranges=crc_ranges,
                                            tenant=self.tenant_of(shuffle_id))
        with self._lock:
            self._by_token[token] = spill
            if crc_ranges:
                self._crc_ranges[token] = sorted(
                    (int(o), int(ln), int(c) & 0xFFFFFFFF)
                    for o, ln, c in crc_ranges if int(ln) > 0)
            self._external.setdefault(shuffle_id, []).append(spill)
        return token

    def release_externals(self, shuffle_id: int) -> None:
        with self._lock:
            spills = self._external.pop(shuffle_id, [])
            for spill in spills:
                self._by_token.pop(spill.file_token, None)
                self._crc_ranges.pop(spill.file_token, None)
        for spill in spills:
            if self.block_server is not None:
                self.block_server.unregister_file(spill.file_token)
            spill.dispose()

    # -- lifecycle -------------------------------------------------------

    def _sweep_tmps(self, shuffle_prefix: Optional[str] = None) -> None:
        """Delete orphan ``.tmp`` attempt files (writer data tmps and
        ``.s<seq>.tmp`` spill files) in the primary AND every fallback
        spill dir, optionally scoped to one shuffle's prefix."""
        for d in [self.spill_dir] + self.fallback_spill_dirs:
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if not name.endswith(".tmp"):
                    continue
                if shuffle_prefix is not None \
                        and not name.startswith(shuffle_prefix):
                    continue
                self._reap_quietly(os.path.join(d, name))

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            spills = self._shuffles.pop(shuffle_id, {})
            for spill in spills.values():
                self._by_token.pop(spill.file_token, None)
                self._integrity.pop(spill.file_token, None)
                self._crc_ranges.pop(spill.file_token, None)
        for spill in spills.values():
            if self.block_server is not None:
                self.block_server.unregister_file(spill.file_token)
            index = spill.path + ".index"
            sidecar = integrity.sidecar_path(spill.path)
            spill.dispose()
            self._release_disk(spill.file_token)
            if os.path.exists(index):
                os.unlink(index)
            if os.path.exists(sidecar):
                os.unlink(sidecar)
        # reap this shuffle's uncommitted attempts (writer tmp + spill
        # files from crashed/aborted tasks) — in every spill dir
        self._sweep_tmps(f"shuffle_{shuffle_id}_")
        # externally-owned served files (merged segments, overflow
        # blobs) die with the shuffle too
        self.release_externals(shuffle_id)
        with self._lock:
            self._tenant_map.pop(shuffle_id, None)

    def reap_orphans(self, live_shuffle_ids, min_age_s: float = 60.0
                     ) -> int:
        """Driver-driven GC sweep: delete committed triplets
        (``shuffle_<id>_<map>.data`` + index + sidecar) whose shuffle is
        neither in ``live_shuffle_ids`` (the driver's registered set)
        nor registered in THIS resolver — the files a dead or wedged
        process left behind that no unregister push will ever name.
        ``min_age_s`` guards the snapshot race: a shuffle registering
        (and a commit renaming its tmp durable) AFTER the caller took
        the live set would otherwise look orphaned for a moment — only
        files older than the guard are eligible. Returns the number of
        data files reaped."""
        import re
        live = set(int(s) for s in live_shuffle_ids)
        with self._lock:
            local = set(self._shuffles)
        pat = re.compile(r"^shuffle_(\d+)_\d+\.data$")
        cutoff = time.time() - min_age_s
        reaped = 0
        for d in [self.spill_dir] + self.fallback_spill_dirs:
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                m = pat.match(name)
                if m is None:
                    continue
                sid = int(m.group(1))
                if sid in live or sid in local:
                    continue
                path = os.path.join(d, name)
                try:
                    if os.stat(path).st_mtime > cutoff:
                        continue  # too fresh: may be a racing commit
                except OSError:
                    continue
                self._reap_quietly(path)
                self._reap_quietly(path + ".index")
                self._reap_quietly(integrity.sidecar_path(path))
                reaped += 1
        return reaped

    def recover(self) -> Dict[int, list]:
        """Rebuild state from committed (data, index) pairs on disk.

        Returns {shuffle_id: [(map_id, file_token), ...]} of recovered
        outputs so the caller can re-publish them (elastic rejoin: the
        restarted executor gets a fresh slot, re-publishes, and reducers
        route to it); the fence each output committed with is readable
        via :meth:`committed_fence`. Orphaned ``.tmp`` spill attempts
        from the crashed process are deleted — fallback spill dirs
        included — and, with ``at_rest_checksum`` on, every recovered
        file is verified against its CRC sidecar on mmap-open: corrupt
        (or sidecar-less, hence unattested) files are treated as lost so
        the map recomputes instead of serving rot."""
        import re as _re
        recovered: Dict[int, list] = {}
        self._sweep_tmps()
        for name in sorted(os.listdir(self.spill_dir)):
            m = _re.fullmatch(r"shuffle_(\d+)_(\d+)\.data", name)
            if not m:
                continue
            data_path = os.path.join(self.spill_dir, name)
            index_path = data_path + ".index"
            if not os.path.exists(index_path):
                continue  # never fully committed
            shuffle_id, map_id = int(m.group(1)), int(m.group(2))
            lengths = np.fromfile(index_path, dtype=np.uint64)
            if len(lengths) == 0:
                continue
            fence = 0
            part_crcs: Optional[List[int]] = None
            if self.at_rest_checksum:
                sidecar = integrity.read_sidecar(data_path)
                if sidecar is None:
                    # committed without attestation (checksum was off, or
                    # a pre-sidecar build): a restart cannot tell rot
                    # from truth — recompute rather than serve blind, and
                    # REAP the pair (it will never be registered, so no
                    # later sweep would; leaving it leaks a full-size
                    # file and re-logs this on every restart)
                    log.warning("recover: %s has no CRC sidecar; treating "
                                "as lost", name)
                    for p in (data_path, index_path):
                        self._reap_quietly(p)
                    continue
                fence, part_crcs, file_crc = sidecar
                try:
                    fault_mod.storage_check("mmap_open", data_path)
                    actual = integrity.file_crc32(data_path)
                except OSError as e:
                    log.warning("recover: %s unreadable (%s); treating as "
                                "lost", name, e)
                    continue
                if actual != file_crc:
                    self.corrupt_outputs += 1
                    log.error("recover: %s failed its at-rest CRC "
                              "(%#x != committed %#x); dropping so the "
                              "map recomputes", name, actual, file_crc)
                    for p in (data_path, index_path,
                              integrity.sidecar_path(data_path)):
                        self._reap_quietly(p)
                    self._bump_attempts(fence)
                    continue
            try:
                token = next(self._tokens)
                fault_mod.storage_check("mmap_open", data_path)
                spill = SpillFile(data_path, lengths.tolist(),
                                  file_token=token)
            except (ValueError, OSError):
                continue  # truncated data file: treat as lost
            crc_ranges = (integrity.partition_crc_ranges(lengths.tolist(),
                                                         part_crcs)
                          if part_crcs else None)
            if self.block_server is not None:
                try:
                    self.block_server.register_file(token, data_path,
                                                    crc_ranges=crc_ranges)
                except OSError as e:
                    # one unmappable file must cost ONE output (treated
                    # as lost → recompute), not abort recovery of every
                    # other committed output
                    log.warning("recover: %s unservable by the native "
                                "block server (%s); treating as lost",
                                name, e)
                    spill._delete = False
                    spill.dispose()
                    continue
            with self._lock:
                self._shuffles.setdefault(shuffle_id, {})[map_id] = spill
                self._by_token[token] = spill
                if crc_ranges:
                    self._crc_ranges[token] = crc_ranges
                # the mmap-open verify above attested the file for
                # REGISTRATION, but must not exempt it from serve-time
                # spot checks: rot landing between recover and first
                # serve would otherwise be served silently (the fetch
                # CRC trailer is computed over the rotted bytes) — so
                # first serves re-verify, exactly like a fresh commit
                self._integrity[token] = _SpillIntegrity(
                    part_crcs, len(lengths),
                    full_verified=not self.at_rest_checksum)
            with self._commit_lock:
                prev = self._map_fences.get((shuffle_id, map_id), 0)
                self._map_fences[(shuffle_id, map_id)] = max(prev, fence)
            # the allocator restarted at 1 with this process: new attempts
            # of a recovered map must out-fence its pre-crash commit, or
            # every re-execution (corrupt-output healing included) would
            # lose the CAS to a dead process forever
            self._bump_attempts(fence)
            recovered.setdefault(shuffle_id, []).append((map_id, token))
        # orphan sidecars (data reaped or never committed) confuse nothing
        # but waste space; sweep them (sidecars live only in the primary
        # dir — they are written next to the committed data file)
        try:
            names = os.listdir(self.spill_dir)
        except OSError:
            names = []
        for name in names:
            if name.endswith(".data.crc") and not os.path.exists(
                    os.path.join(self.spill_dir, name[:-len(".crc")])):
                self._reap_quietly(os.path.join(self.spill_dir, name))
        return recovered

    def stop(self) -> None:
        with self._lock:
            shuffle_ids = set(self._shuffles) | set(self._external)
        for sid in sorted(shuffle_ids):
            self.remove_shuffle(sid)
