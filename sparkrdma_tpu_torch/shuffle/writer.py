"""Shuffle writer: streaming partition-scatter, bounded-memory spill, commit.

Re-design of ``writer/wrapper/RdmaWrapperShuffleWriter.scala``. The reference
deliberately reuses the engine's own sort/spill machinery and only intercepts
the commit (:83-99 wrap, :54-71 commit hook); the standalone TPU framework
owns that machinery, so it must be fast. The write path is a streaming
dataplane:

* ``write_batch`` partitions each record batch **on arrival** with an O(n)
  counting-sort scatter (native kernel in ``csrc/writer.cpp`` when built,
  numpy fallback with the identical run layout) into partition-contiguous
  *run* buffers leased from the :class:`~sparkrdma_tpu_torch.runtime.pool.BufferPool`
  — the registered-memory role the reference's pinned MRs play;
* accumulated runs past ``spill_threshold_bytes`` spill to a per-map spill
  file on a background spill thread, overlapping disk I/O with the map
  task's next batches; ``write_batch`` backpressures once
  ``write_spill_threads`` spills are in flight, so write-path memory is
  bounded (peak accumulation <= threshold + one batch, asserted by the
  write microbench);
* ``close`` is a cheap sequential **merge** of partition-contiguous runs
  (kernel-side ``sendfile`` from spill files, direct writes from registered
  run memory — no close-time global sort, no monolithic rows copy),
  rename-committed through the resolver (RdmaWrapperShuffleWriter.scala:
  58-63) and handed to the native block server for mmap serving at commit.

Record model: a batch is ``(keys: u64[N], payload: u8[N, W])`` with W fixed
per shuffle. Arbitrary-width records are layered on top by serializing into
fixed rows (models/ do exactly that). The on-disk row format is
``key(8B LE) | payload(W B)``, partition-contiguous — byte-identical to the
pre-streaming monolithic writer (kept below as
:class:`MonolithicShuffleWriter`, the parity/bench baseline).

Map-side combine: the registered ``combiner(keys_sorted, payload_sorted) ->
(keys', payload')`` collapses duplicate keys before bytes hit disk/the wire.
Same key -> same partition, so combining per partition is exact; rows are
sorted *per partition run* (reusing the scatter's grouping) instead of the
old global argsort. When spilling, the combiner runs once per spill and once
more at merge — exact for associative combiners (Spark's ``mergeCombiners``
contract; ``make_sum_combiner`` qualifies), and exactly equal to the
monolithic path's single global combine.
"""

from __future__ import annotations

import ctypes
import errno
import logging
import os
import queue
import threading
import time
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel import faults as fault_mod
from sparkrdma_tpu_torch.parallel.transport import Backoff
from sparkrdma_tpu_torch.runtime import native
from sparkrdma_tpu_torch.shuffle.resolver import (
    StaleAttemptError,
    TpuShuffleBlockResolver,
)
from sparkrdma_tpu_torch.utils import integrity
from sparkrdma_tpu_torch.utils.stats import WriteMetrics
from sparkrdma_tpu_torch.utils import trace as trace_mod

log = logging.getLogger(__name__)

Partitioner = Callable[[np.ndarray], np.ndarray]  # keys -> dest partition ids


class WriteFailedError(RuntimeError):
    """This map attempt could not write its output (disk errors past the
    spill retry budget, a failed merge/commit, a dead spill worker). The
    attempt is CLEANLY failed — every tmp and spill file reaped — so the
    map stage can re-place the task on another executor
    (``shuffle/recovery.py run_map_stage``), mirroring how a lost peer's
    maps recompute."""


# Disk errors a spill retry (possibly into a fallback dir) can heal;
# everything else (EACCES, EROFS, ENOENT on the dir, ...) re-fails
# identically and fails the attempt immediately.
_TRANSIENT_DISK_ERRNOS = frozenset(
    e for e in (errno.EIO, errno.ENOSPC, errno.EAGAIN, errno.EINTR,
                errno.ENOBUFS, getattr(errno, "EDQUOT", None))
    if e is not None)


def _transient_disk_error(e: BaseException) -> bool:
    return isinstance(e, OSError) and e.errno in _TRANSIENT_DISK_ERRNOS


def _rows_keys(rows: np.ndarray) -> np.ndarray:
    """u64 key column of a ``(n, row_bytes)`` u8 row matrix, zero-copy.

    numpy >= 1.23 allows the dtype view when the last axis is contiguous
    (the key slice's is); older numpy needs the copy."""
    try:
        return rows[:, :8].view(np.uint64)[:, 0]
    except ValueError:
        return rows[:, :8].copy().view(np.uint64).reshape(-1)


class _Run:
    """One partition-scattered record batch in (pool) memory."""

    __slots__ = ("buf", "view", "nbytes", "counts", "byte_offsets")

    def __init__(self, buf, view: np.ndarray, nbytes: int,
                 counts: np.ndarray, row_bytes: int):
        self.buf = buf  # PoolBuffer lease, or None for plain numpy backing
        self.view = view  # u8[nbytes], partition-contiguous rows
        self.nbytes = nbytes
        self.counts = counts  # rows per partition, i64[P]
        offs = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts * row_bytes, out=offs[1:])
        self.byte_offsets = offs  # exclusive, i64[P+1]

    def segment(self, p: int) -> np.ndarray:
        return self.view[self.byte_offsets[p]:self.byte_offsets[p + 1]]

    def free(self) -> None:
        if self.buf is not None:
            self.buf.free()
            self.buf = None
        self.view = None


class _Spill:
    """One completed spill file: partition-contiguous, lengths recorded.
    ``part_crcs`` (when at-rest checksums are on) carries each
    partition segment's CRC32, computed while the bytes streamed to
    disk, so the merge can CRC sendfile'd segments without reading them
    back (``integrity.crc32_combine``)."""

    __slots__ = ("path", "part_lengths", "part_offsets", "part_crcs")

    def __init__(self, path: str, part_lengths: np.ndarray,
                 part_crcs: Optional[List[int]] = None):
        self.path = path
        self.part_lengths = part_lengths  # bytes per partition, i64[P]
        self.part_crcs = part_crcs
        offs = np.zeros(len(part_lengths), dtype=np.int64)
        if len(part_lengths) > 1:
            np.cumsum(part_lengths[:-1], out=offs[1:])
        self.part_offsets = offs


class _RemoteSpill:
    """A spill parked on a merge peer (push-merge's tiered-spill
    overflow: every local spill directory was exhausted, so the rendered
    partition-contiguous bytes went to a peer's merge store instead of
    failing the attempt). Same read surface as :class:`_Spill`, served
    from memory after :meth:`materialize` fetches the blob back over the
    ordinary block dataplane at merge time — by which point local disk
    only needs room for the final data file, not the spills."""

    __slots__ = ("handle", "part_lengths", "part_offsets", "part_crcs",
                 "blob_crc", "_data")

    def __init__(self, handle, part_lengths: np.ndarray,
                 blob_crc: int, part_crcs: Optional[List[int]] = None):
        self.handle = handle  # push_merge.RemoteSpillHandle
        self.part_lengths = part_lengths
        self.part_crcs = part_crcs
        self.blob_crc = blob_crc  # render-time CRC32 of the whole blob
        offs = np.zeros(len(part_lengths), dtype=np.int64)
        if len(part_lengths) > 1:
            np.cumsum(part_lengths[:-1], out=offs[1:])
        self.part_offsets = offs
        self._data: Optional[np.ndarray] = None

    def materialize(self) -> None:
        if self._data is not None:
            return
        data = self.handle.fetch()
        # the wire trailer only proves TRANSPORT — at-rest rot on the
        # overflow peer must be caught against the render-time CRC, or
        # the merge would commit (and re-attest) corrupt bytes silently
        if zlib.crc32(data) != self.blob_crc:
            raise WriteFailedError(
                "overflow spill fetched back corrupt (peer-side rot); "
                "failing the attempt so the map re-places")
        self._data = np.frombuffer(data, dtype=np.uint8)

    def segment(self, p: int) -> np.ndarray:
        off = int(self.part_offsets[p])
        return self._data[off:off + int(self.part_lengths[p])]


def _write_all(fd: int, view: np.ndarray) -> None:
    """write() until done — one os.write caps at ~2 GiB on Linux and may
    return short, and a partition segment can exceed that."""
    mv = memoryview(view)
    while len(mv):
        mv = mv[os.write(fd, mv):]


def _copy_from_file(out_fd: int, in_fd: int, offset: int, count: int) -> None:
    """Kernel-side copy of one spill segment into the committed file
    (``sendfile`` keeps the CPU out of the data path — "RPC Considered
    Harmful"'s point applied to disk); pread/write fallback where sendfile
    is unavailable (non-Linux, sandboxed /proc)."""
    while count > 0:
        try:
            sent = os.sendfile(out_fd, in_fd, offset, count)
        except (AttributeError, OSError):
            data = os.pread(in_fd, count, offset)
            if not data:
                raise IOError("spill file truncated during merge")
            os.write(out_fd, data)
            sent = len(data)
        if sent == 0:
            raise IOError("spill file truncated during merge")
        offset += sent
        count -= sent


class TpuShuffleWriter:
    """One map task's writer (one instance per (shuffle, map))."""

    def __init__(self, resolver: TpuShuffleBlockResolver, shuffle_id: int,
                 map_id: int, num_partitions: int, partitioner: Partitioner,
                 row_payload_bytes: int,
                 combiner: Optional[Callable] = None,
                 conf: Optional[TpuShuffleConf] = None,
                 pool=None, tracer=None, overflow_spill=None):
        self.resolver = resolver
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.num_partitions = num_partitions
        self.partitioner = partitioner
        self.row_payload_bytes = row_payload_bytes
        # Map-side combine (the aggregator half of Spark's shuffle write,
        # which the reference inherits by wrapping Spark's writers —
        # writer/wrapper/RdmaWrapperShuffleWriter.scala:83-99). Applied per
        # partition run (and per spill; see module docstring for the
        # associativity contract under spilling).
        self.combiner = combiner
        self.conf = conf or TpuShuffleConf()
        self.pool = pool
        # tenancy: pool leases (and the commit's disk bytes, resolver-
        # side) charge the shuffle's owning tenant; the manager teaches
        # the resolver the mapping before building any writer
        self.tenant = resolver.tenant_of(shuffle_id) \
            if hasattr(resolver, "tenant_of") else 0
        self.metrics = WriteMetrics()
        self._tracer = tracer or trace_mod.NULL
        self._closed = False
        self.bytes_written = 0
        self.records_written = 0

        self.spill_threshold = int(self.conf.spill_threshold_bytes)
        self._max_inflight = int(self.conf.write_spill_threads)
        self._use_native = (bool(self.conf.native_write_scatter)
                            and bool(self.conf.use_cpp_runtime)
                            and native.has_writer_scatter())
        self.metrics.native_scatter = self._use_native
        self._scatter_threads = max(1, min(4, os.cpu_count() or 1))
        # fencing token: totally orders this executor's attempts of one
        # map; commit is a CAS on it (resolver), publish carries it so a
        # zombie speculative attempt can't clobber the winner's location
        self.fence = self.resolver.begin_attempt(shuffle_id, map_id)
        # at-rest integrity: CRCs stream with the writes (spill + merge)
        # so the commit-time sidecar costs no extra read of the data
        self._crc_enabled = bool(getattr(self.resolver, "at_rest_checksum",
                                         self.conf.at_rest_checksum))
        self._spill_backoff = Backoff.from_conf(self.conf)
        # push-merge tiered spill: ``overflow_spill(shuffle, map, fence,
        # bytes) -> RemoteSpillHandle | None`` parks a spill on a merge
        # peer when EVERY local directory is exhausted — the attempt
        # survives ENOSPC instead of failing (None = feature off)
        self._overflow_spill = overflow_spill

        self._runs: List[_Run] = []  # unspilled, arrival order
        self._buffered = 0  # bytes accumulated in self._runs
        self._cv = threading.Condition()
        self._inflight = 0  # spills queued/being written
        self._inflight_bytes = 0
        self._spills: dict = {}  # seq -> _Spill (merge iterates sorted)
        self._spill_seq = 0
        self._spill_error: Optional[BaseException] = None
        self._spill_queue: Optional[queue.Queue] = None
        self._spill_workers: List[threading.Thread] = []
        self._aborted = False
        # every spill path this attempt ever opened (retries may scatter
        # them across fallback dirs): the abort/cleanup sweep reaps them
        # all, so a failed attempt leaks nothing anywhere
        self._spill_paths: set = set()
        # one tmp namespace per writer: the final data tmp plus numbered
        # spill files derive from it (attempt-unique via the resolver, so
        # speculative attempts of one map never share spill files); the
        # ``.tmp`` suffix keeps crash orphans visible to resolver.recover()
        self._tmp_path: Optional[str] = None

    @property
    def row_bytes(self) -> int:
        return 8 + self.row_payload_bytes

    @property
    def closed(self) -> bool:
        return self._closed

    # -- streaming write side -------------------------------------------

    def _tmp_base(self) -> str:
        if self._tmp_path is None:
            self._tmp_path = self.resolver.data_tmp_path(
                self.shuffle_id, self.map_id, fence=self.fence)
        return self._tmp_path

    def _spill_path(self, seq: int, spill_dir: Optional[str] = None) -> str:
        name = f"{os.path.basename(self._tmp_base())}.s{seq}.tmp"
        d = spill_dir if spill_dir is not None \
            else os.path.dirname(self._tmp_base())
        return os.path.join(d, name)

    def _reap(self, path: str) -> None:
        """Best-effort unlink for cleanup paths — but COUNTED: a cleanup
        that itself fails (EACCES, EIO...) stays best-effort, yet chaos
        runs can assert nothing leaked silently
        (``WriteMetrics.cleanup_errors``)."""
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        except OSError as e:
            self.metrics.record_cleanup_error()
            self._tracer.instant("write.cleanup_error", "fault",
                                 shuffle=self.shuffle_id, map=self.map_id,
                                 error=type(e).__name__)
            log.warning("cleanup of %s failed (leak candidate): %s", path, e)

    def write_batch(self, keys: np.ndarray,
                    payload: Optional[np.ndarray] = None) -> None:
        if self._closed:
            raise RuntimeError("writer already closed")
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if payload is None:
            payload = np.zeros((len(keys), self.row_payload_bytes),
                               dtype=np.uint8)
        payload = np.ascontiguousarray(payload, dtype=np.uint8)
        if payload.shape != (len(keys), self.row_payload_bytes):
            raise ValueError(
                f"payload must be [{len(keys)}, {self.row_payload_bytes}]")
        if not len(keys):
            return
        dest = np.ascontiguousarray(self.partitioner(keys), dtype=np.int64)
        if len(dest) != len(keys):
            raise ValueError("partitioner returned wrong-length array")
        if dest.min() < 0 or dest.max() >= self.num_partitions:
            raise ValueError("partitioner returned out-of-range partition id")

        with self._cv:
            self._raise_spill_error_locked()

        t0 = time.perf_counter_ns()
        with self._tracer.span("write.scatter", "write",
                               shuffle=self.shuffle_id, map=self.map_id,
                               rows=len(keys)):
            run = self._scatter(keys, payload, dest)
        self.metrics.record_scatter(time.perf_counter_ns() - t0)
        self.records_written += len(keys)

        with self._cv:
            self._runs.append(run)
            self._buffered += run.nbytes
            self.metrics.record_buffered(self._buffered,
                                         self._buffered + self._inflight_bytes)
            if self._buffered > self.spill_threshold:
                # backpressure only when every spill slot is busy: scatters
                # keep overlapping one in-flight spill (double buffering),
                # and total write-path memory stays bounded by
                # (1 + write_spill_threads) x (threshold + one batch)
                if self._inflight >= self._max_inflight:
                    t0 = time.perf_counter_ns()
                    while self._inflight >= self._max_inflight \
                            and self._spill_error is None:
                        self._check_spill_health_locked()
                        if self._spill_error is not None:
                            break
                        self._cv.wait(timeout=0.05)
                    self.metrics.record_spill_wait(
                        time.perf_counter_ns() - t0)
                    self._raise_spill_error_locked()
                self._enqueue_spill_locked()

    def _scatter(self, keys: np.ndarray, payload: np.ndarray,
                 dest: np.ndarray) -> _Run:
        """O(n) stable counting-sort scatter of one batch into a
        partition-contiguous run (bincount -> cumsum offsets -> row
        scatter). Native kernel when built; the numpy fallback produces
        the identical layout (lockstep-tested)."""
        n = len(keys)
        nbytes = n * self.row_bytes
        if self.pool is not None:
            buf = self.pool.get(nbytes, tenant=self.tenant)
            view = buf.view[:nbytes]
        else:
            buf, view = None, np.empty(nbytes, dtype=np.uint8)
        if self._use_native:
            counts = np.zeros(self.num_partitions, dtype=np.uint64)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            rc = native.LIB.writer_scatter(
                keys.ctypes.data_as(u64p),
                payload.ctypes.data_as(ctypes.c_char_p),
                n, self.row_payload_bytes,
                dest.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.num_partitions,
                view.ctypes.data_as(ctypes.c_char_p),
                counts.ctypes.data_as(u64p), self._scatter_threads)
            if rc < 0:  # dest already validated; defensive
                raise ValueError("native scatter rejected partition ids")
            counts = counts.astype(np.int64)
        else:
            # numpy's stable argsort on small ints is its radix path; the
            # fancy-index gather writes rows straight into the (pool) run
            counts = np.bincount(dest, minlength=self.num_partitions
                                 ).astype(np.int64)
            order = np.argsort(dest, kind="stable")
            rows = view.reshape(n, self.row_bytes)
            rows[:, :8] = keys[order, None].view(np.uint8)
            rows[:, 8:] = payload[order]
        return _Run(buf, view, nbytes, counts, self.row_bytes)

    # -- spill side ------------------------------------------------------

    def _raise_spill_error_locked(self) -> None:
        if self._spill_error is not None:
            raise WriteFailedError("background spill failed") \
                from self._spill_error

    def _check_spill_health_locked(self) -> None:
        """A spill worker that DIED (killed thread, not an exception its
        handler saw) leaves ``_inflight`` stuck high forever; every wait
        on the condition — backpressure, drain, abort — must notice and
        raise instead of hanging the map task."""
        if (self._spill_error is None and self._inflight > 0
                and self._spill_workers
                and not any(t.is_alive() for t in self._spill_workers)):
            self._spill_error = WriteFailedError(
                f"{self._inflight} spill(s) in flight but every spill "
                f"worker is dead")
            self._cv.notify_all()

    def _ensure_spill_workers_locked(self) -> None:
        if self._spill_queue is None:
            self._spill_queue = queue.Queue()
        while len(self._spill_workers) < self._max_inflight:
            t = threading.Thread(target=self._spill_worker, daemon=True,
                                 name=f"spill-{self.shuffle_id}-{self.map_id}")
            t.start()
            self._spill_workers.append(t)

    def _enqueue_spill_locked(self) -> None:
        """Hand the accumulated runs to the spill thread (caller holds
        the cv). File naming stays attempt-unique and deterministic per
        (attempt, seq); the DIRECTORY is chosen at write time from the
        resolver's healthy-candidate list so retries can fall back."""
        runs, self._runs = self._runs, []
        nbytes, self._buffered = self._buffered, 0
        seq = self._spill_seq
        self._spill_seq += 1
        self._inflight += 1
        self._inflight_bytes += nbytes
        self._ensure_spill_workers_locked()
        self._spill_queue.put((seq, runs, nbytes))

    def _spill_worker(self) -> None:
        while True:
            job = self._spill_queue.get()
            if job is None:
                return
            seq, runs, nbytes = job
            t0 = time.perf_counter_ns()
            try:
                if not self._aborted:
                    with self._tracer.span("write.spill", "write",
                                           shuffle=self.shuffle_id,
                                           map=self.map_id, seq=seq,
                                           bytes=nbytes):
                        spill = self._spill_with_retries(seq, runs, nbytes)
                else:
                    spill = None
            except BaseException as e:  # noqa: BLE001 — surfaced to the task
                with self._cv:
                    if self._spill_error is None:
                        self._spill_error = e
                    self._inflight -= 1
                    self._inflight_bytes -= nbytes
                    self._cv.notify_all()
                continue
            finally:
                for run in runs:
                    run.free()
            if spill is not None:
                self.metrics.record_spill(time.perf_counter_ns() - t0, nbytes)
            with self._cv:
                if spill is not None:
                    self._spills[seq] = spill
                self._inflight -= 1
                self._inflight_bytes -= nbytes
                self._cv.notify_all()

    def _spill_dir_candidates(self) -> List[str]:
        fn = getattr(self.resolver, "spill_dir_candidates", None)
        if fn is not None:
            return fn()
        return [os.path.dirname(self._tmp_base())]

    def _spill_with_retries(self, seq: int, runs: List[_Run],
                            nbytes: int) -> Optional[_Spill]:
        """One spill under the disk failure policy: TRANSIENT errors
        (ENOSPC, EIO, torn write, ...) retry with backoff up to
        ``spill_retry_budget``, rotating into the next healthy fallback
        dir (``spill_dirs``; a dir with ``spill_dir_max_failures``
        consecutive failures is quarantined executor-wide). ENOSPC also
        halves the writer's spill threshold so later spills are smaller.
        Fatal errors, an exhausted budget, or a fully-quarantined dir
        list fail the attempt cleanly as :class:`WriteFailedError`."""
        budget = max(0, int(self.conf.spill_retry_budget))
        attempt = 0
        failed_dirs: set = set()
        while True:
            if self._aborted:
                return None
            candidates = self._spill_dir_candidates()
            if not candidates:
                remote = self._try_overflow(seq, runs)
                if remote is not None:
                    return remote
                raise WriteFailedError(
                    f"spill {seq}: every spill directory is quarantined "
                    f"({self.resolver.spill_dir_health()})")
            # rotate through EVERY not-yet-failed candidate before
            # revisiting one (a healthy third dir must get its shot
            # inside the budget); once all have failed, start over
            if failed_dirs.issuperset(candidates):
                failed_dirs.clear()
            d = next((c for c in candidates if c not in failed_dirs),
                     candidates[0])
            path = self._spill_path(seq, d)
            with self._cv:
                self._spill_paths.add(path)
            try:
                return self._write_spill(runs, path)
            except OSError as e:
                self._reap(path)  # a partial spill must not survive
                record = getattr(self.resolver,
                                 "record_spill_dir_failure", None)
                if record is not None:
                    record(d)
                self.metrics.record_spill_dir_failure()
                failed_dirs.add(d)
                if e.errno == errno.ENOSPC and self.spill_threshold > 0:
                    # degrade: smaller spills both fit a nearly-full disk
                    # better and bound how much one retry re-writes
                    self.spill_threshold //= 2
                    self.metrics.record_spill_shrink()
                    self._tracer.instant(
                        "write.spill_shrink", "fault",
                        shuffle=self.shuffle_id, map=self.map_id,
                        threshold=self.spill_threshold)
                attempt += 1
                if not _transient_disk_error(e) or attempt > budget:
                    if _transient_disk_error(e):
                        # budget exhausted on HEALABLE errors (ENOSPC,
                        # EIO...): the tiered ladder's last rung is a
                        # merge peer's disk, not a failed attempt
                        remote = self._try_overflow(seq, runs)
                        if remote is not None:
                            return remote
                    raise WriteFailedError(
                        f"spill {seq} failed after {attempt} attempt(s) "
                        f"(last dir {d}): {e}") from e
                self.metrics.record_spill_retry()
                self._tracer.instant("write.spill_retry", "fault",
                                     shuffle=self.shuffle_id,
                                     map=self.map_id, seq=seq,
                                     attempt=attempt, dir=d,
                                     error=type(e).__name__)
                log.warning("spill %d of shuffle %d map %d failed in %s "
                            "(attempt %d/%d): %s — retrying",
                            seq, self.shuffle_id, self.map_id, d,
                            attempt, budget + 1, e)
                time.sleep(self._spill_backoff.delay(attempt - 1))

    def _spill_write(self, f, view, path: str) -> None:
        """One guarded spill write (torn-write injection point)."""
        cap = fault_mod.storage_write_cap("spill_write", path, len(view))
        if cap is not None:
            f.write(memoryview(view)[:cap])
            f.flush()
            raise OSError(errno.EIO,
                          f"fault injection: torn write ({cap}/{len(view)} "
                          f"bytes landed)", path)
        f.write(memoryview(view))

    def _emit_partitions(self, runs: List[_Run], write
                         ) -> Tuple[np.ndarray, Optional[List[int]]]:
        """Drive one spill's serialization — partition-contiguous over
        the runs, combiner applied per partition first — calling
        ``write(partition, view)`` per chunk. Shared by the on-disk
        spill and the in-memory render the ENOSPC overflow sends to a
        merge peer, so both are byte-identical by construction."""
        part_lengths = np.zeros(self.num_partitions, dtype=np.int64)
        part_crcs = [0] * self.num_partitions if self._crc_enabled else None
        for p in range(self.num_partitions):
            if self.combiner is None:
                for run in runs:
                    seg = run.segment(p)
                    if len(seg):
                        write(p, seg)
                        part_lengths[p] += len(seg)
                        if part_crcs is not None:
                            part_crcs[p] = zlib.crc32(memoryview(seg),
                                                      part_crcs[p])
            else:
                rows = self._partition_rows(p, [], runs)
                if len(rows):
                    combined = self._combine_rows(rows)
                    flat = combined.reshape(-1)
                    write(p, flat)
                    part_lengths[p] = combined.nbytes
                    if part_crcs is not None:
                        part_crcs[p] = zlib.crc32(memoryview(flat))
        return part_lengths, part_crcs

    def _write_spill(self, runs: List[_Run], path: str) -> _Spill:
        """One spill file: partition-contiguous over the runs it covers
        (combiner applied per partition first, shrinking spilled bytes).
        Partition CRCs stream with the writes when at-rest checksums are
        on; a success resets the directory's failure count."""
        fault_mod.storage_check("spill_write", path)
        with open(path, "wb") as f:
            part_lengths, part_crcs = self._emit_partitions(
                runs, lambda p, seg: self._spill_write(f, seg, path))
        success = getattr(self.resolver, "record_spill_dir_success", None)
        if success is not None:
            success(os.path.dirname(path))
        return _Spill(path, part_lengths, part_crcs)

    def _try_overflow(self, seq: int, runs: List[_Run]
                      ) -> Optional[_RemoteSpill]:
        """The tiered ladder's last rung: render the spill in memory and
        park it on a merge peer (push-merge's overflow channel). None =
        no hook installed or no peer could take it — the caller fails
        the attempt as before."""
        if self._overflow_spill is None:
            return None
        import io
        buf = io.BytesIO()
        part_lengths, part_crcs = self._emit_partitions(
            runs, lambda p, seg: buf.write(memoryview(seg)))
        blob = buf.getvalue()
        blob_crc = zlib.crc32(blob)
        try:
            handle = self._overflow_spill(self.shuffle_id, self.map_id,
                                          self.fence, blob)
        except Exception as e:  # noqa: BLE001 — overflow is best-effort;
            # its failure must not mask the original disk error
            log.warning("spill %d overflow push failed: %s", seq, e)
            return None
        if handle is None:
            return None
        self.metrics.record_remote_spill()
        self._tracer.instant("write.spill_remote", "fault",
                             shuffle=self.shuffle_id, map=self.map_id,
                             seq=seq, bytes=handle.size)
        log.warning("spill %d of shuffle %d map %d overflowed to a merge "
                    "peer (%d bytes): local spill dirs exhausted, the "
                    "attempt continues", seq, self.shuffle_id,
                    self.map_id, handle.size)
        return _RemoteSpill(handle, part_lengths, blob_crc, part_crcs)

    # -- combine ---------------------------------------------------------

    def _combine_rows(self, rows: np.ndarray) -> np.ndarray:
        """Sort one partition's rows by key (reusing the scatter's
        grouping — no global argsort) and collapse duplicates through the
        combiner. ``rows`` is contiguous ``(m, row_bytes)``, m > 0."""
        order = np.argsort(_rows_keys(rows), kind="stable")
        srows = rows[order]
        keys_s = np.ascontiguousarray(_rows_keys(srows))
        payload_s = np.ascontiguousarray(srows[:, 8:])
        keys_c, payload_c = self.combiner(keys_s, payload_s)
        keys_c = np.ascontiguousarray(keys_c, dtype=np.uint64)
        payload_c = np.asarray(payload_c)
        if payload_c.dtype != np.uint8:
            # a silent value-cast would wrap non-byte outputs mod 256;
            # combiners must reinterpret (.view(np.uint8)), not cast
            raise ValueError(
                f"combiner must return uint8 payload bytes, got "
                f"{payload_c.dtype} (reinterpret with .view(np.uint8))")
        payload_c = np.ascontiguousarray(payload_c)
        if payload_c.shape != (len(keys_c), self.row_payload_bytes):
            raise ValueError("combiner changed the row width")
        out = np.empty((len(keys_c), self.row_bytes), dtype=np.uint8)
        out[:, :8] = keys_c[:, None].view(np.uint8)
        out[:, 8:] = payload_c
        return out

    def _partition_rows(self, p: int, spills: List[_Spill],
                        runs: List[_Run],
                        spill_fds: Optional[List[int]] = None) -> np.ndarray:
        """All of partition ``p``'s rows across spills-then-runs, in
        arrival order, as one contiguous ``(m, row_bytes)`` matrix."""
        segs = []
        for i, spill in enumerate(spills):
            ln = int(spill.part_lengths[p])
            if ln:
                if isinstance(spill, _RemoteSpill):
                    segs.append(spill.segment(p))
                    continue
                if spill_fds is not None and spill_fds[i] is not None:
                    data = os.pread(spill_fds[i], ln,
                                    int(spill.part_offsets[p]))
                else:
                    with open(spill.path, "rb") as f:
                        f.seek(int(spill.part_offsets[p]))
                        data = f.read(ln)
                segs.append(np.frombuffer(data, dtype=np.uint8))
        for run in runs:
            seg = run.segment(p)
            if len(seg):
                segs.append(seg)
        if not segs:
            return np.zeros((0, self.row_bytes), dtype=np.uint8)
        return np.concatenate(segs).reshape(-1, self.row_bytes)

    # -- close: merge + commit ------------------------------------------

    def close(self, success: bool = True) -> Optional[Tuple[int, np.ndarray]]:
        """Commit (or abort). Returns (file_token, partition_lengths).

        Mirrors ``stop(success)`` (RdmaWrapperShuffleWriter.scala:104-122):
        on success the committed file is mapped, registered with the block
        server and ready for publication the moment the rename lands; on
        failure every byte — run buffers, spill files, the data tmp — is
        discarded (nothing may leak into the shuffle dir)."""
        if self._closed:
            raise RuntimeError("writer already closed")
        self._closed = True
        if not success:
            self._abort_cleanup()
            return None
        try:
            self._drain_spills()
            t0 = time.perf_counter_ns()
            with self._tracer.span("write.merge", "write",
                                   shuffle=self.shuffle_id, map=self.map_id,
                                   spills=len(self._spills)):
                tmp, partition_lengths, partition_crcs = self._merge()
            self.metrics.record_merge(time.perf_counter_ns() - t0)
            _, token = self.resolver.commit(self.shuffle_id, self.map_id,
                                            tmp, partition_lengths,
                                            fence=self.fence,
                                            partition_crcs=partition_crcs)
        except StaleAttemptError:
            # a newer attempt already committed: this attempt is a zombie
            # — clean up everything, never publish
            self._tracer.instant("commit.fenced", "fault",
                                 shuffle=self.shuffle_id, map=self.map_id,
                                 fence=self.fence)
            self._abort_cleanup()
            raise
        except WriteFailedError:
            self._abort_cleanup()
            raise
        except OSError as e:
            # merge/commit-time disk failure: the attempt fails CLEANLY
            # (all artifacts reaped) and classified so the map stage can
            # re-place it on another executor
            self._abort_cleanup()
            raise WriteFailedError(
                f"merge/commit of shuffle {self.shuffle_id} map "
                f"{self.map_id} failed: {e}") from e
        except BaseException:
            self._abort_cleanup()
            raise
        self._cleanup_spill_files()
        self._free_runs()
        self._stop_spill_workers()
        self.bytes_written = int(partition_lengths.sum())
        if self.combiner is not None:
            # Spark's recordsWritten counts rows actually written to the
            # shuffle file — post-combine
            self.records_written = self.bytes_written // self.row_bytes
        return token, partition_lengths

    def _merge(self) -> Tuple[str, np.ndarray, Optional[List[int]]]:
        """Sequential merge of partition-contiguous runs into the data tmp:
        for each partition, spill segments stream kernel-side (sendfile)
        and in-memory runs write straight from (registered pool) run
        memory — no global sort, no monolithic rows copy. With at-rest
        checksums on, per-partition CRCs assemble as the bytes flow:
        sendfile'd spill segments contribute the CRC computed when they
        were SPILLED (``crc32_combine`` — the kernel-side copy stays
        kernel-side), in-memory runs CRC directly."""
        tmp = self._tmp_base()
        fault_mod.storage_check("merge_write", tmp)
        spills = [self._spills[s] for s in sorted(self._spills)]
        # ENOSPC-overflowed spills live on a merge peer: fetch each back
        # whole before the partition loop (one bounded buffer per remote
        # spill; by merge time local disk only needs the final file)
        for s in spills:
            if isinstance(s, _RemoteSpill):
                s.materialize()
        runs = self._runs
        part_lengths = np.zeros(self.num_partitions, dtype=np.int64)
        part_crcs = [0] * self.num_partitions if self._crc_enabled else None
        out_fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        spill_fds = []
        try:
            spill_fds = [None if isinstance(s, _RemoteSpill)
                         else os.open(s.path, os.O_RDONLY) for s in spills]
            for p in range(self.num_partitions):
                if self.combiner is None:
                    total = 0
                    for s, fd in zip(spills, spill_fds):
                        ln = int(s.part_lengths[p])
                        if not ln:
                            continue
                        if fd is None:
                            seg = s.segment(p)
                            self._merge_write(out_fd, seg, tmp)
                            if part_crcs is not None:
                                part_crcs[p] = zlib.crc32(
                                    memoryview(seg), part_crcs[p])
                        else:
                            _copy_from_file(out_fd, fd,
                                            int(s.part_offsets[p]), ln)
                            if part_crcs is not None:
                                part_crcs[p] = integrity.crc32_combine(
                                    part_crcs[p], s.part_crcs[p], ln)
                        total += ln
                    for run in runs:
                        seg = run.segment(p)
                        if len(seg):
                            self._merge_write(out_fd, seg, tmp)
                            if part_crcs is not None:
                                part_crcs[p] = zlib.crc32(memoryview(seg),
                                                          part_crcs[p])
                            total += len(seg)
                    part_lengths[p] = total
                else:
                    rows = self._partition_rows(p, spills, runs, spill_fds)
                    if len(rows):
                        combined = self._combine_rows(rows)
                        flat = combined.reshape(-1)
                        self._merge_write(out_fd, flat, tmp)
                        if part_crcs is not None:
                            part_crcs[p] = zlib.crc32(memoryview(flat))
                        part_lengths[p] = combined.nbytes
        finally:
            for fd in spill_fds:
                if fd is not None:
                    os.close(fd)
            os.close(out_fd)
        return tmp, part_lengths, part_crcs

    def _merge_write(self, out_fd: int, view: np.ndarray, tmp: str) -> None:
        """One guarded merge write (torn-write injection point; a torn
        merge fails the attempt — the rename-commit never sees it)."""
        cap = fault_mod.storage_write_cap("merge_write", tmp, len(view))
        if cap is not None:
            _write_all(out_fd, view[:cap])
            raise OSError(errno.EIO,
                          f"fault injection: torn merge write "
                          f"({cap}/{len(view)} bytes landed)", tmp)
        _write_all(out_fd, view)

    def _drain_spills(self) -> None:
        with self._cv:
            while self._inflight > 0 and self._spill_error is None:
                self._check_spill_health_locked()
                if self._spill_error is not None:
                    break
                self._cv.wait(timeout=0.05)
            self._raise_spill_error_locked()

    def _free_runs(self) -> None:
        with self._cv:
            runs, self._runs = self._runs, []
            self._buffered = 0
        for run in runs:
            run.free()  # pool lease release: outside the cv, it takes
            #             the pool's own lock

    def _cleanup_spill_files(self) -> None:
        with self._cv:
            spills = list(self._spills.values())
            self._spills = {}
        for spill in spills:
            if isinstance(spill, _RemoteSpill):
                continue  # peer-held blob: reaped with the shuffle on
                # the merge target (unregister -> MergeStore.drop_shuffle)
            self._reap(spill.path)

    def _stop_spill_workers(self) -> None:
        if self._spill_queue is not None:
            for _ in self._spill_workers:
                self._spill_queue.put(None)
            for t in self._spill_workers:
                t.join(timeout=30)
            with self._cv:
                self._spill_workers = []

    def _abort_cleanup(self) -> None:
        """Abort path: nothing of this attempt survives on disk — not the
        data tmp, not a spill file (fallback-dir spills included). In-
        flight spill jobs are told to skip their writes, then every
        artifact is unlinked (best-effort but COUNTED — see _reap)."""
        self._aborted = True
        with self._cv:
            deadline = time.monotonic() + 30
            while self._inflight > 0 and time.monotonic() < deadline:
                self._check_spill_health_locked()
                if self._spill_error is not None:
                    break  # dead worker: its spills can't complete; sweep
                self._cv.wait(timeout=0.05)
        self._stop_spill_workers()
        self._free_runs()
        self._cleanup_spill_files()
        with self._cv:
            attempted = set(self._spill_paths)
        if self._tmp_path is not None:
            # every path this attempt ever opened, plus the primary-dir
            # names of any spill that slipped past the abort flag (its
            # _Spill record may not have registered)
            for seq in range(self._spill_seq):
                attempted.add(self._spill_path(seq))
            for path in sorted(attempted):
                self._reap(path)
            self._reap(self._tmp_path)


class MonolithicShuffleWriter:
    """The pre-streaming writer, frozen: buffer everything, then at close
    concatenate, argsort by destination, materialize one rows copy and
    write it. Kept as the parity baseline (the streaming writer's committed
    files must be byte-identical) and as the microbench's "before" side
    (``shuffle/write_bench.py``); not used on any production path."""

    def __init__(self, resolver: TpuShuffleBlockResolver, shuffle_id: int,
                 map_id: int, num_partitions: int, partitioner: Partitioner,
                 row_payload_bytes: int,
                 combiner: Optional[Callable] = None):
        self.resolver = resolver
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.num_partitions = num_partitions
        self.partitioner = partitioner
        self.row_payload_bytes = row_payload_bytes
        self.combiner = combiner
        self._keys: List[np.ndarray] = []
        self._payloads: List[np.ndarray] = []
        self._closed = False
        self.bytes_written = 0
        self.records_written = 0
        self.cleanup_errors = 0  # swallowed-but-counted cleanup failures
        self.fence = resolver.begin_attempt(shuffle_id, map_id)

    @property
    def row_bytes(self) -> int:
        return 8 + self.row_payload_bytes

    def write_batch(self, keys: np.ndarray,
                    payload: Optional[np.ndarray] = None) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if payload is None:
            payload = np.zeros((len(keys), self.row_payload_bytes),
                               dtype=np.uint8)
        payload = np.ascontiguousarray(payload, dtype=np.uint8)
        if payload.shape != (len(keys), self.row_payload_bytes):
            raise ValueError(
                f"payload must be [{len(keys)}, {self.row_payload_bytes}]")
        self._keys.append(keys)
        self._payloads.append(payload)
        self.records_written += len(keys)

    def close(self, success: bool = True) -> Optional[Tuple[int, np.ndarray]]:
        if self._closed:
            raise RuntimeError("writer already closed")
        self._closed = True
        if not success:
            self._keys, self._payloads = [], []
            return None
        keys = (np.concatenate(self._keys) if self._keys
                else np.zeros(0, dtype=np.uint64))
        payload = (np.concatenate(self._payloads) if self._payloads
                   else np.zeros((0, self.row_payload_bytes), dtype=np.uint8))
        self._keys, self._payloads = [], []

        if self.combiner is not None and len(keys):
            order = np.argsort(keys, kind="stable")
            keys, payload = self.combiner(keys[order], payload[order])
            keys = np.ascontiguousarray(keys, dtype=np.uint64)
            payload = np.asarray(payload)
            if payload.dtype != np.uint8:
                raise ValueError(
                    f"combiner must return uint8 payload bytes, got "
                    f"{payload.dtype} (reinterpret with .view(np.uint8))")
            payload = np.ascontiguousarray(payload)
            if payload.shape != (len(keys), self.row_payload_bytes):
                raise ValueError("combiner changed the row width")
            self.records_written = len(keys)

        dest = np.asarray(self.partitioner(keys), dtype=np.int64)
        if len(dest) != len(keys):
            raise ValueError("partitioner returned wrong-length array")
        if len(dest) and (dest.min() < 0 or dest.max() >= self.num_partitions):
            raise ValueError("partitioner returned out-of-range partition id")

        order = np.argsort(dest, kind="stable")
        counts = np.bincount(dest, minlength=self.num_partitions)

        rows = np.empty((len(keys), self.row_bytes), dtype=np.uint8)
        rows[:, :8] = keys[order, None].view(np.uint8).reshape(len(keys), 8)
        rows[:, 8:] = payload[order]

        tmp = self.resolver.data_tmp_path(self.shuffle_id, self.map_id,
                                          fence=self.fence)
        try:
            rows.tofile(tmp)
            partition_lengths = counts * self.row_bytes
            _, token = self.resolver.commit(self.shuffle_id, self.map_id, tmp,
                                            partition_lengths,
                                            fence=self.fence)
        except BaseException:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            except OSError as e:
                self.cleanup_errors += 1
                log.warning("cleanup of %s failed (leak candidate): %s",
                            tmp, e)
            raise
        self.bytes_written = int(partition_lengths.sum())
        return token, partition_lengths


def make_sum_combiner(dtype: str = "<u4") -> Callable:
    """Vectorized built-in combiner: payload viewed as ``dtype`` vectors,
    summed per key (wrapping per dtype — matches on-device u32 aggregate
    semantics, ops/aggregate.py). Usable as ``get_writer(combiner=...)``.
    Associative and commutative, so it is exact under spilling (the writer
    re-combines spilled runs at merge)."""

    def combine(keys: np.ndarray, payload: np.ndarray):
        if not len(keys):
            return keys, payload
        # keys arrive sorted (writer contract — per partition run since the
        # streaming writer; previously one global sort): group starts are
        # O(n), no second sort
        change = np.empty(len(keys), dtype=bool)
        change[0] = True
        np.not_equal(keys[1:], keys[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        vals = np.ascontiguousarray(payload).view(dtype)
        sums = np.add.reduceat(vals, starts, axis=0)
        return keys[starts], np.ascontiguousarray(sums, dtype=dtype).view(
            np.uint8).reshape(len(starts), -1)

    return combine


def decode_rows(data, row_payload_bytes: int,
                copy: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of the writer's row format: bytes -> (keys, payload).

    One materialization, not two: with ``copy=True`` (default) the row
    bytes are copied ONCE and both returned arrays are zero-copy views
    into that copy — use when ``data`` is transient (a pool lease about to
    be released). With ``copy=False`` both arrays view ``data`` directly
    (zero copies; read-only when ``data`` is an immutable bytes object) —
    use when the caller owns the bytes for the arrays' lifetime."""
    row_bytes = 8 + row_payload_bytes
    if len(data) % row_bytes:
        raise ValueError(f"byte length {len(data)} not a multiple of row size "
                         f"{row_bytes}")
    rows = np.frombuffer(data, dtype=np.uint8).reshape(-1, row_bytes)
    if copy:
        rows = rows.copy()
    return _rows_keys(rows), rows[:, 8:]
