"""Spill-file staging: committed map outputs -> contiguous staging buffers.

Re-design of java/RdmaMappedFile.java. The reference mmaps the committed
shuffle data file in partition-aligned chunks of at least
``shuffleWriteBlockSize`` and registers each chunk as an RDMA MR
(RdmaMappedFile.java:113-157, 163-189), filling the per-map
``RdmaMapTaskOutput`` with each partition's location (141-156). With no NIC,
the TPU path is: mmap the spill file (native shim), record per-partition
(offset, length) in a MapTaskOutput against a *file* token, and on demand
gather any block subset into one contiguous pool buffer (the scatter-READ
analogue, multithreaded memcpy at host memory bandwidth) ready for a single
host->HBM transfer.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from sparkrdma_tpu_torch.runtime import native
from sparkrdma_tpu_torch.runtime.pool import BufferPool, PoolBuffer
from sparkrdma_tpu_torch.shuffle.map_output import MapTaskOutput


class SpillFile:
    """A committed map-output data file, mapped for serving.

    Like the reference's mapped file, the object owns the mapping for the
    file's lifetime and deletes the file on dispose
    (RdmaMappedFile.java:110, 208-218).
    """

    def __init__(self, path: str, partition_lengths: Sequence[int],
                 file_token: int, delete_on_dispose: bool = True):
        self.path = path
        self.file_token = file_token
        self._delete = delete_on_dispose
        lengths = np.asarray(partition_lengths, dtype=np.uint64)
        if len(lengths) and int(lengths.max()) > 0xFFFFFFFF:
            # the 16B wire entry stores u32 lengths (reference parity,
            # scala/RdmaMapTaskOutput.scala:25); refuse rather than wrap
            raise ValueError("partition length exceeds 4 GiB entry limit; "
                             "split partitions or raise write parallelism")
        offsets = np.zeros(len(lengths), dtype=np.uint64)
        if len(lengths) > 1:
            offsets[1:] = np.cumsum(lengths[:-1])
        self.partition_offsets = offsets
        self.partition_lengths = lengths
        self.size = int(lengths.sum())

        # Per-map location table (RdmaMappedFile.java:141-156).
        self.map_output = MapTaskOutput(len(lengths))
        self.map_output.put_all(offsets, lengths.astype(np.uint32), file_token)

        self._native_handle = None
        self._py_data: Optional[np.ndarray] = None
        # reader refcount so dispose() can't unmap under an in-flight gather
        # (serving threads race shuffle cleanup; the reference relies on the
        # JVM GC + dispose ordering, we make it explicit)
        self._rc_cv = threading.Condition()
        self._readers = 0
        self._disposed = False
        self._mapped = False  # registration-on-demand: map at first read
        # the validation open's fd is RETAINED to pin the inode: a
        # speculative re-commit os.replace()s this very path before the
        # old token unregisters, and the deferred first map must read the
        # bytes committed under THIS token, not the path's current content
        self._fd = os.open(path, os.O_RDONLY)
        actual = os.fstat(self._fd).st_size
        if actual < self.size:
            os.close(self._fd)
            self._fd = -1
            raise ValueError(f"spill file {path} shorter ({actual}) than "
                             f"declared partitions ({self.size})")

    def _map_locked(self) -> None:
        """One-time source mapping, under ``_rc_cv``. Deferred from
        __init__ (registration-on-demand, the NP-RDMA argument applied
        host-side): a committed output that is only ever served by the
        native block server — or never read at all — costs no mapping
        here, and the pure-Python fallback stops paying a full file read
        at every commit. A map failure surfaces as OSError to the
        reader, the retryable serve-error class. Maps through the
        retained fd (``/proc/self/fd``), never by path — the path may
        have been renamed over by a re-commit since construction."""
        fd_path = f"/proc/self/fd/{self._fd}"
        if native.available() and self.size > 0:
            out_size = ctypes.c_uint64()
            h = native.LIB.staging_map_file(fd_path.encode(),
                                            ctypes.byref(out_size))
            if h:
                self._native_handle = h
        if self._native_handle is None and self.size > 0:
            os.lseek(self._fd, 0, os.SEEK_SET)
            with os.fdopen(os.dup(self._fd), "rb", closefd=True) as f:
                self._py_data = np.fromfile(f, dtype=np.uint8)
        self._mapped = True

    def _enter_read(self) -> None:
        with self._rc_cv:
            if self._disposed:
                raise RuntimeError(f"spill file {self.path} is disposed")
            if not self._mapped:
                self._map_locked()
            self._readers += 1

    def _exit_read(self) -> None:
        with self._rc_cv:
            self._readers -= 1
            if self._readers == 0:
                self._rc_cv.notify_all()

    def gather(self, offsets: Sequence[int], lengths: Sequence[int],
               dst: np.ndarray, nthreads: int = 4) -> int:
        """Pack the given blocks back-to-back into ``dst``; returns bytes."""
        self._enter_read()
        try:
            return self._gather_locked(offsets, lengths, dst, nthreads)
        finally:
            self._exit_read()

    def _gather_locked(self, offsets: Sequence[int], lengths: Sequence[int],
                       dst: np.ndarray, nthreads: int = 4) -> int:
        offs = np.ascontiguousarray(offsets, dtype=np.uint64)
        lens = np.ascontiguousarray(lengths, dtype=np.uint64)
        total = int(lens.sum())
        if total > dst.nbytes:
            raise ValueError("destination buffer too small")
        if total == 0:
            return 0
        if self._native_handle is not None:
            u64p = ctypes.POINTER(ctypes.c_uint64)
            n = native.LIB.staging_gather(
                self._native_handle,
                offs.ctypes.data_as(u64p), lens.ctypes.data_as(u64p),
                len(offs), dst.ctypes.data_as(ctypes.c_char_p), nthreads)
            if n < 0:
                raise IndexError("block out of file bounds")
            return int(n)
        pos = 0
        for off, ln in zip(offs.tolist(), lens.tolist()):
            if off + ln > self.size:
                raise IndexError("block out of file bounds")
            dst[pos:pos + ln] = self._py_data[off:off + ln]
            pos += ln
        return pos

    def gather_partitions(self, partition_ids: Sequence[int], pool: BufferPool,
                          nthreads: int = 4) -> PoolBuffer:
        """Gather whole partitions into one pool buffer (lease returned)."""
        offs = self.partition_offsets[list(partition_ids)]
        lens = self.partition_lengths[list(partition_ids)]
        buf = pool.get(max(int(lens.sum()), 1))
        self.gather(offs, lens, buf.view, nthreads)
        return buf

    def read_partition(self, partition_id: int) -> bytes:
        """Serve one local partition (RdmaMappedFile.java:231-235)."""
        off = int(self.partition_offsets[partition_id])
        ln = int(self.partition_lengths[partition_id])
        if ln == 0:
            return b""
        out = np.empty(ln, dtype=np.uint8)
        self.gather([off], [ln], out)  # refcounted on both backends
        return out.tobytes()

    def dispose(self) -> None:
        with self._rc_cv:
            if self._disposed:
                return
            self._disposed = True
            # drain in-flight readers before unmapping (bounded wait; a stuck
            # reader is a bug, not a reason to hold the mapping forever)
            deadline = 30.0
            while self._readers > 0 and deadline > 0:
                self._rc_cv.wait(timeout=0.1)
                deadline -= 0.1
        with self._rc_cv:
            # re-entering the cv keeps the handle teardown ordered
            # against a reader that lost the drain race to the deadline
            if self._native_handle is not None:
                native.LIB.staging_unmap(self._native_handle)
                self._native_handle = None
            self._py_data = None
            if self._fd >= 0:
                os.close(self._fd)
                self._fd = -1
        if self._delete and os.path.exists(self.path):
            os.unlink(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()
