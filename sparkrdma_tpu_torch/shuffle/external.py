"""Bounded-memory sort/merge: the ExternalSorter role.

The reference leans on Spark's ExternalSorter for beyond-memory reduces
(scala/RdmaShuffleReader.scala:100-114: sort runs, spill to disk, k-way
merge). A standalone framework needs that half in-tree:

* ``merge_two`` / ``merge_runs`` — vectorized positional merges of sorted
  row arrays (O(N log R) tournament over R runs; numpy has no merge
  primitive, but two sorted arrays interleave with two ``searchsorted``
  calls and two scatters — no per-row Python).
* ``ExternalMerger`` — the spill path: batches accumulate to a memory
  budget, spill as sorted runs to disk, then stream back globally sorted
  via a k-way buffered merge whose resident set is bounded by
  ``runs x run_buffer_rows`` rows regardless of dataset size. Plain
  ``file.read`` (not mmap) so an address-space rlimit genuinely bounds
  the process.

Merge scheme (vectorized k-way): each live run keeps a small sorted
buffer; every round emits all rows with key <= the minimum over runs of
"my buffer's last key" — any unread row in any run is >= that threshold,
so the emitted prefix is globally final. The threshold run drains its
whole buffer, guaranteeing progress.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]  # (keys u64[N], payload u8[N, W])


def merge_two(a_keys: np.ndarray, a_rows: np.ndarray,
              b_keys: np.ndarray, b_rows: np.ndarray) -> Batch:
    """Merge two key-sorted row sets, stable with ``a`` first on ties."""
    pos_a = np.arange(len(a_keys)) + np.searchsorted(b_keys, a_keys, "left")
    pos_b = np.arange(len(b_keys)) + np.searchsorted(a_keys, b_keys, "right")
    keys = np.empty(len(a_keys) + len(b_keys), a_keys.dtype)
    rows = np.empty((len(keys),) + a_rows.shape[1:], a_rows.dtype)
    keys[pos_a], keys[pos_b] = a_keys, b_keys
    rows[pos_a], rows[pos_b] = a_rows, b_rows
    return keys, rows


def merge_runs(runs: Sequence[Batch]) -> Batch:
    """Tournament-merge R key-sorted runs in O(N log R) — the in-memory
    replacement for the full re-sort (models/terasort.py streamed merge)."""
    runs = list(runs)
    nonempty = [r for r in runs if len(r[0])]
    if not nonempty:
        if runs:  # preserve the caller's dtypes/row shape, just empty
            k0, r0 = runs[0]
            return k0[:0], r0[:0]
        return np.zeros(0, np.uint64), np.zeros((0, 0), np.uint8)
    runs = nonempty
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(merge_two(*runs[i], *runs[i + 1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


class ExternalMerger:
    """Spill-to-disk sorted merge with a bounded memory footprint.

    ``add_batch`` buffers rows; when buffered bytes exceed
    ``memory_budget_bytes`` the buffer is sorted and written out as one
    run. ``sorted_batches()`` then streams the global sort order, holding
    only ``num_runs x run_buffer_rows`` rows resident. Track
    ``peak_buffer_bytes`` to audit the bound.
    """

    def __init__(self, row_payload_bytes: int,
                 spill_dir: Optional[str] = None,
                 memory_budget_bytes: int = 64 << 20,
                 run_buffer_rows: int = 8192):
        self.row_payload_bytes = row_payload_bytes
        self.row_bytes = 8 + row_payload_bytes
        self.memory_budget_bytes = memory_budget_bytes
        self.run_buffer_rows = run_buffer_rows
        self._own_dir = spill_dir is None
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="extsort_")
        os.makedirs(self.spill_dir, exist_ok=True)
        self._pending: List[Batch] = []
        self._pending_bytes = 0
        self._runs: List[Tuple[str, int]] = []  # (path, num_rows)
        self.spilled_bytes = 0
        self.peak_buffer_bytes = 0
        self._closed = False

    # -- feeding ---------------------------------------------------------

    def add_batch(self, keys: np.ndarray, payload: np.ndarray) -> None:
        assert not self._closed
        if len(keys) == 0:
            return
        self._pending.append((np.asarray(keys, np.uint64),
                              np.asarray(payload, np.uint8)))
        self._pending_bytes += len(keys) * self.row_bytes
        self.peak_buffer_bytes = max(self.peak_buffer_bytes,
                                     self._pending_bytes)
        if self._pending_bytes >= self.memory_budget_bytes:
            self._spill()

    def _spill(self) -> None:
        if not self._pending:
            return
        keys = np.concatenate([k for k, _ in self._pending])
        payload = np.concatenate([p for _, p in self._pending])
        self._pending, self._pending_bytes = [], 0
        order = np.argsort(keys, kind="stable")
        rows = np.empty((len(keys), self.row_bytes), np.uint8)
        rows[:, :8] = keys[order, None].view(np.uint8).reshape(-1, 8)
        rows[:, 8:] = payload[order]
        path = os.path.join(self.spill_dir, f"run{len(self._runs)}.bin")
        with open(path, "wb") as f:
            f.write(rows.tobytes())
        self._runs.append((path, len(keys)))
        self.spilled_bytes += rows.nbytes

    # -- draining --------------------------------------------------------

    def sorted_batches(self) -> Iterator[Batch]:
        """Stream the global sort order; bounded resident set."""
        assert not self._closed
        if not self._runs:
            # everything fit in the budget: sort in memory, skip the disk
            # round-trip entirely
            if not self._pending:
                return
            keys = np.concatenate([k for k, _ in self._pending])
            payload = np.concatenate([p for _, p in self._pending])
            self._pending, self._pending_bytes = [], 0
            order = np.argsort(keys, kind="stable")
            yield keys[order], payload[order]
            return
        self._spill()  # flush the tail as the final run
        cursors = [_RunCursor(path, rows, self.row_bytes,
                              self.run_buffer_rows)
                   for path, rows in self._runs]
        try:
            live = [c for c in cursors if c.refill()]
            while live:
                # all rows <= the minimum of the buffers' last keys are
                # globally final this round
                threshold = min(c.last_key() for c in live)
                ks, ps = [], []
                for c in live:
                    k, p = c.take_upto(threshold)
                    if len(k):
                        ks.append(k)
                        ps.append(p)
                keys = np.concatenate(ks)
                payload = np.concatenate(ps)
                order = np.argsort(keys, kind="stable")
                yield keys[order], payload[order]
                live = [c for c in live if c.ensure()]
        finally:
            for c in cursors:
                c.close()

    def sorted_all(self) -> Batch:
        """Materialize the merge (small datasets / tests)."""
        parts = list(self.sorted_batches())
        if not parts:
            return (np.zeros(0, np.uint64),
                    np.zeros((0, self.row_payload_bytes), np.uint8))
        return (np.concatenate([k for k, _ in parts]),
                np.concatenate([p for _, p in parts]))

    @property
    def num_runs(self) -> int:
        return len(self._runs) + (1 if self._pending else 0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._pending = []
        for path, _ in self._runs:
            try:
                os.unlink(path)
            except OSError:
                pass
        if self._own_dir:
            shutil.rmtree(self.spill_dir, ignore_errors=True)

    def __enter__(self) -> "ExternalMerger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _RunCursor:
    """Buffered reader over one sorted run file."""

    def __init__(self, path: str, total_rows: int, row_bytes: int,
                 buffer_rows: int):
        self._f = open(path, "rb")
        self._remaining = total_rows
        self._row_bytes = row_bytes
        self._buffer_rows = buffer_rows
        self._keys = np.zeros(0, np.uint64)
        self._payload = np.zeros((0, row_bytes - 8), np.uint8)

    def refill(self) -> bool:
        """Read the next chunk into the (empty) buffer; False when the
        run is exhausted. Only called with an empty buffer, which is what
        keeps the resident bound at exactly buffer_rows per run."""
        assert not len(self._keys)
        if self._remaining == 0:
            return False
        take = min(self._buffer_rows, self._remaining)
        data = self._f.read(take * self._row_bytes)
        self._remaining -= take
        rows = np.frombuffer(data, np.uint8).reshape(take, self._row_bytes)
        self._keys = rows[:, :8].copy().view(np.uint64).ravel()
        self._payload = rows[:, 8:].copy()
        return True

    def ensure(self) -> bool:
        """Make sure the buffer is non-empty; False when fully drained."""
        if len(self._keys):
            return True
        return self.refill() if self._remaining else False

    def last_key(self) -> int:
        return int(self._keys[-1])

    def take_upto(self, threshold: int) -> Batch:
        cut = int(np.searchsorted(self._keys, np.uint64(threshold), "right"))
        k, p = self._keys[:cut], self._payload[:cut]
        self._keys, self._payload = self._keys[cut:], self._payload[cut:]
        return k, p

    def close(self) -> None:
        self._f.close()
