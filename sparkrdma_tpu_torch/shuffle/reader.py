"""Shuffle reader: drain the fetcher into record batches.

Re-design of ``scala/RdmaShuffleReader.scala``: builds the fetcher iterator,
decodes streams into records, and optionally aggregates / sorts the combined
output (:43-115 — deserialize, aggregate, ExternalSorter when keyOrdering).
Compression/encryption stream wrapping (:54-69) has no analogue: rows are
fixed-width binary already.

Port of ``sparkrdma_tpu/shuffle/reader.py``: the same module but for
``TpuShuffleReader.read_to_device``, which stages on a PyTorch device
through one lease of the executor's pool, charged to the fetcher's
tenant as the JAX method's is (fetched chunks -> the lease -> one copy
up), or, when the native fetch engine landed every chunk in pool-lease
memory, copies the lease views up with no staging gather. The
module-level on-ramp ``read_to_device`` stages chunks that no tenant
owns through one pinned host buffer. ``torch`` is imported by these
paths only.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel.endpoints import ExecutorEndpoint
from sparkrdma_tpu_torch.shuffle.fetcher import ReadMetrics, ShuffleFetcher
from sparkrdma_tpu_torch.shuffle.resolver import TpuShuffleBlockResolver
from sparkrdma_tpu_torch.shuffle.writer import decode_rows

Batch = Tuple[np.ndarray, np.ndarray]  # (keys u64[N], payload u8[N, W])


class TpuShuffleReader:
    """One reducer's reader over partitions [start, end)."""

    def __init__(self, endpoint: ExecutorEndpoint,
                 resolver: Optional[TpuShuffleBlockResolver],
                 conf: TpuShuffleConf, shuffle_id: int, num_maps: int,
                 start_partition: int, end_partition: int,
                 row_payload_bytes: int, reader_stats=None, tracer=None,
                 pool=None, map_range=None):
        self.row_payload_bytes = row_payload_bytes
        # adaptive reduce planning: a plan-SPLIT task reads its partition
        # from a [map_lo, map_hi) slice of the map space; None = all maps
        self.map_range = tuple(map_range) if map_range is not None else None
        self.fetcher = ShuffleFetcher(endpoint, resolver, conf, shuffle_id,
                                      num_maps, start_partition, end_partition,
                                      reader_stats=reader_stats, tracer=tracer,
                                      pool=pool, map_range=map_range)

    @property
    def metrics(self) -> ReadMetrics:
        return self.fetcher.metrics

    def read(self) -> Iterator[Batch]:
        """Record batches in arrival order (one per grouped fetch).

        Batches may be READ-ONLY zero-copy views (blocks that arrived as
        owned bytes decode without any copy); copy before mutating in
        place. ``read_all``/``read_sorted`` return fresh writable arrays.
        """
        self.fetcher.start()
        try:
            for result in self.fetcher:
                # len(), not truthiness: lease-backed results are numpy
                # views (multi-element truthiness raises). Lease-backed
                # bytes are materialized ONCE by the decode (the pool
                # lease releases immediately after); results whose bytes
                # the fetch already handed us outright decode zero-copy.
                try:
                    if len(result.data):
                        owned = (result.lease is None
                                 and isinstance(result.data,
                                                (bytes, bytearray)))
                        yield decode_rows(result.data,
                                          self.row_payload_bytes,
                                          copy=not owned)
                finally:
                    result.free()
        finally:
            # releases budget waiters + peer threads if the consumer stops
            # early (GeneratorExit) or a fetch failed
            self.fetcher.close()

    def read_all(self) -> Batch:
        """Materialize every record of the partition range.

        With ``warm_read_cache`` on, the materialized range is kept in
        the worker-process cache keyed by the location EPOCH it was read
        under (shuffle/dist_cache.py): iteration N+1 over the unchanged
        shuffle serves it locally — zero RPCs, zero bytes moved — and an
        epoch bump (re-execution, executor loss) invalidates. Cached
        round trips copy on both sides so callers may mutate freely.
        """
        f = self.fetcher
        warm = f.conf.warm_read_cache
        if warm:
            from sparkrdma_tpu_torch.shuffle import dist_cache

            known = f.endpoint.location_plane.known_epoch(f.shuffle_id)
            if known is not None and known > 0:
                cached = dist_cache.get_range(f.shuffle_id, known,
                                              f.start_partition,
                                              f.end_partition,
                                              map_range=self.map_range)
                if cached is not None:
                    f.metrics.warm_range_hits += 1
                    return cached[0].copy(), cached[1].copy()
        keys_parts, payload_parts = [], []
        for keys, payload in self.read():
            keys_parts.append(keys)
            payload_parts.append(payload)
        if not keys_parts:
            keys = np.zeros(0, dtype=np.uint64)
            payload = np.zeros((0, self.row_payload_bytes), dtype=np.uint8)
        else:
            keys = np.concatenate(keys_parts)
            payload = np.concatenate(payload_parts)
        if warm and f.epoch > 0:
            from sparkrdma_tpu_torch.shuffle import dist_cache

            dist_cache.put_range(f.shuffle_id, f.epoch, f.start_partition,
                                 f.end_partition, keys.copy(),
                                 payload.copy(), map_range=self.map_range)
        return keys, payload

    def read_sorted(self) -> Batch:
        """Full sort by key (the ExternalSorter role,
        scala/RdmaShuffleReader.scala:100-114)."""
        keys, payload = self.read_all()
        order = np.argsort(keys, kind="stable")
        return keys[order], payload[order]

    def read_sorted_spilled(self, memory_budget_bytes: int = 64 << 20,
                            spill_dir: Optional[str] = None,
                            ) -> Iterator[Batch]:
        """Globally key-sorted batches with a bounded resident set: fetched
        batches spill as sorted runs once ``memory_budget_bytes`` is
        buffered, then stream back through a k-way disk merge — the
        ExternalSorter delegation of scala/RdmaShuffleReader.scala:100-114
        for reduces that exceed host memory (``read_sorted`` materializes
        everything)."""
        from sparkrdma_tpu_torch.shuffle.external import ExternalMerger

        with ExternalMerger(self.row_payload_bytes, spill_dir=spill_dir,
                            memory_budget_bytes=memory_budget_bytes) as m:
            for keys, payload in self.read():
                m.add_batch(keys, payload)
            yield from m.sorted_batches()

    def read_aggregated(self, combine: Callable[[np.ndarray, np.ndarray], Batch]
                        ) -> Batch:
        """Aggregate with a vectorized combiner (sorted-run reduction).
        Combiners never see zero rows — the same contract the writer's
        map-side combine keeps (an empty partition short-circuits)."""
        keys, payload = self.read_sorted()
        if not len(keys):
            return keys, payload
        return combine(keys, payload)

    def read_to_device(self, pool, device=None):
        """Stage the partition range on ``device`` (``cuda`` unless the
        caller asks for another; with no card and no request this
        raises). Returns ``(keys int32[N, 2], payload uint8[N, W])``
        device tensors: each key as its (lo, hi) u32 words in int32 bits,
        the JAX method's ``u32[N, 2]``.

        The fetched chunks are gathered into one lease of ``pool``,
        charged to the fetcher's tenant (a tenant over
        ``tenant_pool_quota`` gets ``TenantQuotaError`` before any
        staging), and go up from it in one copy; the lease is freed once
        that copy has completed. Under ``native_fetch``, when every chunk
        is pool-lease memory holding whole rows, the lease views are
        copied up as they are, with no staging gather; every lease is
        freed only after the copies completed.
        """
        import torch

        from sparkrdma_tpu_torch.parallel.mesh import resolve_device

        self.fetcher.start()
        chunks = []
        try:
            device = resolve_device(device)
            total = 0
            for result in self.fetcher:
                if len(result.data):
                    # the result (and its pool lease, if any) is held
                    # until the staging copy below, then freed
                    chunks.append(result)
                    total += len(result.data)
                else:
                    result.free()
            row_bytes = 8 + self.row_payload_bytes
            if total == 0:
                return read_to_device([], self.row_payload_bytes, device)
            if (self.fetcher.conf.native_fetch
                    and all(r.lease is not None for r in chunks)
                    and all(len(r.data) % row_bytes == 0 for r in chunks)):
                return _donated([r.data for r in chunks],
                                self.row_payload_bytes, device)
            with pool.get(total, tenant=self.fetcher.tenant) as buf:
                staged = _gather([r.data for r in chunks], row_bytes,
                                 buf.view[:total])
                for r in chunks:
                    r.free()
                # a copy even on the CPU: the lease goes back to the pool
                # once _split_rows has waited for the copy
                flat = torch.from_numpy(staged).to(device, non_blocking=True,
                                                   copy=True)
                return _split_rows(flat, self.row_payload_bytes, device)
        finally:
            # free() is idempotent: chunks already freed after the
            # staging gather are no-ops; an exception mid-fetch frees
            # the rest
            for r in chunks:
                r.free()
            self.fetcher.close()


def _split_rows(flat, row_payload_bytes: int, device):
    """``(keys int32[N, 2], payload uint8[N, W])`` of the flat row bytes
    ``flat`` (a u8 tensor on ``device``), once every queued copy into it
    has completed."""
    import torch

    rows = flat.view(-1, 8 + row_payload_bytes)
    keys = rows[:, :8].contiguous().view(torch.int32)
    payload = rows[:, 8:].contiguous()
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return keys, payload


def _gather(chunks: Iterable, row_bytes: int, out):
    """Every chunk's bytes, in order, into ``out``, a u8 host array or
    CPU tensor of exactly their total length: the staging's one
    materialization. Raises ``ValueError`` for a chunk that does not hold
    whole rows, as ``decode_rows`` does. Returns ``out``."""
    parts = [np.frombuffer(c, dtype=np.uint8) for c in chunks]
    for part in parts:
        if len(part) % row_bytes:
            raise ValueError(f"byte length {len(part)} not a multiple of "
                             f"row size {row_bytes}")
    buf = np.asarray(out)  # a tensor's memory, shared
    pos = 0
    for part in parts:
        buf[pos:pos + len(part)] = part
        pos += len(part)
    return out


def read_to_device(chunks: Iterable, row_payload_bytes: int,
                   device: Optional[Union[str, "torch.device"]] = None):
    """Stage fetched ``key | payload`` row bytes on ``device`` (``cuda``
    unless the caller asks for another; with no card and no request this
    raises).

    ``chunks`` are bytes-like blocks of whole rows (``bytes``,
    ``bytearray``, ``memoryview`` or a u8 array), for example a
    resolver's ``local_blocks``. They are gathered into one pinned host
    buffer, which goes up in ONE ``non_blocking`` copy; keys and payload
    are split on the card, and the copy is waited for before returning,
    so the caller may free or reuse the chunks at once.

    Returns ``(keys int32[N, 2], payload uint8[N, W])`` on the device:
    each key as its (lo, hi) u32 words in int32 bits (``utils.u32``), the
    JAX method's ``u32[N, 2]``. Empty input gives ``[0, 2]`` and
    ``[0, W]``."""
    import torch

    from sparkrdma_tpu_torch.parallel.mesh import resolve_device

    device = resolve_device(device)
    parts = [np.frombuffer(c, dtype=np.uint8) for c in chunks]
    total = sum(len(p) for p in parts)
    if total == 0:
        return (torch.zeros((0, 2), dtype=torch.int32, device=device),
                torch.zeros((0, row_payload_bytes), dtype=torch.uint8,
                            device=device))
    host = _gather(parts, 8 + row_payload_bytes,
                   torch.empty(total, dtype=torch.uint8,
                               pin_memory=device.type == "cuda"))
    return _split_rows(host.to(device, non_blocking=True),
                       row_payload_bytes, device)


def _donated(views, row_payload_bytes: int, device=None):
    """The lease-donation branch: each view (a u8 array of whole rows in
    pool-lease memory) is copied to ``device`` as it lies, with no host
    gather, and the rows are joined there. Returns when every copy has
    completed, so the caller may free the leases then."""
    import torch

    from sparkrdma_tpu_torch.parallel.mesh import resolve_device

    device = resolve_device(device)
    parts = [torch.from_numpy(np.asarray(v, dtype=np.uint8).reshape(-1))
             .to(device, non_blocking=True, copy=True) for v in views]
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    return _split_rows(flat, row_payload_bytes, device)
