"""Mesh shuffle service: committed map outputs reduced on the card.

Port of ``sparkrdma_tpu/shuffle/mesh_service.py`` over the virtual mesh
(``parallel.mesh``): a ``VirtualMesh`` takes the place of ``(mesh,
axis_name)``, so no entry point takes ``axis_name``. Committed map
outputs (the writer's ``key | payload`` rows, served by each executor's
resolver) are staged into the card's memory, ONE exchange redistributes
every row to its reduce partition's owner shard, and the reduce-side sort
runs there. The host's only data-plane job is streaming the committed
bytes up; the per-(map, reduce) scatter happens on the mesh.

Partition -> shard placement: partition ``p`` is owned by shard
``p % D`` (the hierarchical reduce may place it elsewhere). Results are
numpy, as in the JAX package: per shard ``(keys u64[*], payload u8[*,
W], partition_ids i64[*])``.

Managers are duck-typed: each is read only for its ``resolver``
(``map_ids``, ``local_blocks``), and the handle only for ``shuffle_id``,
``num_partitions``, ``row_payload_bytes`` and ``partitioner.build``, so
the port's managers (``shuffle.manager``, what the engine's mesh mode
stages from) and the JAX package's serve alike. The fused and
hierarchical reduces record their host staging on
``tracer`` (``mesh.decode``: reading and decoding committed outputs,
``mesh.pack``: ``_rows_to_u32``, ``mesh.partition``, ``mesh.unpack``),
beside the round driver's ``exchange.*`` spans.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from sparkrdma_tpu_torch.parallel import device_plane as device_plane_mod
from sparkrdma_tpu_torch.parallel import exchange as exchange_mod
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.shuffle.external import merge_runs
from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError, ReadMetrics
from sparkrdma_tpu_torch.shuffle.manager import ShuffleHandle
from sparkrdma_tpu_torch.shuffle.planner import slice_aligned_partition_map
from sparkrdma_tpu_torch.shuffle.writer import decode_rows
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.integrity import CorruptOutputError

Result = Tuple[np.ndarray, np.ndarray, np.ndarray]


def device_row_words(payload_bytes: int) -> int:
    """u32 words per device row for a given payload width: key lo, key
    hi, then the padded payload words — THE row-layout formula, shared
    by the packers, the streamed reducers, and the engine's cost model
    (a layout change must move them all together)."""
    return 2 + (payload_bytes + 3) // 4


def _rows_to_u32(keys: np.ndarray, payload: np.ndarray) -> np.ndarray:
    """Pack (u64 keys, u8 payload) into the device row format:
    ``u32[N, 2 + ceil(W/4)]`` = key lo, key hi, payload words."""
    n = len(keys)
    pw = (payload.shape[1] + 3) // 4
    rows = np.zeros((n, 2 + pw), dtype=np.uint32)
    # ascontiguousarray: decode_rows hands out zero-copy strided key views
    rows[:, :2] = np.ascontiguousarray(keys).view(np.uint32).reshape(n, 2)
    if payload.shape[1]:
        padded = np.zeros((n, pw * 4), dtype=np.uint8)
        padded[:, :payload.shape[1]] = payload
        rows[:, 2:] = padded.view(np.uint32).reshape(n, pw)
    return rows


def _u32_to_rows(rows: np.ndarray, payload_bytes: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    if len(rows) == 0:
        return (np.zeros(0, dtype=np.uint64),
                np.zeros((0, payload_bytes), dtype=np.uint8))
    keys = rows[:, :2].copy().view(np.uint64).reshape(-1)
    payload = rows[:, 2:].copy().view(np.uint8).reshape(
        len(rows), -1)[:, :payload_bytes]
    return keys, payload


def _unpacked(per_device: Sequence[np.ndarray], handle: ShuffleHandle,
              partitioner, tracer) -> List[Result]:
    """Per-shard device rows (already key-sorted) as result triples."""
    results = []
    with tracer.span("mesh.unpack", "mesh"):
        for rows in per_device:
            k, p = _u32_to_rows(rows, handle.row_payload_bytes)
            results.append((k, p, np.asarray(partitioner(k),
                                             dtype=np.int64)))
    return results


def _exchanged(received, counts, overflowed, message: str
               ) -> List[np.ndarray]:
    """Each shard's received rows ``u32[total_d, W]`` brought home from an
    exchange's results; raises ``OverflowError`` on a receive overflow."""
    if bool(overflowed.any()):
        raise OverflowError(message)
    totals = counts.sum(dim=1).tolist()
    return [received[d, :total].cpu().numpy().view(np.uint32)
            for d, total in enumerate(totals)]


def run_mesh_reduce(managers: Sequence, handle: ShuffleHandle,
                    mesh: VirtualMesh, impl: str = "auto",
                    sort_by_key: bool = True, out_factor: int = 2,
                    expect_maps: Optional[int] = None,
                    ) -> List[Result]:
    """Reduce every partition of ``handle`` on the mesh.

    ``managers``: the executor managers whose resolvers hold the committed
    map outputs (one process, many executor roles, one mesh).

    ``out_factor``: receive headroom per shard relative to the balanced
    share (``total/D``); skew beyond it raises OverflowError — chunk with
    ``parallel.exchange.chunked_exchange`` for unbounded skew.

    Returns, per shard ``d``: ``(keys u64[*], payload u8[*, W],
    partition_ids i64[*])`` for the partitions ``{p : p % D == d}``, rows
    key-sorted within the shard when ``sort_by_key``.
    """
    n_dev = mesh.num_shards
    partitioner = handle.partitioner.build(handle.num_partitions)

    keys, payload = _stage_all(managers, handle, expect_maps)
    rows = _rows_to_u32(keys, payload)
    dest_part = np.asarray(partitioner(keys), dtype=np.int32)

    # pad to a shard-divisible static capacity with headroom for skew
    cap = max(1, -(-len(rows) // n_dev))
    total_cap = cap * n_dev
    rows_p = np.zeros((total_cap, rows.shape[1]), dtype=np.uint32)
    rows_p[:len(rows)] = rows
    dest_p = np.full(total_cap, -1, dtype=np.int32)
    dest_p[:len(rows)] = dest_part % n_dev  # partition owner shard

    # the one shared exchange (parallel/exchange.py)
    exchange = exchange_mod.make_shuffle_exchange(mesh, impl=impl,
                                                  out_factor=out_factor)
    received, counts, _, overflowed = exchange(
        device_plane_mod.stage_to_device(rows_p, mesh),
        device_plane_mod.stage_to_device(dest_p, mesh))
    exchange_mod.record_exchange(len(rows))

    out = []
    for got in _exchanged(received, counts, overflowed,
                          "mesh reduce receive overflow"):
        k, p = _u32_to_rows(got, handle.row_payload_bytes)
        parts = np.asarray(partitioner(k), dtype=np.int64)
        if sort_by_key:
            order = np.argsort(k, kind="stable")
            k, p, parts = k[order], p[order], parts[order]
        out.append((k, p, parts))
    return out


def run_mesh_reduce_fused(managers: Sequence, handle: ShuffleHandle,
                          mesh: VirtualMesh, impl: str = "auto",
                          rows_per_round: int = 0, out_factor: int = 2,
                          expect_maps: Optional[int] = None,
                          tracer=None) -> List[Result]:
    """``run_mesh_reduce`` on the FUSED device plane: one fused
    partition+exchange+local-sort step per round
    (``parallel.device_plane``), so between the staging upload and the
    result download partitions never leave the card: the reduce-side
    sort runs on the receiving shard, and rounds are double-buffered
    (round k+1 is queued while round k's results drain).

    ``rows_per_round`` bounds each round's per-shard rows (0 = one shot);
    the engine sizes it from the memory budget
    (``device_plane.auto_rows_per_round``). With rounds bounded, host
    staging is bounded too: committed outputs stream straight into round
    blocks (one round resident, plus the in-flight one). Raises
    ``OverflowError`` when skew beats the ``out_factor`` headroom; the
    engine degrades exactly this stage to the host dataplane. Same result
    contract as ``run_mesh_reduce`` with ``sort_by_key=True``.
    """
    tracer = tracer if tracer is not None else trace_mod.NULL
    n_dev = mesh.num_shards
    partitioner = handle.partitioner.build(handle.num_partitions)
    pw = device_row_words(handle.row_payload_bytes)

    if rows_per_round > 0:
        # bounded rounds: stream committed outputs straight into blocks
        def round_blocks():
            pending_r: List[np.ndarray] = []
            pending_d: List[np.ndarray] = []
            pending = 0
            per_round = rows_per_round * n_dev
            delivered: set = set()
            for k, p in _spanned(_iter_committed_batches(
                    managers, handle, delivered), tracer, "mesh.decode"):
                with tracer.span("mesh.pack", "mesh"):
                    rows = _rows_to_u32(k, p)
                with tracer.span("mesh.partition", "mesh"):
                    dest = (np.asarray(partitioner(k), dtype=np.int32)
                            % n_dev)
                while len(rows):
                    take = min(len(rows), per_round - pending)
                    pending_r.append(rows[:take])
                    pending_d.append(dest[:take])
                    pending += take
                    rows, dest = rows[take:], dest[take:]
                    if pending == per_round:
                        yield (np.concatenate(pending_r),
                               np.concatenate(pending_d))
                        pending_r, pending_d, pending = [], [], 0
            _check_staging_complete(delivered, expect_maps,
                                    handle.shuffle_id)
            if pending:
                yield np.concatenate(pending_r), np.concatenate(pending_d)

        per_device, _rounds = device_plane_mod.run_fused_exchange_rounds(
            mesh, round_blocks(), pw, rows_per_round, key_words=2,
            out_factor=out_factor, impl=impl, tracer=tracer)
    else:
        # one shot: the cost model only picks this when the stage fits
        # the budget, so whole-stage staging is within contract
        with tracer.span("mesh.decode", "mesh"):
            keys, payload = _stage_all(managers, handle, expect_maps)
        with tracer.span("mesh.pack", "mesh"):
            rows = _rows_to_u32(keys, payload)
        with tracer.span("mesh.partition", "mesh"):
            dest = (np.asarray(partitioner(keys), dtype=np.int32) % n_dev)
        per_device, _rounds = device_plane_mod.run_fused_exchange(
            mesh, rows, dest, key_words=2, out_factor=out_factor,
            impl=impl, tracer=tracer)

    # rows arrive key-sorted per shard already
    return _unpacked(per_device, handle, partitioner, tracer)


def run_mesh_reduce_hier(managers: Sequence, handle: ShuffleHandle,
                         mesh: VirtualMesh, topology, impl: str = "auto",
                         rows_per_round: int = 0, out_factor: int = 2,
                         expect_maps: Optional[int] = None, tracer=None,
                         partition_map: Optional[np.ndarray] = None,
                         ) -> List[Result]:
    """``run_mesh_reduce_fused`` over a MULTI-SLICE topology: the fused
    step runs per slice over its sub-mesh (the bulk bytes), and only the
    slice-crossing residue rides the slow link, composed as the factored
    two-phase redistribution (``device_plane.run_hierarchical_exchange``).

    Each staged batch's HOME slice is its staging manager's slot mapped
    through ``Topology.slice_of_slot``. ``partition_map`` is the
    link-cost-aware partition->shard layout (``i32[P]``); None derives the
    slice-aligned map from the staged per-slice byte histogram
    (``planner.slice_aligned_partition_map``), so cross-slice bytes are
    minimized by construction. Same result contract as
    ``run_mesh_reduce_fused`` (per-shard key-sorted rows; a different
    layout moves only WHICH shard serves a partition, never its bytes).

    Staging is WHOLE-STAGE (the one-shot fused path's contract);
    ``rows_per_round`` bounds the per-slice DEVICE rounds.
    """
    tracer = tracer if tracer is not None else trace_mod.NULL
    n_dev = mesh.num_shards
    partitioner = handle.partitioner.build(handle.num_partitions)
    row_bytes = 4 * device_row_words(handle.row_payload_bytes)
    num_mgrs = max(1, len(managers))

    all_rows, all_parts, all_home = [], [], []
    part_bytes = np.zeros((topology.num_slices, handle.num_partitions),
                          dtype=np.int64)
    delivered: set = set()
    for i, k, p in _spanned(_iter_committed_batches_indexed(
            managers, handle, delivered), tracer, "mesh.decode"):
        home = topology.slice_of_slot(i, num_mgrs)
        with tracer.span("mesh.partition", "mesh"):
            parts = np.asarray(partitioner(k), dtype=np.int64)
            np.add.at(part_bytes[home], parts, row_bytes)
        with tracer.span("mesh.pack", "mesh"):
            all_rows.append(_rows_to_u32(k, p))
        all_parts.append(parts)
        all_home.append(np.full(len(k), home, dtype=np.int32))
    _check_staging_complete(delivered, expect_maps, handle.shuffle_id)
    if not all_rows:
        rows = np.zeros((0, device_row_words(handle.row_payload_bytes)),
                        np.uint32)
        parts = np.zeros(0, np.int64)
        home = np.zeros(0, np.int32)
    else:
        rows = np.concatenate(all_rows)
        parts = np.concatenate(all_parts)
        home = np.concatenate(all_home)

    if partition_map is None:
        partition_map = slice_aligned_partition_map(part_bytes, topology,
                                                    n_dev)
    dest = partition_map[parts].astype(np.int32) if len(parts) else \
        np.zeros(0, np.int32)

    per_device, _rounds = device_plane_mod.run_hierarchical_exchange(
        mesh, topology, rows, dest, home, key_words=2,
        rows_per_round=rows_per_round, out_factor=out_factor, impl=impl,
        tracer=tracer)
    return _unpacked(per_device, handle, partitioner, tracer)


def _spanned(batches, tracer, name: str):
    """``batches`` with the work of producing each one (for committed
    outputs: the resolver's read and the decode) under a ``name`` span."""
    it = iter(batches)
    while True:
        with tracer.span(name, "mesh"):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def _stage_all(managers, handle, expect_maps: Optional[int]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Stage every committed local output into one (keys, payload) pair:
    streamed sequentially (no host scatter) through the resolver's
    serving API, with the completeness check. Shared by the one-shot
    reduces; the bounded-round paths stream instead."""
    all_keys, all_payloads = [], []
    delivered: set = set()
    for k, p in _iter_committed_batches(managers, handle, delivered):
        all_keys.append(k)
        all_payloads.append(p)
    _check_staging_complete(delivered, expect_maps, handle.shuffle_id)
    keys = (np.concatenate(all_keys) if all_keys
            else np.zeros(0, dtype=np.uint64))
    payload = (np.concatenate(all_payloads) if all_payloads
               else np.zeros((0, handle.row_payload_bytes), dtype=np.uint8))
    return keys, payload


def _iter_committed_batches(managers, handle, delivered: Optional[set] = None):
    """Decoded (keys, payload) batches of every committed local output —
    ``_iter_committed_batches_indexed`` minus the staging-manager index
    (the flat reduces don't care which executor held a map; the
    hierarchical reduce does — the index names the home slice)."""
    for _, k, p in _iter_committed_batches_indexed(managers, handle,
                                                   delivered):
        yield k, p


def _iter_committed_batches_indexed(managers, handle,
                                    delivered: Optional[set] = None):
    """Decoded (manager_index, keys, payload) batches of every committed
    local output — THE staging hook: every mesh reduce driver (one-shot,
    streamed, fused, hierarchical) stages through this one generator.

    Each map id is taken from the FIRST resolver holding it: stage retry
    and speculation can leave identical copies of one map output on two
    live executors, and a reduce must consume exactly one. ``delivered``
    (when given) records the map ids actually read, so callers can detect
    outputs disposed mid-staging instead of silently reducing a partial
    dataset.
    """
    seen: set = set()
    for i, mgr in enumerate(managers):
        if mgr.resolver is None:
            continue
        for m in mgr.resolver.map_ids(handle.shuffle_id):
            if m in seen:
                continue
            try:
                raw = mgr.resolver.local_blocks(handle.shuffle_id, m, 0,
                                                handle.num_partitions)
            except (CorruptOutputError, OSError):
                raw = None  # corrupt/unreadable: same as disposed below
            if raw is None:
                continue  # disposed between map_ids() and the read;
                # another manager may still hold a copy — completeness is
                # the caller's expect_maps check
            seen.add(m)
            if delivered is not None:
                delivered.add(m)
            yield (i,) + decode_rows(raw, handle.row_payload_bytes)


def _check_staging_complete(delivered: set, expect_maps: Optional[int],
                            shuffle_id: int) -> None:
    """Raise FetchFailedError for the first map output that went missing
    during staging (disposed under a dying executor) — the mesh-mode
    analogue of a failed remote fetch; the engine's stage retry recomputes
    it (scala/RdmaShuffleFetcherIterator.scala:376-381)."""
    if expect_maps is None:
        return
    missing = sorted(set(range(expect_maps)) - delivered)
    if missing:
        raise FetchFailedError(
            shuffle_id, missing[0], -1,
            "map output disposed during mesh staging")


def run_mesh_reduce_streamed(managers: Sequence, handle: ShuffleHandle,
                             mesh: VirtualMesh, impl: str = "auto",
                             rows_per_round: int = 1 << 18,
                             out_factor: int = 2,
                             expect_maps: Optional[int] = None,
                             pipeline_rounds: bool = True,
                             ) -> List[Result]:
    """``run_mesh_reduce`` for datasets beyond one exchange's device (or
    host staging) budget: committed outputs stream through the SAME
    exchange in bounded rounds of ``rows_per_round`` rows per shard —
    device memory is static per round, host staging holds one round — and
    each shard's key-sorted round outputs merge O(N log R) via the
    tournament merge (``shuffle/external.py``). Same contract as
    ``run_mesh_reduce`` with ``sort_by_key=True``.

    ``pipeline_rounds``: double-buffer — round r+1 is decoded, padded and
    QUEUED on the card before round r's results are pulled back and
    unpacked, so host staging overlaps the device exchange.
    """
    n_dev = mesh.num_shards
    partitioner = handle.partitioner.build(handle.num_partitions)
    pw = device_row_words(handle.row_payload_bytes)
    cap = rows_per_round
    # the one shared exchange, for the round shape
    exchange = exchange_mod.make_shuffle_exchange(mesh, impl=impl,
                                                  out_factor=out_factor)

    runs: List[list] = [[] for _ in range(n_dev)]

    def dispatch(rows_np: np.ndarray):
        """Stage one round and queue its exchange; no blocking."""
        dest = (np.asarray(partitioner(
            rows_np[:, :2].copy().view(np.uint64).reshape(-1)),
            dtype=np.int32) % n_dev)
        total_cap = cap * n_dev
        rows_p = np.zeros((total_cap, pw), np.uint32)
        rows_p[:len(rows_np)] = rows_np
        dest_p = np.full(total_cap, -1, np.int32)
        dest_p[:len(rows_np)] = dest
        exchange_mod.record_exchange(len(rows_np))
        return exchange(device_plane_mod.stage_to_device(rows_p, mesh),
                        device_plane_mod.stage_to_device(dest_p, mesh))

    def collect(results) -> None:
        # bringing the rows home waits for the card
        received, counts, _, overflowed = results
        got_all = _exchanged(received, counts, overflowed,
                             "mesh reduce receive overflow; raise "
                             "out_factor or shrink rows_per_round")
        for d, got in enumerate(got_all):
            keys = got[:, :2].copy().view(np.uint64).reshape(-1)
            runs[d].append(got[np.argsort(keys, kind="stable")])

    def round_chunks():
        """Yield round-sized row blocks streamed off the committed outputs
        (plus the completeness check once staging is exhausted)."""
        pending: List[np.ndarray] = []
        pending_rows = 0
        per_round = cap * n_dev
        delivered: set = set()
        for k, p in _iter_committed_batches(managers, handle, delivered):
            rows = _rows_to_u32(k, p)
            while len(rows):
                take = min(len(rows), per_round - pending_rows)
                pending.append(rows[:take])
                pending_rows += take
                rows = rows[take:]
                if pending_rows == per_round:
                    yield np.concatenate(pending)
                    pending, pending_rows = [], 0
        _check_staging_complete(delivered, expect_maps, handle.shuffle_id)
        if pending_rows:
            yield np.concatenate(pending)

    if pipeline_rounds:
        # round r's exchange runs on the card while round r+1 stages on
        # the host (decode + pad + partition) — one round in flight
        in_flight = None
        for chunk in round_chunks():
            nxt = dispatch(chunk)
            if in_flight is not None:
                collect(in_flight)
            in_flight = nxt
        if in_flight is not None:
            collect(in_flight)
    else:
        for chunk in round_chunks():
            collect(dispatch(chunk))

    results = []
    for d in range(n_dev):
        if runs[d]:
            _, merged = merge_runs([(r[:, :2].copy().view(np.uint64)
                                     .reshape(-1), r) for r in runs[d]])
        else:
            merged = np.zeros((0, pw), np.uint32)
        keys, payload = _u32_to_rows(merged, handle.row_payload_bytes)
        parts = np.asarray(partitioner(keys), dtype=np.int64)
        results.append((keys, payload, parts))
    return results


def split_by_partition(results, num_partitions: int, row_payload_bytes: int
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Re-index a mesh reduce's per-SHARD results as per-PARTITION
    ``(keys, payload)`` — the unit the engine's reduce tasks consume
    (task ``t`` reads partition ``t``). Within-partition key order is
    preserved from the shard results (sorted when the reduce sorted)."""
    per: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * num_partitions
    for k, p, parts in results:
        for pid in np.unique(parts):
            m = parts == pid
            per[int(pid)] = (k[m], p[m])
    empty = (np.zeros(0, dtype=np.uint64),
             np.zeros((0, row_payload_bytes), dtype=np.uint8))
    return [e if e is not None else empty for e in per]


class CachedPartitionReader:
    """Reader over a partition range served from mesh-reduce results.

    This is what the engine hands a task in mesh mode: the same surface as
    ``TpuShuffleReader`` (``read`` yields batches; ``read_all`` /
    ``read_sorted`` / ``read_sorted_spilled``; ``metrics``), but every byte
    arrived over the mesh exchange — the ``metrics`` show local serving
    only, never remote fetches.
    """

    def __init__(self, per_partition: Sequence[Tuple[np.ndarray, np.ndarray]],
                 start_partition: int, end_partition: int,
                 row_payload_bytes: int):
        self._parts = per_partition
        self._range = range(start_partition, end_partition)
        self.row_payload_bytes = row_payload_bytes
        self.metrics = ReadMetrics()

    def read(self):
        for p in self._range:
            keys, payload = self._parts[p]
            if len(keys):
                self.metrics.record_local(
                    len(keys) * (8 + self.row_payload_bytes))
                yield keys, payload

    def read_all(self) -> Tuple[np.ndarray, np.ndarray]:
        ks, ps = [], []
        for k, p in self.read():
            ks.append(k)
            ps.append(p)
        if not ks:
            return (np.zeros(0, dtype=np.uint64),
                    np.zeros((0, self.row_payload_bytes), dtype=np.uint8))
        return np.concatenate(ks), np.concatenate(ps)

    def read_sorted(self) -> Tuple[np.ndarray, np.ndarray]:
        keys, payload = self.read_all()
        order = np.argsort(keys, kind="stable")
        return keys[order], payload[order]

    def read_aggregated(self, combine) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized sorted-run reduction (TpuShuffleReader parity).
        Combiners never see zero rows — the writer-side contract holds on
        the read side."""
        keys, payload = self.read_sorted()
        if not len(keys):
            return keys, payload
        return combine(keys, payload)

    def read_sorted_spilled(self, memory_budget_bytes: int = 64 << 20,
                            spill_dir: Optional[str] = None):
        # data is already resident (mesh results live on the driver); the
        # bounded-memory contract is about FETCH buffering, which the
        # exchange already did — serve the sorted view in one batch
        keys, payload = self.read_sorted()
        if len(keys):
            yield keys, payload
