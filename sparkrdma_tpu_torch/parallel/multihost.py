"""Multi-process deployment: the exchange over a global (cross-process) mesh.

Port of ``sparkrdma_tpu/parallel/multihost.py``. The reference scales
multi-node by giving every executor a verbs endpoint and letting the NICs
carry the M×R traffic (java/RdmaNode.java; README.md:11-31). The JAX
package's equivalent is a ``jax.sharding.Mesh`` spanning processes; the
port's is a ``parallel.mesh.GlobalMesh`` over a ``torch.distributed``
group:

* **control plane**: a gloo group carries the metadata all-gathers, the
  barriers and the CUDA IPC handles;
* **data plane**: the exchange of ``parallel.exchange`` over the global
  mesh. On ``cuda`` its ``native`` transport (``auto``, as in the JAX
  package) launches the ragged all-to-all kernel's range form over each
  process's own shards, writing each pair's rows once through CUDA IPC
  peer pointers into the receiving process's arena, so rows stay on the
  card; ``ring`` does the same with the ring kernel and per-pair slots;
  the same code runs across the cards of one node. ``dense`` and
  ``gather`` use the process group's collectives and need a group whose
  backend takes the mesh's tensors (gloo on the CPU, NCCL with one card
  per rank).

For tests and for one card, several processes share a device: each holds
``local_device_count`` virtual shards of it.
"""

from __future__ import annotations

import datetime
import logging
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.ops.ring_exchange import PeerArena
from sparkrdma_tpu_torch.parallel.mesh import GlobalMesh, resolve_device

log = logging.getLogger(__name__)

PLATFORMS = ("cuda", "cpu")
_MESH: Optional[GlobalMesh] = None


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   local_device_count: Optional[int] = None,
                   platform: Optional[str] = None,
                   timeout: Optional[float] = None) -> None:
    """Join the process group and build this process's ``GlobalMesh``.
    Every process calls it once, with the same ``coordinator_address``
    (``host:port`` or a ``tcp://`` URL; process 0 listens there).

    ``local_device_count`` is the number of virtual shards this process
    holds (default 1), the same in every process. ``platform`` is
    ``"cuda"`` (the default; raises without a card) or ``"cpu"``. On
    ``cuda`` the process takes card ``process_id % device_count``; where
    every rank has a card of its own, an NCCL group joins the gloo
    control group as the data group of the collective transports.

    ``timeout`` (seconds) bounds every collective of both groups, the
    joining included: a peer that died or stopped answering raises after
    it rather than after torch's 30 minutes. On any failure here the
    process leaves the group, so a later call can build a mesh again."""
    global _MESH
    if _MESH is not None:
        raise RuntimeError("init_multihost was already called")
    platform = platform or "cuda"
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")
    local = int(local_device_count or 1)
    if local < 1:
        raise ValueError(f"local_device_count must be >= 1, got {local}")
    device = resolve_device(platform)
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    bound = ({} if timeout is None
             else {"timeout": datetime.timedelta(seconds=timeout)})
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id,
                            **bound)
    try:
        group = dist.group.WORLD
        peers = [None] * num_processes
        dist.all_gather_object(peers, (local, socket.gethostname(),
                                       str(device)), group=group)
        if len({p[0] for p in peers}) != 1:
            raise ValueError(f"every process must hold the same number of "
                             f"shards, got {[p[0] for p in peers]}")
        data_group = None
        if device.type == "cpu":
            data_group = group
        elif len({(host, dev) for _, host, dev in peers}) == num_processes:
            # one card per rank: NCCL can form the collectives' group
            data_group = dist.new_group(backend="nccl", **bound)
    except BaseException:
        dist.destroy_process_group()
        raise
    arena = (PeerArena(group, process_id, num_processes, device)
             if device.type == "cuda" else None)
    _MESH = GlobalMesh(num_processes, local, process_id, device, group,
                       data_group, arena)


def shutdown_multihost() -> None:
    """Release the receive arena and leave the process group
    (collective). The process leaves the group even where a peer is gone
    and the closing barrier raises, so ``init_multihost`` can build a new
    mesh after it."""
    global _MESH
    mesh, _MESH = _MESH, None
    if mesh is None:
        return
    try:
        if mesh.arena is not None:
            mesh.arena.close()
        dist.barrier(group=mesh.group)
    finally:
        dist.destroy_process_group()


def _mesh() -> GlobalMesh:
    if _MESH is None:
        raise RuntimeError("call init_multihost first")
    return _MESH


def process_index() -> int:
    """This process's rank (``jax.process_index()``)."""
    return _mesh().rank


def process_count() -> int:
    """The number of processes (``jax.process_count()``)."""
    return _mesh().num_processes


def global_mesh(axis_name: str = "shuffle") -> GlobalMesh:
    """The mesh over every shard of every process. ``axis_name`` is kept
    for the JAX signature; the port's mesh has one axis and no names."""
    return _mesh()


def shard_local_rows(mesh: GlobalMesh, axis_name: str,
                     local_rows: np.ndarray, global_rows: int
                     ) -> torch.Tensor:
    """This process's rows ``[Dl*n, ...]`` as its shards ``[Dl, n, ...]``
    on the mesh's device, where ``global_rows = G*n`` (JAX assembles the
    global sharded array; the port keeps the local part). 4-byte words
    become int32 words (``utils.u32``); other dtypes stay."""
    local_rows = np.ascontiguousarray(local_rows)
    if local_rows.shape[0] * mesh.num_processes != global_rows:
        raise ValueError(f"{local_rows.shape[0]} local rows of "
                         f"{global_rows} over {mesh.num_processes} "
                         "processes")
    if local_rows.dtype in (np.uint32, np.int32):
        local_rows = local_rows.view(np.int32)
    dl = mesh.local_shards
    return torch.from_numpy(local_rows).reshape(
        (dl, local_rows.shape[0] // dl) + local_rows.shape[1:]).to(
            mesh.device)


def _local_counts(dest_p: np.ndarray, shards: int, cap: int,
                  n_global: int) -> np.ndarray:
    """``[Dl, G]`` rows each local shard sends to each global shard; local
    shard d holds ``dest_p[d*cap:(d+1)*cap]`` (-1 = padding)."""
    counts = np.zeros((shards, n_global), dtype=np.int64)
    for d in range(shards):
        seg = dest_p[d * cap:(d + 1) * cap]
        counts[d] = np.bincount(seg[seg >= 0], minlength=n_global)
    return counts


def run_multihost_mesh_reduce(managers: Sequence, handle, mesh: GlobalMesh,
                              axis_name: str = "shuffle",
                              impl: str = "auto", out_factor: int = 2,
                              sort_by_key: bool = True,
                              rows_per_round: int = 0):
    """Cross-process mesh reduce: committed spills on N processes -> ONE
    global-mesh exchange, the reference's whole multi-node pipeline
    (README.md:11-31). Collective: every process calls it.

    Each process stages the spills its LOCAL executors own according to
    the driver table (table-owner-wins, so a map recomputed or speculated
    onto another process stages once), one host all-gather agrees on the
    global shapes and checks that every map was staged, and the exchange
    redistributes rows to their partition's owner shard.

    ``managers``: this process's executor-role ``TpuShuffleManager`` s.
    Returns, per local shard, ``(keys u64[*], payload u8[*, W],
    partition_ids i64[*])``, stably key-sorted when ``sort_by_key``.

    ``rows_per_round > 0`` bounds device memory: R rounds of at most
    ``rows_per_round`` rows per shard, R agreed from the same all-gather.
    Each round's ``[G, G]`` count matrix is counted on the host and
    all-gathered once for all rounds, so the exchange waits on no device
    counts."""
    from sparkrdma_tpu_torch.parallel import exchange as exchange_mod
    from sparkrdma_tpu_torch.parallel import topology as topology_mod
    from sparkrdma_tpu_torch.shuffle.mesh_service import (
        _rows_to_u32,
        _u32_to_rows,
        device_row_words,
    )
    from sparkrdma_tpu_torch.shuffle.writer import decode_rows
    from sparkrdma_tpu_torch.utils.integrity import CorruptOutputError
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

    n_global = mesh.num_shards
    n_local = mesh.local_shards
    partitioner = handle.partitioner.build(handle.num_partitions)

    # 1. the driver table names each map's owner slot; stage local ones
    endpoint_mgr = next((m for m in managers if m.executor is not None),
                        None)
    if endpoint_mgr is None:
        # failing BEFORE the collective: a silent StopIteration here would
        # leave every peer hung in the all-gather
        raise ValueError("managers must include at least one executor role")
    table = endpoint_mgr.executor.get_driver_table(
        handle.shuffle_id, expect_published=handle.num_maps)
    # exec_index with a wait budget: the hello/announce is async, and a
    # KeyError here would kill this process before the collective and
    # strand every peer in the all-gather
    by_slot = {m.executor.exec_index(timeout=5): m for m in managers
               if m.executor is not None and m.resolver is not None}
    all_keys, all_payloads = [], []
    staged = np.zeros(handle.num_maps, dtype=np.int64)
    for m in range(handle.num_maps):
        entry = table.entry(m)
        if entry is None:
            raise RuntimeError(f"map {m} unpublished in driver table")
        owner = by_slot.get(entry[1])
        if owner is None:
            continue  # another process's map (checked globally below)
        try:
            raw = owner.resolver.local_blocks(handle.shuffle_id, m, 0,
                                              handle.num_partitions)
        except (CorruptOutputError, OSError) as e:
            # corrupt/unreadable at staging time: unstaged, so the
            # consistent completeness check below owns the failure on
            # every process
            raw = None
            log.warning("map %d unreadable at staging time (%s); leaving "
                        "unstaged", m, e)
        if raw is None:
            # disposed mid-staging: the POST-all-gather completeness check
            # raises the retryable FetchFailedError on EVERY process;
            # raising here would strand the peers in the collective
            continue
        k, p = decode_rows(raw, handle.row_payload_bytes)
        staged[m] = 1
        all_keys.append(k)
        all_payloads.append(p)
    keys = (np.concatenate(all_keys) if all_keys
            else np.zeros(0, dtype=np.uint64))
    payload = (np.concatenate(all_payloads) if all_payloads
               else np.zeros((0, handle.row_payload_bytes), dtype=np.uint8))
    rows = _rows_to_u32(keys, payload)
    dest = np.asarray(partitioner(keys), dtype=np.int32) % n_global

    # cross-slice accounting: each process is a slice of the topology
    # (its shards carry their process_index), so the bytes this process
    # sends to another process's shards are its cross-slice bytes
    topo = topology_mod.detect_topology(mesh)
    if not topo.is_flat and len(dest):
        dev_slice = topo.device_slices()
        crossing = int((dev_slice[dest] != dev_slice[mesh.first_shard]).sum())
        if crossing:
            topology_mod.record_cross_slice(crossing * rows.shape[1] * 4)

    # 2. one host all-gather carries the cross-process metadata: per
    # process (row total, shard count) for capacity agreement, plus the
    # staged-map bitmap for global completeness
    meta = exchange_mod.allgather_host(mesh, np.concatenate(
        [np.array([len(rows), n_local], dtype=np.int64), staged]))
    meta = meta.reshape(-1, 2 + handle.num_maps)
    cap = max(1, int(max(-(-int(r) // max(1, int(nl)))
                         for r, nl in meta[:, :2])))
    rounds = 1
    round_order = None
    if rows_per_round > 0 and cap > rows_per_round:
        # bounded rounds, derived on every process from the shared
        # metadata. Staged rows are key-sorted per map, so contiguous
        # slices would concentrate a round on few destinations: spread
        # each destination's rows evenly across rounds instead (monotone
        # within a destination, so per-destination order is kept) and
        # pad cap by the ±1-per-destination rounding
        rounds = -(-cap // rows_per_round)
        counts_d = np.bincount(dest, minlength=n_global) \
            if len(dest) else np.zeros(n_global, np.int64)
        grouped = np.argsort(dest, kind="stable") if len(dest) else \
            np.zeros(0, np.int64)
        starts = np.r_[0, np.cumsum(counts_d)[:-1]]
        within = (np.arange(len(grouped), dtype=np.int64)
                  - np.repeat(starts, counts_d))
        m_rep = np.repeat(np.maximum(counts_d, 1), counts_d)
        round_of = (within * rounds) // m_rep
        round_order = [grouped[round_of == r] for r in range(rounds)]
        # the pad comes from the ALL-GATHERED shard counts, so every
        # process computes the same shapes
        min_nl = max(1, int(meta[:, 1].min()))
        cap = rows_per_round + -(-n_global // min_nl)
    staged_global = meta[:, 2:].sum(axis=0)
    unstaged = np.flatnonzero(staged_global == 0)
    if len(unstaged):
        from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError

        m = int(unstaged[0])
        entry = table.entry(m)
        raise FetchFailedError(
            handle.shuffle_id, m, entry[1] if entry else -1,
            "map output staged by no process (owner died, spill disposed "
            "mid-staging, or its managers not passed in) — raised on all "
            "processes; recompute and re-enter collectively")

    width = device_row_words(handle.row_payload_bytes)
    per_round = n_local * cap
    chunks = []
    for r in range(rounds):
        if round_order is not None:
            idx = round_order[r]
            if len(idx) > per_round:  # ±1-per-dest rounding blew the pad
                raise OverflowError(
                    f"round {r} holds {len(idx)} rows > send budget "
                    f"{per_round}; raise rows_per_round")
            chunk, cdest = rows[idx], dest[idx]
        else:
            chunk = rows[r * per_round:(r + 1) * per_round]
            cdest = dest[r * per_round:(r + 1) * per_round]
        dest_p = np.full(per_round, -1, dtype=np.int32)
        dest_p[:len(chunk)] = cdest
        chunks.append((chunk, dest_p))
    # 3. every round's count matrix, counted on the host, in one gather
    local_counts = np.stack([_local_counts(dp, n_local, cap, n_global)
                             for _, dp in chunks])     # [R, Dl, G]
    mats = exchange_mod.allgather_host(mesh, local_counts)  # [P, R, Dl, G]
    mats = mats.transpose(1, 0, 2, 3).reshape(rounds, n_global, n_global)
    out_cap = cap * out_factor
    for r in range(rounds):
        # a receive past the buffer is seen by every process in the
        # gathered matrix: raise group-wide, before the collective
        over = np.flatnonzero(mats[r].sum(axis=0) > out_cap)
        if len(over):
            raise OverflowError(
                f"multihost mesh reduce receive overflow (round {r}, "
                f"shards {over.tolist()}); raise out_factor or lower "
                "rows_per_round skew exposure")

    exchange = exchange_mod.make_shuffle_exchange(mesh, impl=impl,
                                                  out_factor=out_factor)
    local_view = mesh.local_view()
    lo = mesh.first_shard
    got_rows: list = [[] for _ in range(n_local)]
    for r, (chunk, dest_p) in enumerate(chunks):
        rows_p = np.zeros((per_round, width), dtype=np.uint32)
        rows_p[:len(chunk)] = chunk
        rows_d = rows_from_numpy(rows_p, local_view)
        dest_d = torch.from_numpy(dest_p.reshape(n_local, cap)).to(
            mesh.device)
        received, _, _, overflowed = exchange(rows_d, dest_d,
                                              counts_host=mats[r])
        if bool(overflowed.any()):
            raise OverflowError(
                "multihost mesh reduce receive overflow; raise "
                "out_factor or lower rows_per_round skew exposure")
        totals = mats[r][:, lo:lo + n_local].sum(axis=0)
        for i in range(n_local):
            got_rows[i].append(received[i, :int(totals[i])].cpu().numpy()
                               .view(np.uint32))
    exchange_mod.record_exchange(int(meta[:, 0].sum()))

    # 4. assemble this process's results across rounds
    results = []
    for segs in got_rows:
        allrows = (np.concatenate(segs) if segs
                   else np.zeros((0, width), np.uint32))
        k, p = _u32_to_rows(allrows, handle.row_payload_bytes)
        parts = np.asarray(partitioner(k), dtype=np.int64)
        if sort_by_key:
            order = np.argsort(k, kind="stable")
            k, p, parts = k[order], p[order], parts[order]
        results.append((k, p, parts))
    return results


def run_multihost_terasort(mesh: GlobalMesh, axis_name: str,
                           rows_per_device: int, payload_words: int = 4,
                           seed: int = 0, impl: str = "auto",
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """One TeraSort round over the global mesh; returns this process's
    sorted shards ``u32[Dl*out_cap, 1+P]`` and counts ``[Dl, G]``. Each
    process generates only its slice, from seed ``seed * 100_003 +
    rank``. Collective."""
    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig,
        generate_rows,
        make_terasort_step,
    )
    from sparkrdma_tpu_torch.utils.u32 import rows_to_numpy

    n_global = mesh.num_shards
    cfg = TeraSortConfig(rows_per_device=rows_per_device,
                         payload_words=payload_words, out_factor=2)
    local_slice = generate_rows(cfg, mesh.local_shards,
                                seed=seed * 100_003 + mesh.rank)
    rows = shard_local_rows(mesh, axis_name, local_slice,
                            n_global * rows_per_device)
    step = make_terasort_step(mesh, cfg, impl)
    out, counts, overflowed = step(rows)
    if bool(overflowed.any()):
        raise OverflowError("terasort receive overflow on this process")
    return rows_to_numpy(out), counts.cpu().numpy()
