"""Hierarchical-exchange microbench: the two-level dataplane against the
flat plan, on a virtual two-slice mesh.

Port of ``sparkrdma_tpu/shuffle/topo_bench.py``, name for name. A flat
all-to-all over a multi-slice mesh is lock-stepped on its slowest links:
EVERY byte of the collective effectively moves at the slow link's rate.
The hierarchical plan's point is that only the slice-crossing residue
pays that price; the intra-slice bulk stays on the fast link, an order
of magnitude faster.

Both plans ride the same shards of one card, so (as in ``fetch_bench``,
wire RTT, and ``device_bench``, serving delay) a modelled per-byte
slow-link cost stands in for the link gap: the FLAT side is charged the
modelled slow-link time for every byte it exchanges (the lockstep
pricing), the HIERARCHICAL side pays it only for the residue it actually
moves across the seam (charged through the ``topology.cross_slice_shim``
hook the runner already calls) plus the modelled fast-link time for its
intra-slice bulk. Both sides run in the SAME process back to back;
``identical`` is the byte-level gate (every partition's (key,
payload-rows) multiset must match exactly), and ``cross_slice_bytes``
must be STRICTLY lower on the hierarchical side: the link-cost-aware
partition layout (``planner.slice_aligned_partition_map``) guarantees it
by construction on slice-affine inputs.

Both drivers run with ``impl="gather"``, as the reference's do: library
ops on ``cuda``, so this bench launches no ring kernel. The mesh is a
keyword, ``mesh=None`` meaning ``VirtualMesh(8)`` on ``cuda`` (it raises
without a card); pass ``VirtualMesh(8, "cpu")`` to run on the CPU.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np


def _canon(rows: np.ndarray) -> np.ndarray:
    """Canonical multiset form of one partition's device rows: sorted by
    every column so equal-key row order (unspecified across plans) can't
    fail an exact comparison."""
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def _per_partition(per_device, num_partitions: int) -> list:
    """Regroup per-device row lists by reduce partition (key % P, the
    modulo partitioner both plans ran under), so plans with DIFFERENT
    partition->device layouts compare on the thing that must match."""
    parts = [[] for _ in range(num_partitions)]
    for rows in per_device:
        if not len(rows):
            continue
        keys = rows[:, :2].copy().view(np.uint64).reshape(-1)
        for p in np.unique(keys % num_partitions):
            parts[int(p)].append(rows[keys % num_partitions == p])
    return [np.concatenate(p) if p else np.zeros((0, 3), np.uint32)
            for p in parts]


def run_topo_microbench(num_slices: int = 2, rows_per_dev: int = 2048,
                        cost_ratio: float = 10.0, affinity: float = 0.8,
                        dcn_s_per_mb: float = 0.5, seed: int = 0,
                        reps: int = 2, mesh=None) -> Dict:
    """A/B the flat vs hierarchical plan on a virtual multi-slice mesh;
    returns::

        {"wall_s": {"flat": s, "hier": s}, "speedup": flat/hier,
         "identical": bool,
         "cross_slice_bytes": {"flat": n, "hier": n},
         "devices": D, "slices": S, "cost_ratio": r}

    ``affinity`` is the probability a row's destination partition is
    owned by its producing slice under the slice-aligned layout: the
    slice-affine shape the link-cost-aware planner produces on real
    jobs. ``cost_ratio`` is the modelled fast:slow link gap (~10:1).
    ``mesh`` defaults to ``VirtualMesh(8)`` on ``cuda``.
    """
    from sparkrdma_tpu_torch.parallel import topology as topology_mod
    from sparkrdma_tpu_torch.parallel.device_plane import (
        run_fused_exchange,
        run_hierarchical_exchange,
    )
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.shuffle.planner import (
        slice_aligned_partition_map,
    )

    mesh = VirtualMesh(8) if mesh is None else mesh
    n_dev = mesh.num_shards
    if n_dev < num_slices or n_dev % num_slices:
        # degenerate mesh (too few / indivisible shards): there is no
        # seam to exchange across; report the shape honestly instead of
        # a meaningless 1-shard "speedup"
        return {"wall_s": {"flat": 0.0, "hier": 0.0}, "speedup": 0.0,
                "identical": True,
                "cross_slice_bytes": {"flat": 0, "hier": 0},
                "devices": n_dev, "slices": 1, "cost_ratio": cost_ratio,
                "note": f"single-slice host: {n_dev} devices cannot "
                        f"form {num_slices} equal slices"}
    topo = topology_mod.Topology(
        tuple([n_dev // num_slices] * num_slices),
        ici_gbps=100.0 * cost_ratio / 10.0, dcn_gbps=10.0)
    num_partitions = n_dev * 2
    dcn_s_per_byte = dcn_s_per_mb / (1 << 20)
    ici_s_per_byte = dcn_s_per_byte / cost_ratio

    # slice-affine input: each home slice's rows mostly target its own
    # partition block (key % P IS the partition: modulo partitioner)
    rng = np.random.default_rng(seed)
    parts_per_slice = num_partitions // num_slices
    all_rows, all_home = [], []
    for s in range(num_slices):
        n_rows = rows_per_dev * topo.slice_sizes[s]
        local = rng.random(n_rows) < affinity
        part = np.where(
            local,
            s * parts_per_slice + rng.integers(0, parts_per_slice, n_rows),
            rng.integers(0, num_partitions, n_rows)).astype(np.uint64)
        keys = part + num_partitions * rng.integers(
            0, 1 << 20, n_rows, dtype=np.uint64)
        rows = np.zeros((n_rows, 3), np.uint32)
        rows[:, :2] = keys.view(np.uint32).reshape(n_rows, 2)
        rows[:, 2] = rng.integers(0, 1 << 32, n_rows, dtype=np.uint32)
        all_rows.append(rows)
        all_home.append(np.full(n_rows, s, np.int32))
    rows = np.concatenate(all_rows)
    home = np.concatenate(all_home)
    keys = rows[:, :2].copy().view(np.uint64).reshape(-1)
    part = (keys % num_partitions).astype(np.int64)
    row_bytes = rows.shape[1] * 4
    dev_slice = topo.device_slices()

    # flat layout: p % D (what the flat reduces place); its cross-slice
    # traffic is every row whose owner shard sits in another slice
    dest_flat = (part % n_dev).astype(np.int32)
    flat_cross = int((dev_slice[dest_flat] != home).sum()) * row_bytes

    # hierarchical layout: slice-aligned by the per-slice histogram
    hist = np.zeros((num_slices, num_partitions), np.int64)
    np.add.at(hist, (home, part), row_bytes)
    pmap = slice_aligned_partition_map(hist, topo, n_dev)
    dest_hier = pmap[part].astype(np.int32)

    def flat_plan():
        # lockstep pricing: the whole collective moves at the slow rate
        out, _ = run_fused_exchange(mesh, rows, dest_flat, key_words=2,
                                    out_factor=4, impl="gather")
        time.sleep(rows.nbytes * dcn_s_per_byte)
        return out

    def hier_plan():
        # the runner charges the residue through the installed shim;
        # the intra-slice bulk pays the (10x cheaper) modelled fast time
        intra_bytes = int((dev_slice[dest_hier] == home).sum()) * row_bytes
        out, _ = run_hierarchical_exchange(
            mesh, topo, rows, dest_hier, home, key_words=2, out_factor=4,
            impl="gather")
        time.sleep(intra_bytes * ici_s_per_byte)
        return out

    shim_prev = topology_mod.cross_slice_shim
    topology_mod.cross_slice_shim = \
        lambda nb: time.sleep(nb * dcn_s_per_byte)
    try:
        # warm both sides (first launches; per-slice sub-mesh steps)
        flat_out = flat_plan()
        before = topology_mod.cross_slice_snapshot()["bytes"]
        hier_out = hier_plan()
        hier_cross = topology_mod.cross_slice_snapshot()["bytes"] - before

        flat_wall = min(_timed(flat_plan) for _ in range(reps))
        hier_wall = min(_timed(hier_plan) for _ in range(reps))
    finally:
        topology_mod.cross_slice_shim = shim_prev

    fp = _per_partition(flat_out, num_partitions)
    hp = _per_partition(hier_out, num_partitions)
    identical = all(np.array_equal(_canon(fp[p]), _canon(hp[p]))
                    for p in range(num_partitions))
    return {
        "wall_s": {"flat": round(flat_wall, 4), "hier": round(hier_wall, 4)},
        "speedup": round(flat_wall / hier_wall, 3) if hier_wall else 0.0,
        "identical": identical,
        "cross_slice_bytes": {"flat": flat_cross, "hier": hier_cross},
        "devices": n_dev,
        "slices": topo.num_slices,
        "cost_ratio": cost_ratio,
    }


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
