"""Iterative-workload microbench: the warm metadata plane's win, measured.

A PageRank-style loop re-reads the SAME parent shuffle every superstep
(rank contributions keyed by vertex — the graph structure doesn't change
between iterations). Pre-plane, every superstep re-paid the full
metadata cost: one driver-table sync plus one batched location RPC per
peer. With the epoch-versioned location plane, superstep N>=1 resolves
every location from the local cache — ZERO metadata RPCs on the wire.

On a CPU loopback the metadata round trips cost microseconds, so — like
``fetch_bench`` — a fixed service delay injected into the METADATA
handlers (driver-table fetch + location reads) stands in for the
control-plane latency of a real deployment (driver fan-in queueing,
cross-DC RTT). The delay shim makes the win measurable deterministically
without hardware; the RPC *counts* are exact either way and are the
primary assertion (warm supersteps must issue exactly zero).

Shared by ``bench.py`` (the ``iterative_warm_speedup`` secondary) and
the tier-1 test, which also asserts byte-identical supersteps.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.reader import TpuShuffleReader


def run_iterative_microbench(spill_root: str,
                             supersteps: int = 10,
                             delay_s: float = 0.008,
                             num_maps: int = 8,
                             num_partitions: int = 8,
                             rows_per_map: int = 2048,
                             warm_read_cache: bool = False) -> Dict:
    """Measure per-superstep wall time and metadata RPC count, cold vs
    warm, over a ``supersteps``-iteration loop re-reading one unchanged
    shuffle. Returns::

        {"supersteps": N, "delay_s": d,
         "metadata_rpcs_per_superstep": {"cold": k, "warm": 0},
         "wall_s_per_superstep": {"cold": s, "warm": s},
         "speedup": cold/warm, "identical": bool}

    Superstep 0 of each mode pays the cold sync and is EXCLUDED from the
    per-superstep means (both modes pay it identically); the comparison
    is steady-state iteration cost. ``identical`` is byte-level across
    every superstep of both modes."""
    import os

    conf_kw = dict(connect_timeout_ms=20000, use_cpp_runtime=False,
                   pre_warm_connections=False,
                   warm_read_cache=warm_read_cache)
    conf = TpuShuffleConf(**conf_kw)
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(TpuShuffleConf(**conf_kw),
                               driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=os.path.join(spill_root, f"i{i}"))
             for i in range(2)]
    try:
        for ex in execs:
            ex.executor.wait_for_members(2)
        payload_w = 8  # 8B key (vertex) + 8B payload (rank contribution)
        handle = driver.register_shuffle(1, num_maps, num_partitions,
                                         PartitionerSpec("modulo"),
                                         row_payload_bytes=payload_w)
        rng = np.random.default_rng(0)
        for m in range(num_maps):
            w = execs[0].get_writer(handle, m)
            verts = rng.integers(0, num_partitions * 64,
                                 rows_per_map).astype(np.uint64)
            w.write_batch(verts, rng.integers(
                0, 255, (len(verts), payload_w),
                dtype=np.uint64).astype(np.uint8))
            w.close()

        # metadata delay shim: every metadata frame served — driver
        # table long-poll, per-map location read, batched location read
        # — pays a fixed service latency (the control-plane RTT of a
        # real deployment); DATA reads are NOT delayed, so the measured
        # delta is purely the metadata plane's
        drv = driver.driver
        ep = execs[0].executor
        orig_table = drv._on_fetch_table
        orig_one, orig_many = ep._on_fetch_output, ep._on_fetch_outputs

        def delayed(orig):
            def handler(*a):
                time.sleep(delay_s)
                return orig(*a)
            return handler

        drv._on_fetch_table = delayed(orig_table)
        ep._on_fetch_output = delayed(orig_one)
        ep._on_fetch_outputs = delayed(orig_many)

        plane = execs[1].executor.location_plane
        results: Dict[str, list] = {}
        walls: Dict[str, float] = {}
        meta: Dict[str, float] = {}
        for mode in ("cold", "warm"):
            # the plane is an endpoint-lifetime cache; the cold mode IS
            # the pre-plane behavior (every superstep re-syncs), toggled
            # here exactly like location_epoch_cache=False configures it
            plane.enabled = mode == "warm"
            plane.invalidate(handle.shuffle_id)
            from sparkrdma_tpu_torch.shuffle import dist_cache
            dist_cache.drop(handle.shuffle_id)
            keys_seen = []
            step_walls = []
            step_meta = []
            for _step in range(supersteps):
                reader = TpuShuffleReader(
                    execs[1].executor, execs[1].resolver,
                    TpuShuffleConf(**conf_kw), handle.shuffle_id,
                    num_maps, 0, num_partitions, payload_w)
                t0 = time.perf_counter()
                keys, _payload = reader.read_all()
                step_walls.append(time.perf_counter() - t0)
                step_meta.append(reader.metrics.metadata_rpcs_per_stage)
                keys_seen.append(np.sort(keys))
            results[mode] = keys_seen
            # steady state: superstep 0's cold sync excluded (both
            # modes pay it identically)
            walls[mode] = float(np.mean(step_walls[1:]))
            meta[mode] = float(np.mean(step_meta[1:]))
        identical = all(
            np.array_equal(results["cold"][i], results["warm"][j])
            for i in range(supersteps) for j in range(supersteps))
        return {
            "supersteps": supersteps,
            "delay_s": delay_s,
            "metadata_rpcs_per_superstep": {m: meta[m] for m in meta},
            "wall_s_per_superstep": {m: round(walls[m], 5) for m in walls},
            "speedup": (round(walls["cold"] / walls["warm"], 3)
                        if walls["warm"] else 0.0),
            "identical": identical,
        }
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()
