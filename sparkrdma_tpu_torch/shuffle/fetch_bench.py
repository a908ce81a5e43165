"""Latency-injected fetch microbench: the pipelining win, measured.

The reference's speedup comes from keeping many one-sided READs in
flight per channel (RdmaShuffleFetcherIterator.scala:82-83); on a CPU
loopback there is no wire latency, so the win the read-ahead window buys
is invisible. This harness makes it measurable **deterministically,
without TPU hardware**: a real driver + two-executor cluster over
loopback, a fixed service delay injected into the serving executor's
block handler (the delay shim stands in for the wire/NIC latency of a
real deployment), and one reducer draining the same shuffle at different
``read_ahead_depth`` settings.

With service delay ``d`` dominating and ``N`` grouped fetches, depth 1
costs ~``N*d`` (fully serialized — the pre-pipelining behavior) while
depth ``k`` costs ~``N*d/k`` (requests overlap server-side across the
serving pool). Shared by ``bench.py`` (the ``fetch_pipeline_speedup``
secondary) and the tier-1 test, which also asserts the fetched bytes are
identical at every depth.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.reader import TpuShuffleReader


def run_fetch_microbench(spill_root: str,
                         depths: Sequence[int] = (1, 4),
                         delay_s: float = 0.004,
                         num_partitions: int = 48,
                         block_bytes: int = 4096,
                         num_maps: int = 2,
                         serve_threads: int = 8,
                         reps: int = 1) -> Dict:
    """Measure fetch wall-time per read-ahead depth; returns::

        {"wall_s": {depth: seconds}, "speedup": first_depth/last_depth,
         "identical": bool, "fetches": grouped_fetch_count,
         "pipeline": depth-histogram snapshot of the deepest run}

    ``identical`` is byte-level: every depth must fetch the exact same
    multiset of (map, partition-range, payload) results.
    """
    import os

    # coalescing off ON PURPOSE: this harness measures the read-ahead
    # window's overlap of many per-map requests; the coalesced dataplane
    # would merge them into a handful of vectored frames and measure
    # nothing (its RPC-count win has its own harness below,
    # run_coalesce_microbench)
    conf_kw = dict(connect_timeout_ms=20000,
                   shuffle_read_block_size=block_bytes,
                   serve_threads=serve_threads,
                   coalesce_reads=False,
                   use_cpp_runtime=False)
    driver = TpuShuffleManager(TpuShuffleConf(**conf_kw), is_driver=True)
    execs = [TpuShuffleManager(TpuShuffleConf(**conf_kw),
                               driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=os.path.join(spill_root, f"e{i}"))
             for i in range(2)]
    try:
        for ex in execs:
            ex.executor.wait_for_members(2)
        payload_w = 56  # 8B key + 56B payload = 64B rows
        rows_per_part = max(1, block_bytes // (8 + payload_w))
        handle = driver.register_shuffle(1, num_maps, num_partitions,
                                         PartitionerSpec("modulo"),
                                         row_payload_bytes=payload_w)
        rng = np.random.default_rng(0)
        keys = np.repeat(np.arange(num_partitions, dtype=np.uint64),
                         rows_per_part)
        for m in range(num_maps):
            w = execs[0].get_writer(handle, m)
            w.write_batch(keys, rng.integers(
                0, 255, (len(keys), payload_w), dtype=np.uint64
            ).astype(np.uint8))
            w.close()

        # delay shim: every grouped data read pays a fixed service
        # latency ON THE SERVING POOL (concurrent requests overlap there,
        # exactly like concurrent READs overlap on a real wire)
        ep = execs[0].executor
        orig = ep._on_fetch_blocks
        ep._on_fetch_blocks = lambda msg: (time.sleep(delay_s), orig(msg))[1]

        wall: Dict[int, float] = {}
        fetched: Dict[int, list] = {}
        fetch_count = 0
        pipeline_snap: Optional[dict] = None
        for depth in depths:
            conf_d = TpuShuffleConf(**dict(conf_kw, read_ahead_depth=depth))
            best = float("inf")
            for _ in range(max(1, reps)):
                reader = TpuShuffleReader(
                    execs[1].executor, execs[1].resolver, conf_d,
                    handle.shuffle_id, num_maps, 0, num_partitions,
                    payload_w)
                results = []
                t0 = time.perf_counter()
                reader.fetcher.start()
                try:
                    for r in reader.fetcher:
                        results.append((r.map_id, r.start_partition,
                                        r.end_partition, r.data))
                finally:
                    reader.fetcher.close()
                dt = time.perf_counter() - t0
                if dt < best:
                    best = dt
                fetched[depth] = sorted(results)
                fetch_count = len(results)
                if depth == max(depths):
                    pipeline_snap = reader.fetcher.pipeline.snapshot()
            wall[depth] = best
        first, last = depths[0], depths[-1]
        identical = all(fetched[d] == fetched[first] for d in depths)
        return {
            "wall_s": {d: round(t, 4) for d, t in wall.items()},
            "speedup": round(wall[first] / wall[last], 3) if wall[last] else 0.0,
            "identical": identical,
            "fetches": fetch_count,
            "delay_s": delay_s,
            "pipeline": pipeline_snap,
        }
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()


def run_coalesce_microbench(spill_root: str,
                            num_maps: int = 64,
                            num_partitions: int = 8,
                            block_bytes: int = 4096,
                            read_ahead_depth: int = 8) -> Dict:
    """The coalesced dataplane's RPC-count win, measured: a many-small-maps
    shuffle (the workload "RPC Considered Harmful" names — request/response
    cycles dominate, not bandwidth) drained twice over loopback at equal
    total bytes, once per-map and once coalesced. Returns::

        {"requests": {"per_map": N, "coalesced": N},
         "rpc_reduction": per_map / coalesced,
         "identical": bool, "bytes": total_payload_bytes}

    ``requests`` counts REQUEST FRAMES on the wire (location RPCs + data
    reads, via ``ReadMetrics.requests_per_reduce``); ``identical`` is the
    byte-level parity gate. Shared by ``bench.py`` (the
    ``fetch_rpc_reduction`` secondary) and the tier-1 test asserting the
    >=5x reduction."""
    import os

    conf_kw = dict(connect_timeout_ms=20000,
                   shuffle_read_block_size=block_bytes,
                   read_ahead_depth=read_ahead_depth,
                   use_cpp_runtime=False)
    driver = TpuShuffleManager(TpuShuffleConf(**conf_kw), is_driver=True)
    execs = [TpuShuffleManager(TpuShuffleConf(**conf_kw),
                               driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=os.path.join(spill_root, f"c{i}"))
             for i in range(2)]
    try:
        for ex in execs:
            ex.executor.wait_for_members(2)
        payload_w = 24  # 8B key + 24B payload = 32B rows
        handle = driver.register_shuffle(2, num_maps, num_partitions,
                                         PartitionerSpec("modulo"),
                                         row_payload_bytes=payload_w)
        rng = np.random.default_rng(1)
        keys = np.repeat(np.arange(num_partitions, dtype=np.uint64), 4)
        for m in range(num_maps):
            w = execs[0].get_writer(handle, m)
            w.write_batch(keys, rng.integers(
                0, 255, (len(keys), payload_w), dtype=np.uint64
            ).astype(np.uint8))
            w.close()

        requests: Dict[str, int] = {}
        fetched: Dict[str, list] = {}
        total_bytes = 0
        for mode, coalesce in (("per_map", False), ("coalesced", True)):
            conf_m = TpuShuffleConf(**dict(conf_kw, coalesce_reads=coalesce))
            reader = TpuShuffleReader(
                execs[1].executor, execs[1].resolver, conf_m,
                handle.shuffle_id, num_maps, 0, num_partitions, payload_w)
            results = []
            reader.fetcher.start()
            try:
                for r in reader.fetcher:
                    results.append((r.map_id, r.start_partition,
                                    r.end_partition, bytes(r.data)))
                    r.free()
            finally:
                reader.fetcher.close()
            requests[mode] = reader.metrics.requests_per_reduce
            fetched[mode] = sorted(results)
            total_bytes = sum(len(d) for _, _, _, d in results)
        return {
            "requests": requests,
            "rpc_reduction": (round(requests["per_map"]
                                    / requests["coalesced"], 2)
                              if requests["coalesced"] else 0.0),
            "identical": fetched["per_map"] == fetched["coalesced"],
            "bytes": total_bytes,
            "maps": num_maps,
            "partitions": num_partitions,
        }
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()
