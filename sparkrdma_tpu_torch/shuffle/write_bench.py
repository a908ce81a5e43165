"""Shuffle-write microbench: the streaming dataplane's win, measured.

The monolithic writer serializes everything after map compute: buffer all
batches, then at close concatenate + argsort by destination + materialize a
full rows copy + write. The streaming writer partitions each batch on
arrival with the O(n) scatter kernel, spills accumulated runs on a
background thread **while the map task produces its next batches**, and
closes with a cheap sequential merge. Like the fetch microbench's injected
service delay (shuffle/fetch_bench.py), an optional per-batch
``map_compute_s`` stands in for the map task's real compute between
batches — the window the background spill exists to overlap.

Shared by ``bench.py`` (the ``shuffle_write_throughput`` secondary) and the
tier-1 test, which asserts the >=2x speedup at a spill-forcing size, the
byte-identical committed files, and the bounded-memory promise
(``WriteMetrics.peak_buffered_bytes`` <= threshold + one batch).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.runtime.pool import BufferPool
from sparkrdma_tpu_torch.shuffle.resolver import TpuShuffleBlockResolver
from sparkrdma_tpu_torch.shuffle.writer import (
    MonolithicShuffleWriter,
    TpuShuffleWriter,
)


def _batches(num_batches: int, rows_per_batch: int, payload_bytes: int,
             key_space: int, seed: int):
    """Pre-generate every batch (generation cost must not pollute either
    side's wall time)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_batches):
        keys = rng.integers(0, key_space, rows_per_batch).astype(np.uint64)
        payload = rng.integers(0, 255, (rows_per_batch, payload_bytes)
                               ).astype(np.uint8)
        out.append((keys, payload))
    return out


def run_write_microbench(spill_root: str,
                         num_partitions: int = 64,
                         payload_bytes: int = 8,
                         rows_per_batch: int = 400_000,
                         num_batches: int = 10,
                         spill_threshold: Optional[int] = None,
                         map_compute_s: float = 0.0,
                         reps: int = 1,
                         seed: int = 0,
                         use_pool: bool = True) -> Dict:
    """Write the same batches through both writers; returns::

        {"wall_s": {"monolithic": s, "streaming": s}, "speedup": ...,
         "identical": bool, "spills": N, "peak_buffered_bytes": N,
         "batch_bytes": N, "spill_threshold": N,
         "throughput_mb_s": {"monolithic": ..., "streaming": ...},
         "write_metrics": WriteMetrics snapshot of the last streaming run}

    ``identical`` is byte-level: committed data files AND partition
    lengths must match exactly. The default threshold forces >= 2 spills
    (total bytes ~ 3.3x threshold). Default rows are 16B (u64 key + two
    u32 words) — the aggregation-shuffle shape where the monolithic
    writer's close-time sort dominates, i.e. exactly the cost the
    streaming scatter removes.
    """
    row_bytes = 8 + payload_bytes
    batch_bytes = rows_per_batch * row_bytes
    total_bytes = batch_bytes * num_batches
    if spill_threshold is None:
        # ~3 spills: the bench must exercise spill + merge, not just scatter
        spill_threshold = total_bytes // 3 - batch_bytes // 2
    batches = _batches(num_batches, rows_per_batch, payload_bytes,
                       key_space=1 << 20, seed=seed)
    part = PartitionerModulo(num_partitions)

    conf = TpuShuffleConf(spill_threshold_bytes=spill_threshold)
    pool = BufferPool(conf) if use_pool else None
    resolver = TpuShuffleBlockResolver(os.path.join(spill_root, "wb"))
    wall = {"monolithic": float("inf"), "streaming": float("inf")}
    digests: Dict[str, tuple] = {}
    write_metrics: Dict = {}
    try:
        for _ in range(max(1, reps)):
            for mode in ("monolithic", "streaming"):
                if mode == "monolithic":
                    w = MonolithicShuffleWriter(
                        resolver, 1, 0, num_partitions, part, payload_bytes)
                else:
                    w = TpuShuffleWriter(
                        resolver, 1, 1, num_partitions, part, payload_bytes,
                        conf=conf, pool=pool)
                t0 = time.perf_counter()
                for keys, payload in batches:
                    if map_compute_s:
                        time.sleep(map_compute_s)
                    w.write_batch(keys, payload)
                _, part_lengths = w.close()
                dt = time.perf_counter() - t0
                wall[mode] = min(wall[mode], dt)
                path = os.path.join(resolver.spill_dir,
                                    f"shuffle_1_{0 if mode == 'monolithic' else 1}.data")
                with open(path, "rb") as f:
                    data = f.read()
                digests[mode] = (hash(data), len(data),
                                 tuple(int(x) for x in part_lengths))
                if mode == "streaming":
                    write_metrics = w.metrics.snapshot()
        return {
            "wall_s": {m: round(t, 4) for m, t in wall.items()},
            "speedup": (round(wall["monolithic"] / wall["streaming"], 3)
                        if wall["streaming"] else 0.0),
            "identical": digests["monolithic"] == digests["streaming"],
            "spills": write_metrics.get("spills", 0),
            "peak_buffered_bytes": write_metrics.get("peak_buffered_bytes", 0),
            "batch_bytes": batch_bytes,
            "total_bytes": total_bytes,
            "spill_threshold": int(spill_threshold),
            "map_compute_s": map_compute_s,
            "throughput_mb_s": {
                m: round(total_bytes / t / 1e6, 1) for m, t in wall.items()},
            "write_metrics": write_metrics,
        }
    finally:
        resolver.stop()
        if pool is not None:
            pool.stop()


class PartitionerModulo:
    """Picklable modulo partitioner (lambdas don't cross cloudpickle-free
    paths; a tiny class keeps the bench dependency-light)."""

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        return (np.asarray(keys) % self.num_partitions).astype(np.int64)
