"""Merged-vs-scattered read microbench: the push-merge win, measured.

Magnet's argument is an IO-shape argument: a reducer's input is spread
over M map files, so even with PR 3's request coalescing (a handful of
request FRAMES) the serving side still performs M small scattered reads
per partition; a merged per-partition segment turns that into ONE
sequential read. On CPU loopback the seek cost is invisible, so this
harness injects it deterministically: every served block range pays a
fixed ``seek_delay_s`` on the serving pool — the stand-in for the random
IOPS a real disk (or a remote NIC doorbell per range) charges. A
many-small-maps shuffle is then drained twice AT EQUAL BYTES by a
late-joining reducer that owns nothing:

* **scattered** — the coalesced per-map dataplane (today's default):
  ``M x P`` served ranges;
* **merged** — merged-segment-first: ``P`` served ranges, one sequential
  wide read per partition, ``requests_per_reduce`` ~ 1 per partition
  (plus one directory pull).

Returns byte-level parity plus the per-partition speedup gate shared by
``bench.py`` (the ``merged_read_speedup`` secondary) and the tier-1
acceptance test (>= 2x).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.reader import TpuShuffleReader


def _sorted_rows(results, row_bytes: int) -> np.ndarray:
    """Every fetched row, lexicographically sorted — the byte-identity
    oracle across dataplanes that slice results differently."""
    blobs = [bytes(d) for d in results if len(d)]
    if not blobs:
        return np.zeros((0, row_bytes), dtype=np.uint8)
    arr = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    arr = arr.reshape(-1, row_bytes)
    order = np.lexsort(arr.T[::-1])
    return arr[order]


def run_merge_microbench(spill_root: str,
                         num_maps: int = 32,
                         num_partitions: int = 8,
                         rows_per_part: int = 16,
                         seek_delay_s: float = 0.002,
                         merge_replicas: int = 1) -> Dict:
    """Returns::

        {"wall_s": {"scattered": s, "merged": s},
         "speedup": scattered/merged,
         "requests": {"scattered": n, "merged": n},
         "blocks_served": {"scattered": n, "merged": n},
         "merged_reads": n, "identical": bool}
    """
    conf_kw = dict(connect_timeout_ms=20000, use_cpp_runtime=False,
                   push_merge=True, merge_replicas=merge_replicas,
                   push_deadline_ms=8000)
    driver = TpuShuffleManager(TpuShuffleConf(**conf_kw), is_driver=True)
    execs = [TpuShuffleManager(TpuShuffleConf(**conf_kw),
                               driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=os.path.join(spill_root, f"m{i}"))
             for i in range(3)]
    reducer = None
    try:
        for ex in execs:
            ex.executor.wait_for_members(3)
        payload_w = 24  # 8B key + 24B payload = 32B rows
        row_bytes = 8 + payload_w
        handle = driver.register_shuffle(3, num_maps, num_partitions,
                                         PartitionerSpec("modulo"),
                                         row_payload_bytes=payload_w)
        rng = np.random.default_rng(3)
        keys = np.repeat(np.arange(num_partitions, dtype=np.uint64),
                         rows_per_part)
        for m in range(num_maps):
            # every map on executor 0: its pusher replicates to peers
            # {1, 2} by partition-range, so the late reducer below owns
            # neither maps nor segments — both modes pay the wire
            w = execs[0].get_writer(handle, m)
            w.write_batch(keys, rng.integers(
                0, 255, (len(keys), payload_w), dtype=np.uint64
            ).astype(np.uint8))
            w.close()
        from sparkrdma_tpu_torch.shuffle.push_merge import wait_for_coverage
        execs[0].pusher.drain(15)
        covered = wait_for_coverage(driver.driver, handle.shuffle_id,
                                    num_maps, num_partitions, timeout=15)

        # seek-cost shim: each served block RANGE pays the fixed delay
        # (the per-range random-read cost coalesced frames still pay
        # server-side; a merged segment is one range per partition)
        served_blocks = {"n": 0}
        origs = []
        for ex in execs:
            ep = ex.executor
            orig = ep._on_fetch_blocks
            origs.append((ep, orig))

            def shim(msg, orig=orig):
                served_blocks["n"] += len(msg.blocks)
                time.sleep(seek_delay_s * len(msg.blocks))
                return orig(msg)

            ep._on_fetch_blocks = shim

        # the reducer joins LATE: it holds no map outputs and no merged
        # segments, so scattered and merged both read remotely
        reducer = TpuShuffleManager(
            TpuShuffleConf(**conf_kw), driver_addr=driver.driver_addr,
            executor_id="r", spill_dir=os.path.join(spill_root, "mr"))
        reducer.executor.wait_for_members(4)

        wall: Dict[str, float] = {}
        requests: Dict[str, int] = {}
        blocks: Dict[str, int] = {}
        fetched: Dict[str, np.ndarray] = {}
        merged_reads = 0
        for mode, merged_on in (("scattered", False), ("merged", True)):
            conf_m = TpuShuffleConf(**dict(conf_kw, push_merge=merged_on))
            reader = TpuShuffleReader(
                reducer.executor, reducer.resolver, conf_m,
                handle.shuffle_id, num_maps, 0, num_partitions, payload_w)
            served_blocks["n"] = 0
            results = []
            t0 = time.perf_counter()
            reader.fetcher.start()
            try:
                for r in reader.fetcher:
                    results.append(bytes(r.data))
                    r.free()
            finally:
                reader.fetcher.close()
            wall[mode] = time.perf_counter() - t0
            requests[mode] = reader.metrics.requests_per_reduce
            blocks[mode] = served_blocks["n"]
            fetched[mode] = _sorted_rows(results, row_bytes)
            if merged_on:
                merged_reads = reader.metrics.merged_reads
        return {
            "wall_s": {k: round(v, 4) for k, v in wall.items()},
            "speedup": (round(wall["scattered"] / wall["merged"], 2)
                        if wall["merged"] else 0.0),
            "requests": requests,
            "blocks_served": blocks,
            "merged_reads": merged_reads,
            "coverage_complete": covered,
            "identical": bool(np.array_equal(fetched["scattered"],
                                             fetched["merged"])),
            "maps": num_maps,
            "partitions": num_partitions,
            "seek_delay_s": seek_delay_s,
        }
    finally:
        if reducer is not None:
            reducer.stop()
        for ex in execs:
            ex.stop()
        driver.stop()
