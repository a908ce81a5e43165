"""Planned-push microbench: the sender-driven shuffle win, measured.

The reference eliminates the reduce stage's fetch critical path by
pushing map output to its planned reducer during the MAP stage (the
push overlaps map compute, so its wire cost is off the reduce clock).
On CPU loopback there is no wire latency, so the win is invisible;
this harness makes it measurable **deterministically, without TPU
hardware** using the same recipe as ``fetch_bench``: a real
driver + three-executor cluster, a fixed service delay injected into
every metadata/data handler (the shim stands in for wire/NIC latency),
and the same reduce partitions drained twice at their PLANNED slots —
once pulling (``planned_push`` off: driver-table RPC + per-map block
fetches, each paying the delay) and once from the pushed staging
(``planned_push`` on: zero metadata RPCs, zero data RPCs).

The shim is installed AFTER the map stage and push drain on purpose:
planned pushes paid the wire during the map stage, overlapped with
map work — the bench measures the reduce-stage critical path, which
is exactly the paper's claim. Shared by ``bench.py`` (the
``pushplan_speedup`` secondary) and the tier-1 acceptance test, which
gates on start-to-first-row >= 1.5x, byte-identical output, and
0 metadata + 0 data RPCs for fully-pushed partitions.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.reader import TpuShuffleReader


class _RpcMeter:
    """Server-side frame counts across the whole cluster, with an
    optional fixed service delay per frame (the wire-latency shim).
    Counting SERVER-side is the honest zero-RPC gate: a fully-pushed
    reducer must cause no frames to arrive anywhere, not merely report
    zeros in its own client metrics."""

    def __init__(self, driver, execs, delay_s: float = 0.0):
        self.meta = 0
        self.data = 0
        self._delay_s = delay_s

        def wrap(kind, orig):
            def handler(*a):
                if kind == "meta":
                    self.meta += 1
                else:
                    self.data += 1
                if self._delay_s:
                    time.sleep(self._delay_s)
                return orig(*a)
            return handler

        drv = driver.driver
        drv._on_fetch_table = wrap("meta", drv._on_fetch_table)
        for ex in execs:
            ep = ex.executor
            ep._on_fetch_output = wrap("meta", ep._on_fetch_output)
            ep._on_fetch_outputs = wrap("meta", ep._on_fetch_outputs)
            ep._on_fetch_blocks = wrap("data", ep._on_fetch_blocks)

    def reset(self) -> None:
        self.meta = 0
        self.data = 0


def _drain_timed(reader) -> Tuple[float, float, List[tuple]]:
    """Drain one fetcher; returns (start_to_first_row_s, makespan_s,
    sorted results). First-row is the metric the paper optimizes: the
    reduce task can start merging as soon as ONE input lands."""
    results = []
    first = None
    t0 = time.perf_counter()
    reader.fetcher.start()
    try:
        for r in reader.fetcher:
            if first is None:
                first = time.perf_counter() - t0
            results.append((r.map_id, r.start_partition, r.end_partition,
                            bytes(r.data)))
    finally:
        reader.fetcher.close()
    makespan = time.perf_counter() - t0
    return (first if first is not None else makespan), makespan, \
        sorted(results)


def run_pushplan_microbench(spill_root: str,
                            delay_s: float = 0.004,
                            num_maps: int = 6,
                            num_partitions: int = 4,
                            rows: int = 400,
                            payload_w: int = 56,
                            reps: int = 1) -> Dict:
    """Measure reduce-stage start-to-first-row and makespan, planned
    push vs pull, at the planned reducer slots; returns::

        {"first_row_s": {"pull": s, "push": s},
         "makespan_s": {"pull": s, "push": s},
         "pushplan_speedup": pull_first_row / push_first_row,
         "makespan_speedup": ..., "identical": bool,
         "rpcs": {"pull": {"meta": N, "data": N},
                  "push": {"meta": 0, "data": 0}},
         "pushed_reads": total}

    ``identical`` is byte-level: both modes must produce the same
    multiset of (map, partition-range, payload) results. Coalescing is
    off so both dataplanes frame results per (map, partition) and the
    comparison needs no reassembly.
    """
    conf_kw = dict(connect_timeout_ms=20000, use_cpp_runtime=False,
                   retry_backoff_base_ms=10, retry_backoff_cap_ms=80,
                   adaptive_plan=True, planned_push=True,
                   push_merge=False, coalesce_reads=False,
                   push_deadline_ms=8000)
    driver = TpuShuffleManager(TpuShuffleConf(**conf_kw), is_driver=True)
    execs = [TpuShuffleManager(TpuShuffleConf(**conf_kw),
                               driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=os.path.join(spill_root, f"p{i}"))
             for i in range(3)]
    try:
        for ex in execs:
            ex.executor.wait_for_members(3)
        by_slot = {ex.executor.exec_index(timeout=5): ex for ex in execs}

        handle = driver.register_shuffle(1, num_maps, num_partitions,
                                         PartitionerSpec("modulo"),
                                         row_payload_bytes=payload_w)
        rng = np.random.default_rng(0)
        for m in range(num_maps):
            w = execs[m % len(execs)].get_writer(handle, m)
            keys = rng.integers(0, 5000, rows).astype(np.uint64)
            payload = rng.integers(0, 255, (rows, payload_w),
                                   dtype=np.uint64).astype(np.uint8)
            w.write_batch(keys, payload)
            w.close()

        # map stage "completes": the driver publishes the plan; pushers
        # replay their logged maps toward the planned slots
        plan = driver.driver.build_reduce_plan(handle.shuffle_id)
        assert plan is not None, "adaptive plan missing — no size rows?"
        for ex in execs:
            assert ex.pusher.drain(15), "planned pushes did not drain"
        # wait for FULL staging coverage at every planned slot: the
        # plan broadcast races the drain call, and the bench's zero-RPC
        # leg is only meaningful once every (map, partition) is staged
        deadline = time.monotonic() + 15
        sid = handle.shuffle_id
        while time.monotonic() < deadline:
            done = all(
                len(by_slot[plan.placement_of(p)].executor.pushed_store
                    .maps_staged(sid, p, plan.plan_epoch)) == num_maps
                for p in range(num_partitions))
            if done:
                break
            for ex in execs:
                ex.pusher.drain(5)
            time.sleep(0.02)
        else:
            raise AssertionError("planned pushes never fully staged: %s" % [
                (p, by_slot[plan.placement_of(p)].executor.pushed_store
                 .maps_staged(sid, p, plan.plan_epoch))
                for p in range(num_partitions)])

        # reduce stage: every handler now pays the wire-latency shim
        meter = _RpcMeter(driver, execs, delay_s=delay_s)
        modes = {"pull": TpuShuffleConf(**dict(conf_kw, planned_push=False)),
                 "push": TpuShuffleConf(**conf_kw)}
        first_row: Dict[str, float] = {}
        makespan: Dict[str, float] = {}
        fetched: Dict[str, list] = {}
        rpcs: Dict[str, Dict[str, int]] = {}
        pushed_reads = 0
        for mode, conf_m in modes.items():
            best_first = best_span = float("inf")
            for _ in range(max(1, reps)):
                meter.reset()
                results: List[tuple] = []
                t_first = span = 0.0
                reads = 0
                for p in range(num_partitions):
                    ex = by_slot[plan.placement_of(p)]
                    reader = TpuShuffleReader(
                        ex.executor, ex.resolver, conf_m, sid,
                        num_maps, p, p + 1, payload_w)
                    f, s, res = _drain_timed(reader)
                    t_first += f
                    span += s
                    results.extend(res)
                    reads += reader.metrics.pushed_reads
                if t_first < best_first:
                    best_first, best_span = t_first, span
                    fetched[mode] = sorted(results)
                    rpcs[mode] = {"meta": meter.meta, "data": meter.data}
                    if mode == "push":
                        pushed_reads = reads
            first_row[mode] = best_first
            makespan[mode] = best_span
        return {
            "first_row_s": {m: round(t, 4) for m, t in first_row.items()},
            "makespan_s": {m: round(t, 4) for m, t in makespan.items()},
            "pushplan_speedup": (round(first_row["pull"]
                                       / first_row["push"], 3)
                                 if first_row["push"] else 0.0),
            "makespan_speedup": (round(makespan["pull"]
                                       / makespan["push"], 3)
                                 if makespan["push"] else 0.0),
            "identical": fetched["pull"] == fetched["push"],
            "rpcs": rpcs,
            "pushed_reads": pushed_reads,
            "maps": num_maps,
            "partitions": num_partitions,
            "delay_s": delay_s,
        }
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()
