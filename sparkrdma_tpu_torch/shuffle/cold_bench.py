"""Cold-tier microbench: what a full-fleet restart costs the job.

The A/B the disaggregated tier exists for (shuffle/cold_tier.py): the
ENTIRE fleet dies after map finalize (the spot-market / preemption
event), a fresh fleet attaches to the surviving driver, and the reduce
must complete —

* **cold restore** (``cold_tier`` on): the merged segments tiered to
  the blob store before the loss; recovery treats cold coverage like
  merged coverage and re-points, so the fresh fleet reduces straight
  from the blobs with ZERO map re-executions;
* **re-execution baseline** (``cold_tier`` off): nothing survived the
  fleet, so recovery re-executes every map on the fresh executors
  before the reduce can finish — paying the whole map stage again,
  one stage retry per dead owner slot.

``cold_restore_speedup`` is the makespan ratio (baseline / cold) of
the fresh fleet's time-to-answer.  A fixed per-map compute shim
(``map_cost_s``, the same stand-in discipline as the delay shims in
fetch_bench / iter_bench) prices the map work a re-execution repays
and a restore does not; both phases run in one process so the ratio
cancels host noise.

Gates (bench.py secondary + the tier-1 acceptance test in
tests/test_cold_tier.py, swept by scripts/run_cold_bench.sh): both
phases byte-identical to the fault-free ground truth, the cold phase's
post-restart re-executions exactly ZERO, the baseline's exactly
``NUM_MAPS``, and the speedup >= 1.5x.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import (PartitionerSpec, ShuffleHandle,
                                           TpuShuffleManager)
from sparkrdma_tpu_torch.shuffle.recovery import (run_map_stage,
                                            run_reduce_with_retry)

NUM_EXECUTORS = 2
NUM_MAPS = 6
NUM_PARTITIONS = 4
ROWS_PER_MAP = 400


def _conf(tmpdir: str, cold: bool) -> TpuShuffleConf:
    return TpuShuffleConf(connect_timeout_ms=5000,
                          max_connection_attempts=2,
                          retry_backoff_base_ms=10,
                          retry_backoff_cap_ms=80,
                          pre_warm_connections=False,
                          use_cpp_runtime=False, native_fetch=False,
                          push_merge=True, merge_replicas=1,
                          push_deadline_ms=8000,
                          cold_tier=cold,
                          cold_tier_path=f"{tmpdir}/cold")


def _expected(seed: int) -> np.ndarray:
    return np.sort(np.concatenate(
        [np.random.default_rng(seed * 1_000_003 + m)
         .integers(0, 50_000, ROWS_PER_MAP)
         for m in range(NUM_MAPS)]).astype(np.uint64))


def _phase(tmpdir: str, tag: str, seed: int, cold: bool,
           map_cost_s: float) -> Dict:
    """One full lifecycle: cluster up, map + finalize (+ tier when
    ``cold``), kill the WHOLE fleet, fresh fleet reduces.  Returns the
    fresh fleet's timed makespan and the post-restart re-execution
    count."""
    from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE
    from sparkrdma_tpu_torch.shuffle.cold_tier import wait_for_tiered_coverage
    from sparkrdma_tpu_torch.shuffle.push_merge import wait_for_coverage

    conf = _conf(tmpdir, cold)
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, driver_addr=driver.driver_addr,
                               executor_id=f"{tag}{i}",
                               spill_dir=f"{tmpdir}/{tag}{i}")
             for i in range(NUM_EXECUTORS)]
    fresh = []
    counter: Dict[int, int] = {}
    lock = threading.Lock()
    try:
        for ex in execs:
            ex.executor.wait_for_members(NUM_EXECUTORS)
        handle = ShuffleHandle(7, NUM_MAPS, NUM_PARTITIONS, 0,
                               PartitionerSpec("modulo"))
        driver.driver.register_shuffle(7, num_maps=NUM_MAPS,
                                       num_partitions=NUM_PARTITIONS)

        def map_fn(writer, map_id):
            with lock:
                counter[map_id] = counter.get(map_id, 0) + 1
            time.sleep(map_cost_s)  # the compute a re-execution repays
            rng = np.random.default_rng(seed * 1_000_003 + map_id)
            writer.write_batch(
                rng.integers(0, 50_000, ROWS_PER_MAP).astype(np.uint64))

        run_map_stage(execs, handle, map_fn)
        for ex in execs:
            if not ex.pusher.drain(15):
                raise TimeoutError("pusher never drained")
        if not wait_for_coverage(driver.driver, 7, NUM_MAPS,
                                 NUM_PARTITIONS, timeout=15):
            raise TimeoutError("merged coverage never completed")
        if cold:
            for ex in execs:
                if ex.executor.tiering is None or \
                        not ex.executor.tiering.drain(20):
                    raise TimeoutError("tiering never drained")
            if not wait_for_tiered_coverage(driver.driver, 7, NUM_MAPS,
                                            NUM_PARTITIONS, timeout=10):
                raise TimeoutError("tiered coverage never completed")

        # the full-fleet loss: every executor dies, every slot
        # tombstones — with cold off, nothing of the map stage survives
        mids = [ex.executor.manager_id for ex in execs]
        for ex in execs:
            ex.stop()
        for mid in mids:
            driver.driver.remove_member(mid)

        fresh = [TpuShuffleManager(conf, driver_addr=driver.driver_addr,
                                   executor_id=f"{tag}f{i}",
                                   spill_dir=f"{tmpdir}/{tag}f{i}")
                 for i in range(NUM_EXECUTORS)]
        for ex in fresh:
            ex.executor.wait_for_members(2 * NUM_EXECUTORS)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                members = ex.executor.members()
                if all(members[s] == TOMBSTONE
                       for s in range(NUM_EXECUTORS)):
                    break
                time.sleep(0.02)
        pre = sum(counter.values())

        def reduce_fn(mgr, h):
            reader = mgr.get_reader(h, 0, h.num_partitions)
            keys, _ = reader.read_all()
            return np.sort(keys)

        t0 = time.monotonic()
        got = run_reduce_with_retry(fresh, handle, map_fn, reduce_fn,
                                    reducer_index=0,
                                    max_stage_retries=NUM_EXECUTORS + 2,
                                    driver=driver)
        wall_s = time.monotonic() - t0
        return {"wall_s": wall_s,
                "identical": bool(np.array_equal(got, _expected(seed))),
                "reexec": sum(counter.values()) - pre}
    finally:
        for ex in fresh:
            ex.stop()
        driver.stop()


def run_cold_microbench(tmpdir: str, seed: int = 0,
                        map_cost_s: float = 0.05) -> Dict:
    cold = _phase(tmpdir, "c", seed, cold=True, map_cost_s=map_cost_s)
    base = _phase(tmpdir, "b", seed, cold=False, map_cost_s=map_cost_s)
    return {
        "speedup": base["wall_s"] / max(cold["wall_s"], 1e-9),
        "identical": cold["identical"] and base["identical"],
        "reexec": {"cold": cold["reexec"], "baseline": base["reexec"]},
        "wall_s": {"cold": round(cold["wall_s"], 4),
                   "reexec": round(base["wall_s"], 4)},
        "maps": NUM_MAPS,
        "map_cost_s": map_cost_s,
        "seed": seed,
    }
