"""Elastic-membership microbench: planned drain vs unplanned kill.

The A/B the graceful-drain protocol exists for (ROADMAP item 2,
parallel/membership.py): the SAME executor leaves the fleet two ways —

* **drain** — the planned operation on a push-merge fleet: the driver
  decommissions the slot (replication verified, location entries
  re-point under a bumped epoch) before the process goes away. The
  subsequent reduce re-executes ZERO maps: the retired slot's outputs
  serve from merged replicas.
* **kill** — the unplanned loss on a replication-less fleet (the
  pre-push-merge posture an operator who "just kills the pod" gets):
  reducers hit FetchFailed, recovery recomputes every map the dead
  executor owned, and the stage pays the re-execution.

Both arms run the same seeded data, assert byte-identical output, and
report re-executions (0 vs N) plus makespans — the makespan DELTA is
what an autoscaler pays per shrink decision, and ``drain_zero_reexec``
is the tier-1 gate (bench.py secondary, scripts/run_elastic_bench.sh).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.recovery import run_map_stage, run_reduce_with_retry

NUM_EXECUTORS = 4
NUM_MAPS = 8
NUM_PARTITIONS = 6
ROWS_PER_MAP = 2000


def _conf(push_merge: bool) -> TpuShuffleConf:
    return TpuShuffleConf(connect_timeout_ms=3000,
                          max_connection_attempts=2,
                          pre_warm_connections=False,
                          use_cpp_runtime=False,
                          push_merge=push_merge, merge_replicas=1,
                          drain_deadline_ms=20000)


def _map_fn_for(seed: int, counter: Dict[int, int]):
    def map_fn(writer, map_id):
        counter[map_id] = counter.get(map_id, 0) + 1
        rng = np.random.default_rng(seed * 1_000_003 + map_id)
        writer.write_batch(
            rng.integers(0, 50_000, ROWS_PER_MAP).astype(np.uint64))
    return map_fn


def _expected(seed: int) -> np.ndarray:
    return np.sort(np.concatenate(
        [np.random.default_rng(seed * 1_000_003 + m)
         .integers(0, 50_000, ROWS_PER_MAP)
         for m in range(NUM_MAPS)]).astype(np.uint64))


def _reduce(mgr, handle):
    keys, _ = mgr.get_reader(handle, 0, NUM_PARTITIONS).read_all()
    return np.sort(keys)


def _run_arm(tmp_dir: str, seed: int, drain: bool) -> dict:
    """One departure arm: build the fleet, commit the maps, make the
    last executor leave (gracefully or not), then time the reduce."""
    conf = _conf(push_merge=drain)
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, driver_addr=driver.driver_addr,
                               executor_id=f"{'d' if drain else 'k'}{i}",
                               spill_dir=os.path.join(
                                   tmp_dir, f"{'d' if drain else 'k'}{i}"))
             for i in range(NUM_EXECUTORS)]
    victim_stopped = [False]
    try:
        for ex in execs:
            ex.executor.wait_for_members(NUM_EXECUTORS)
        handle = driver.register_shuffle(
            1, num_maps=NUM_MAPS, num_partitions=NUM_PARTITIONS,
            partitioner=PartitionerSpec("modulo"))
        counter: Dict[int, int] = {}
        map_fn = _map_fn_for(seed, counter)
        ran = run_map_stage(execs, handle, map_fn)
        if drain:
            for ex in execs:
                ex.pusher.drain(timeout=20)
        victim = execs[-1]
        victim_slot = victim.executor.exec_index(timeout=2)
        owned = [m for m, i in ran.items() if i == NUM_EXECUTORS - 1]

        t0 = time.perf_counter()
        if drain:
            res = driver.decommission_slot(victim_slot)
            status = res["status"]
        else:
            # the operator's posture: nothing announced the death — the
            # reduce discovers it by failed fetch + recovery
            status = "killed"
        victim.stop()
        victim_stopped[0] = True
        survivors = execs[:-1]
        got = run_reduce_with_retry(
            survivors, handle, map_fn, _reduce, reducer_index=0,
            max_stage_retries=3, driver=driver)
        makespan = time.perf_counter() - t0
        return {
            "keys": got,
            "reexecutions": sum(counter.values()) - NUM_MAPS,
            "owned": len(owned),
            "makespan_s": makespan,
            "status": status,
        }
    finally:
        for ex in execs[:-1]:
            ex.stop()
        if not victim_stopped[0]:
            # an exception before the planned stop must not leak the
            # victim's server/pool threads into later bench secondaries
            execs[-1].stop()
        driver.stop()


def run_elastic_microbench(tmp_dir: str, seed: int = 0) -> dict:
    """The drain-vs-kill A/B; returns the record bench.py folds into
    its round JSON (``drain_zero_reexec`` is the acceptance gate)."""
    drain = _run_arm(os.path.join(tmp_dir, "drain"), seed, drain=True)
    kill = _run_arm(os.path.join(tmp_dir, "kill"), seed, drain=False)
    expect = _expected(seed)
    identical = (np.array_equal(drain["keys"], expect)
                 and np.array_equal(kill["keys"], expect))
    return {
        "identical": bool(identical),
        "maps": NUM_MAPS,
        "victim_owned_maps": drain["owned"],
        "drain_status": drain["status"],
        "reexec_drain": int(drain["reexecutions"]),
        "reexec_kill": int(kill["reexecutions"]),
        "drain_makespan_s": drain["makespan_s"],
        "kill_makespan_s": kill["makespan_s"],
        "makespan_delta_s": kill["makespan_s"] - drain["makespan_s"],
        "seed": seed,
    }
