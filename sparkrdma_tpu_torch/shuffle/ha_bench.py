"""Driver-HA microbench: what one primary crash costs the job.

The A/B the replicated control plane exists for (shuffle/ha.py): a
lease-armed primary with a warm standby shadowing its op log CRASHES
after the map stage has fully replicated, and the bench measures

* ``failover_downtime_ms`` — crash to the FIRST successful publish
  against the promoted standby: the whole control-plane outage as an
  executor sees it (lease expiry + takeover + TakeoverMsg re-point),
  probed by an idempotent republish loop riding the DriverClient retry
  envelope.
* ``replay_ops`` — the standby's op-log tail length at the crash: the
  replay bill the promotion paid (the ``oplog_lag_entries`` gauge).

Gates: the post-failover reduce is byte-identical to the ground truth
and re-executes ZERO maps — the outputs live on the executors, so
losing the driver may cost a wait, never a recompute (bench.py
secondary, scripts/run_ha_bench.sh).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel.driver_client import DriverUnreachableError
from sparkrdma_tpu_torch.shuffle.ha import DriverStandby, InMemoryLeaseStore
from sparkrdma_tpu_torch.shuffle.manager import (PartitionerSpec, ShuffleHandle,
                                           TpuShuffleManager)
from sparkrdma_tpu_torch.shuffle.map_output import DriverTable
from sparkrdma_tpu_torch.shuffle.recovery import run_map_stage

NUM_EXECUTORS = 2
NUM_MAPS = 4
NUM_PARTITIONS = 4
ROWS_PER_MAP = 500
PROBE_SID = 99  # the probe shuffle the downtime loop republishes into


def _conf(lease_ms: int) -> TpuShuffleConf:
    return TpuShuffleConf(connect_timeout_ms=2000,
                          max_connection_attempts=1,
                          retry_backoff_base_ms=10,
                          retry_backoff_cap_ms=60,
                          pre_warm_connections=False,
                          use_cpp_runtime=False,
                          ha_standbys=1, driver_lease_ms=lease_ms,
                          request_deadline_ms=20_000)


def _expected(seed: int) -> np.ndarray:
    return np.sort(np.concatenate(
        [np.random.default_rng(seed * 1_000_003 + m)
         .integers(0, 50_000, ROWS_PER_MAP)
         for m in range(NUM_MAPS)]).astype(np.uint64))


def run_ha_microbench(tmpdir: str, seed: int = 0,
                      lease_ms: int = 500) -> Dict:
    conf = _conf(lease_ms)
    primary = TpuShuffleManager(conf, is_driver=True,
                                lease_store=InMemoryLeaseStore(),
                                lease_holder="primary")
    standby = DriverStandby(conf, primary.driver.lease_store, "standby",
                            primary_addr=primary.driver.address).start()
    execs = [TpuShuffleManager(conf, driver_addr=primary.driver_addr,
                               executor_id=str(i),
                               spill_dir=f"{tmpdir}/e{i}")
             for i in range(NUM_EXECUTORS)]
    counter: Dict[int, int] = {}
    lock = threading.Lock()
    try:
        for ex in execs:
            ex.executor.wait_for_members(NUM_EXECUTORS)
        handle = ShuffleHandle(7, NUM_MAPS, NUM_PARTITIONS, 0,
                               PartitionerSpec("modulo"))
        primary.driver.register_shuffle(7, num_maps=NUM_MAPS,
                                        num_partitions=NUM_PARTITIONS)
        # the probe shuffle: one slot the downtime loop republishes
        # into — the fence makes every duplicate a no-op, so the probe
        # never perturbs the state it is measuring
        primary.driver.register_shuffle(PROBE_SID, num_maps=1,
                                        num_partitions=1)
        probe = M.PublishMsg(PROBE_SID, 0,
                             DriverTable.pack_entry(1, 0), fence=1)
        execs[0].executor.driver.send(probe)

        def map_fn(writer, map_id):
            with lock:
                counter[map_id] = counter.get(map_id, 0) + 1
            rng = np.random.default_rng(seed * 1_000_003 + map_id)
            writer.write_batch(
                rng.integers(0, 50_000, ROWS_PER_MAP).astype(np.uint64))

        run_map_stage(execs, handle, map_fn)
        table, _ = execs[0].executor.get_driver_table_v(
            7, expect_published=NUM_MAPS, timeout=10)
        assert table.num_published == NUM_MAPS

        # wait for the async replication stream to drain: nothing
        # mutates driver state now, so a stable ingest seq means a
        # crash at any later instant loses no op
        stable_since, last_seen = time.monotonic(), standby._last
        deadline = time.monotonic() + 15
        while time.monotonic() - stable_since < 0.4:
            if time.monotonic() > deadline:
                raise TimeoutError("standby never caught up")
            time.sleep(0.03)
            if standby._last != last_seen:
                stable_since, last_seen = time.monotonic(), standby._last
        replay_ops = standby.lag()

        # CRASH: server down, lease renewals stop — the in-process
        # stand-in for SIGKILL (the subprocess kill -9 variant is the
        # chaos acceptance scenario)
        t_kill = time.monotonic()
        primary.driver.stop()

        # downtime probe: idempotent republish until one lands on the
        # PROMOTED primary — dials of the dead one fail fast, the
        # TakeoverMsg re-point makes the first post-takeover attempt
        # succeed
        client = execs[0].executor.driver
        while True:
            if time.monotonic() - t_kill > 30:
                raise TimeoutError("no successful publish after failover")
            try:
                client.send(probe, deadline_s=0.2)
                if client.incarnation > 0:
                    break
            except DriverUnreachableError:
                pass
        downtime_ms = (time.monotonic() - t_kill) * 1000.0

        # the acceptance gates: byte-identical reduce, zero recomputes
        reader = execs[1].get_reader(handle, 0, NUM_PARTITIONS)
        keys, _ = reader.read_all()
        identical = bool(np.array_equal(np.sort(keys), _expected(seed)))
        reexec = sum(counter.values()) - NUM_MAPS
        new_primary = standby.endpoint
        return {
            "failover_downtime_ms": round(downtime_ms, 3),
            "lease_ms": lease_ms,
            "replay_ops": replay_ops,
            "identical": identical,
            "reexec": reexec,
            "incarnation": new_primary.incarnation if new_primary else 0,
            "seed": seed,
        }
    finally:
        for ex in execs:
            ex.stop()
        standby.stop()
        primary.stop()
