"""Stage retry on the port's copy of ``shuffle/recovery.py``: an executor
dies after committing map outputs; the retry loop recomputes its maps on
the survivors and the reduce completes with exactly the right data.
Mirrors ``tests/test_recovery.py::test_reduce_survives_executor_loss`` on
the port's managers; imports no JAX."""

import time

import numpy as np
import pytest

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError
from sparkrdma_tpu_torch.shuffle.manager import (
    PartitionerSpec,
    TpuShuffleManager,
)
from sparkrdma_tpu_torch.shuffle.recovery import (
    run_map_stage,
    run_reduce_with_retry,
)

CONF = TpuShuffleConf(connect_timeout_ms=1000, max_connection_attempts=2)


def _map_fn(writer, map_id):
    """Deterministic map task: recompute yields identical records."""
    rng = np.random.default_rng(1000 + map_id)
    keys = rng.integers(0, 5000, size=500).astype(np.uint64)
    writer.write_batch(keys)


def _reduce_fn(mgr, handle):
    reader = mgr.get_reader(handle, 0, handle.num_partitions)
    keys, _ = reader.read_all()
    return np.sort(keys)


def test_reduce_survives_executor_loss(tmp_path):
    driver = TpuShuffleManager(CONF, is_driver=True)
    execs = [TpuShuffleManager(CONF, driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=str(tmp_path / f"e{i}"))
             for i in range(3)]
    for ex in execs:
        ex.executor.wait_for_members(3)
    try:
        handle = driver.register_shuffle(1, num_maps=6, num_partitions=4,
                                         partitioner=PartitionerSpec("modulo"))
        ran = run_map_stage(execs, handle, _map_fn)
        assert len(ran) == 6
        expect = np.sort(np.concatenate(
            [np.random.default_rng(1000 + m).integers(0, 5000, 500)
             for m in range(6)]).astype(np.uint64))

        # sanity: clean reduce works
        np.testing.assert_array_equal(_reduce_fn(execs[0], handle), expect)

        # kill executor 1 (it owns maps 1 and 4); tombstone it
        lost = execs[1].executor.manager_id
        lost_slot = execs[1].executor.exec_index()
        execs[1].executor.stop()
        driver.driver.remove_member(lost)
        time.sleep(0.3)
        execs[0].executor.invalidate_shuffle(1)

        # un-retried reduce fails...
        with pytest.raises(FetchFailedError):
            _reduce_fn(execs[0], handle)

        # ...the stage-retry loop repairs and completes with exact data
        got = run_reduce_with_retry(execs, handle, _map_fn, _reduce_fn,
                                    reducer_index=0)
        np.testing.assert_array_equal(got, expect)

        # the repaired table no longer references the dead slot
        table = execs[0].executor.get_driver_table(1, 6, timeout=5)
        for m in range(6):
            assert table.entry(m)[1] != lost_slot
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()
