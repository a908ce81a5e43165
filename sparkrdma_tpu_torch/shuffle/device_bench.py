"""Fused-exchange microbench: the device dataplane against the host-staged
reduce, over the same committed shuffle.

Port of ``sparkrdma_tpu/shuffle/device_bench.py``, name for name. The
host dataplane serves every reduce through request/response cycles
against the executor holding the bytes: on a real deployment each one
pays wire RTT and serving-CPU time. The device plane's point (the
paper's point) is that on-mesh stages skip that loop: committed spills
stage onto the card once, ONE fused partition+exchange+local-sort step
redistributes and orders every row (the ring kernel on ``cuda``), and
results cross back to the host once.

On a loopback there is no wire latency, so (as in ``fetch_bench``, read
ahead, and ``iter_bench``, metadata RTT) a fixed service delay injected
into the serving executor's block handler stands in for the round trip
the host path pays per data request. The fused side pays no such delay
by construction: its staging is the resolver's local sequential read.
Both sides run in the SAME process back to back, so the ratio cancels
host noise; ``identical`` is the byte-level gate (every partition's
(key, payload) multiset must match exactly).

The one change from the reference: the mesh is a keyword, ``mesh=None``
meaning ``VirtualMesh(8)`` on ``cuda`` (it raises without a card); pass
``VirtualMesh(8, "cpu")`` to run on the CPU.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import (
    PartitionerSpec,
    TpuShuffleManager,
)


def _canon(keys: np.ndarray, payload: np.ndarray) -> np.ndarray:
    """Canonical byte-comparison form of one partition: rows sorted by
    (key, payload) so equal-key payload order (unspecified on both
    dataplanes) can't fail an exact-bytes comparison."""
    rows = np.concatenate(
        [keys.view(np.uint8).reshape(len(keys), 8), payload], axis=1)
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def run_device_microbench(spill_root: str,
                          num_maps: int = 4,
                          num_partitions: int = 16,
                          rows_per_map: int = 2048,
                          payload_bytes: int = 8,
                          delay_s: float = 0.006,
                          reps: int = 2,
                          mesh=None) -> Dict:
    """Reduce the same shuffle once per dataplane; returns::

        {"wall_s": {"host": s, "fused": s}, "speedup": host/fused,
         "identical": bool, "bytes": staged_payload_bytes,
         "delay_s": delay_s, "devices": mesh_size}

    Host side: one ``TpuShuffleReader.read_sorted()`` per partition on
    the non-owning executor (remote fetches over loopback, the delay
    shim on the serving executor's block handler standing in for wire
    RTT). Fused side: ``run_mesh_reduce_fused`` over ``mesh`` (default
    ``VirtualMesh(8)`` on ``cuda``): local staging, one fused step,
    key-sorted results.
    """
    import os

    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.shuffle.mesh_service import (
        run_mesh_reduce_fused,
        split_by_partition,
    )
    from sparkrdma_tpu_torch.shuffle.reader import TpuShuffleReader

    # resolved first: without a card this raises before any cluster starts
    mesh = VirtualMesh(8) if mesh is None else mesh
    n_dev = mesh.num_shards

    conf_kw = dict(connect_timeout_ms=20000, use_cpp_runtime=False)
    driver = TpuShuffleManager(TpuShuffleConf(**conf_kw), is_driver=True)
    execs = [TpuShuffleManager(TpuShuffleConf(**conf_kw),
                               driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=os.path.join(spill_root, f"d{i}"))
             for i in range(2)]
    try:
        for ex in execs:
            ex.executor.wait_for_members(2)
        handle = driver.register_shuffle(7, num_maps, num_partitions,
                                         PartitionerSpec("modulo"),
                                         row_payload_bytes=payload_bytes)
        rng = np.random.default_rng(3)
        total_bytes = 0
        for m in range(num_maps):
            keys = rng.integers(0, 2**63, rows_per_map, dtype=np.uint64)
            payload = rng.integers(0, 255, (rows_per_map, payload_bytes),
                                   dtype=np.uint64).astype(np.uint8)
            total_bytes += keys.nbytes + payload.nbytes
            w = execs[0].get_writer(handle, m)
            w.write_batch(keys, payload)
            w.close()

        # delay shim: every grouped data read pays a fixed service
        # latency on the serving executor, the wire/serving-CPU RTT of a
        # real deployment (fetch_bench precedent). The fused plane never
        # issues such requests, which is the thing being measured.
        ep = execs[0].executor
        orig = ep._on_fetch_blocks
        ep._on_fetch_blocks = lambda msg: (time.sleep(delay_s), orig(msg))[1]

        def host_reduce():
            per_part = []
            for p in range(num_partitions):
                reader = TpuShuffleReader(
                    execs[1].executor, execs[1].resolver,
                    TpuShuffleConf(**conf_kw), handle.shuffle_id,
                    num_maps, p, p + 1, payload_bytes)
                per_part.append(reader.read_sorted())
            return per_part

        def fused_reduce():
            results = run_mesh_reduce_fused(
                [execs[0]], handle, mesh, out_factor=2 * max(
                    1, -(-n_dev // max(1, min(num_partitions, n_dev)))),
                expect_maps=num_maps)
            return split_by_partition(results, num_partitions,
                                      payload_bytes)

        # warm both sides once (fused builds and loads the kernel here;
        # host pays connection dial + location sync): steady state is
        # what a multi-stage job sees
        host_parts = host_reduce()
        fused_parts = fused_reduce()

        host_wall = min(_timed(host_reduce) for _ in range(reps))
        fused_wall = min(_timed(fused_reduce) for _ in range(reps))

        identical = all(
            np.array_equal(_canon(*host_parts[p]), _canon(*fused_parts[p]))
            for p in range(num_partitions))
        return {
            "wall_s": {"host": round(host_wall, 4),
                       "fused": round(fused_wall, 4)},
            "speedup": round(host_wall / fused_wall, 3) if fused_wall
            else 0.0,
            "identical": identical,
            "bytes": total_bytes,
            "delay_s": delay_s,
            "devices": n_dev,
        }
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
