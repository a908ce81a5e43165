"""Skewed-workload microbench: the adaptive reduce planner's win, measured.

Real skewed traffic (zipfian keys, hot joins) makes one reducer the
stage straggler while the rest idle — the reduce stage's wall-clock is
the HOT partition's cost, not the mean. The planner splits the hot
partition across reducers by map-range and coalesces the tiny tail, so
the stage's makespan drops toward ``total / workers``.

Harness shape (same philosophy as ``fetch_bench``/``iter_bench``: a real
driver + multi-executor cluster over loopback, a deterministic cost shim
where loopback hides the real-world cost): per-task reduce COMPUTE is
modeled as ``bytes x compute_rate`` (the sort/merge work a reducer does
scales with its input bytes — exactly the cost that makes a hot
partition a straggler), and both plans run IN THE SAME PROCESS on the
same worker pool, so the reported ratio cancels host noise the way
``dense_exchange_guard`` does. The byte counts, plan shape, and
``identical`` parity gate are exact regardless of timing.

Two generators, the skew shapes named by ROADMAP item 3:

* ``zipfian_keys`` — zipf-distributed terasort keys (one hot partition
  holding most of the bytes plus a long tiny tail);
* ``skewed_join_keys`` — a join's probe side where one hot key carries
  most of the rows (the hot-join shape).

Shared by ``bench.py`` (the ``skew_speedup`` secondary), the tier-1
acceptance test (>= 1.5x, byte-identical, identity plan on uniform
input), and ``scripts/run_skew_bench.sh``'s seed sweep.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.planner import identity_plan, reduce_balance


def zipfian_keys(n: int, num_partitions: int, a: float = 2.0,
                 seed: int = 0) -> np.ndarray:
    """Zipf-distributed terasort keys: rank r appears with p ~ r^-a, so
    rank 1 (and with it partition ``1 % num_partitions`` under the
    modulo partitioner) carries most of the mass — a ~60% hot partition
    at a=2.0 — while high ranks form the tiny coalescable tail."""
    rng = np.random.default_rng(seed)
    return rng.zipf(a, size=n).astype(np.uint64)


def skewed_join_keys(n: int, num_partitions: int, hot_frac: float = 0.6,
                     seed: int = 0) -> np.ndarray:
    """A skewed join's probe-side keys: ``hot_frac`` of the rows share
    ONE hot key (the celebrity-row shape of production joins); the rest
    spread uniformly over the key space."""
    rng = np.random.default_rng(seed)
    hot_key = np.uint64(1)
    uniform = rng.integers(0, num_partitions * 64, size=n,
                           dtype=np.uint64)
    return np.where(rng.random(n) < hot_frac, hot_key, uniform)


_GENERATORS = {"terasort": zipfian_keys, "join": skewed_join_keys}


def run_skew_microbench(spill_root: str, workload: str = "terasort",
                        num_maps: int = 6, num_partitions: int = 16,
                        rows_per_map: int = 4000,
                        payload_bytes: int = 24,
                        workers: int = 4,
                        compute_s_per_mb: float = 2.0,
                        seed: int = 0,
                        uniform: bool = False,
                        reps: int = 2) -> Dict:
    """Measure the reduce stage's makespan under the static plan (one
    reducer per partition) vs the adaptive plan (coalesce + split +
    placement), same process, same worker pool. Returns::

        {"wall_s": {"static": s, "adaptive": s}, "skew_speedup": ratio,
         "identical": bool, "plan": counts, "is_identity": bool,
         "reduce_balance": {"static": x, "adaptive": y}, "bytes": total}

    ``identical`` is byte-level over the canonicalized (key-sorted) full
    stage output. With ``uniform=True`` the keys are uniform instead —
    the plan must come out as the identity plan (no regression for
    balanced workloads)."""
    import os

    gen = _GENERATORS[workload]
    row_bytes = 8 + payload_bytes
    # thresholds sized against the UNIFORM per-partition share: a
    # partition past 3x the share is hot (splits), one under half of it
    # is tiny (coalesces) — so a balanced dataset sits between the two
    # and must come out as the identity plan (the no-regression gate)
    share = (num_maps * rows_per_map * row_bytes) // num_partitions
    conf_kw = dict(connect_timeout_ms=20000, use_cpp_runtime=False,
                   pre_warm_connections=False, adaptive_plan=True,
                   split_threshold_bytes=max(1024, 3 * share),
                   coalesce_target_bytes=max(1, share // 2))
    conf = TpuShuffleConf(**conf_kw)
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(TpuShuffleConf(**conf_kw),
                               driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=os.path.join(spill_root, f"s{i}"))
             for i in range(3)]
    try:
        for ex in execs:
            ex.executor.wait_for_members(3)
        handle = driver.register_shuffle(
            3, num_maps, num_partitions, PartitionerSpec("modulo"),
            row_payload_bytes=payload_bytes)
        rng = np.random.default_rng(seed)
        for m in range(num_maps):
            if uniform:
                keys = np.arange(m, m + rows_per_map,
                                 dtype=np.uint64) % num_partitions
            else:
                keys = gen(rows_per_map, num_partitions,
                           seed=seed * 1000 + m)
            # every map commits on the REDUCER's executor: tasks read
            # through the local short-circuit, so the measured makespan
            # is the compute model's (the plan-balance win under test),
            # not loopback scheduling noise — the remote dataplanes'
            # parity for planned ranges has its own tests
            # (tests/test_planner.py sweeps all four combos)
            w = execs[0].get_writer(handle, m)
            w.write_batch(keys, rng.integers(
                0, 255, (len(keys), payload_bytes),
                dtype=np.uint64).astype(np.uint8))
            w.close()
        plan = driver.plan_reduce(handle)
        static = identity_plan(handle.shuffle_id, num_maps,
                               num_partitions)
        # all tasks read through ONE reducer-side manager so both plans
        # fetch every byte remotely under identical machinery; the
        # compute shim (bytes x rate — the sort/merge cost that makes a
        # hot reducer the straggler) is what the makespan measures
        reducer = execs[0]
        compute_rate = compute_s_per_mb / (1 << 20)
        hist = driver.driver.size_histogram(handle.shuffle_id)

        def est_bytes(task):
            return sum(hist.map_bytes(m, task.start_partition,
                                      task.end_partition)
                       for m in range(task.map_start, task.map_end))

        def run_stage(tasks):
            # longest-task-first dispatch for BOTH plans (what any
            # size-aware scheduler does); the histogram supplies the
            # estimates either way, so the comparison stays fair
            tasks = sorted(tasks, key=lambda t: (-est_bytes(t),
                                                 t.task_id))
            rows = {}
            task_bytes = {}

            def one(task):
                reader = reducer.get_reader(
                    handle, task.start_partition, task.end_partition,
                    map_range=(task.map_start, task.map_end))
                keys, payload = reader.read_all()
                nbytes = len(keys) * row_bytes
                time.sleep(nbytes * compute_rate)
                return task.task_id, keys, payload, nbytes

            pool = ThreadPoolExecutor(max_workers=workers)
            t0 = time.perf_counter()
            try:
                for tid, keys, payload, nbytes in pool.map(one, tasks):
                    rows[tid] = (keys, payload)
                    task_bytes[tid] = nbytes
            finally:
                pool.shutdown(wait=True)
            wall = time.perf_counter() - t0
            order = sorted(tasks, key=lambda t: (t.start_partition,
                                                 t.map_start))
            keys = np.concatenate([rows[t.task_id][0] for t in order])
            payload = np.concatenate([rows[t.task_id][1] for t in order])
            return wall, keys, payload, list(task_bytes.values())

        # warmup: one untimed pass resolves metadata into the warm
        # caches and dials every connection, so neither measured mode
        # pays cold-start costs the other skipped (the same reason
        # dense_exchange_guard warms before timing)
        for t in static.tasks:
            r = reducer.get_reader(handle, t.start_partition,
                                   t.end_partition)
            r.read_all()
        # best-of-``reps`` per mode (the fetch bench's convention): the
        # makespan model is deterministic, the best rep sheds scheduler
        # noise the same way for both modes
        results = {}
        for mode, p in (("static", static),
                        ("adaptive", plan if plan is not None else static)):
            best = None
            for _ in range(max(1, reps)):
                run = run_stage(p.tasks)
                if best is None or run[0] < best[0]:
                    best = run
            results[mode] = best

        def canonical(keys, payload):
            order = np.lexsort(
                tuple(payload[:, c] for c in
                      range(payload.shape[1] - 1, -1, -1)) + (keys,))
            return keys[order], payload[order]

        ks, ps = canonical(results["static"][1], results["static"][2])
        ka, pa = canonical(results["adaptive"][1], results["adaptive"][2])
        identical = bool(np.array_equal(ks, ka)
                         and np.array_equal(ps, pa))
        wall = {m: results[m][0] for m in results}
        return {
            "workload": workload,
            "wall_s": {m: round(t, 4) for m, t in wall.items()},
            "skew_speedup": (round(wall["static"] / wall["adaptive"], 3)
                             if wall["adaptive"] else 0.0),
            "identical": identical,
            "plan": plan.counts() if plan is not None else None,
            "is_identity": plan.is_identity if plan is not None else True,
            "reduce_balance": {
                m: round(reduce_balance(results[m][3]), 3)
                for m in results},
            "bytes": int(sum(results["static"][3])),
            "workers": workers,
        }
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()
