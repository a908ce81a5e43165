"""Multi-tenant isolation + sustained-traffic bench harness.

Two measurements back the tenancy tentpole (ROADMAP item 1):

* :func:`run_isolation_microbench` — the fairness A/B the
  ``tenant_isolation_speedup`` secondary and the tier-1 acceptance gate
  share. An ANTAGONIST tenant saturates one executor's serve path with
  a sustained backlog of wide fan-in reads while a VICTIM tenant issues
  small latency-sensitive fetches; the victim's per-read p99 is
  measured under FIFO serving vs deficit-round-robin fair share, same
  process, same data, byte-identical results. On CPU loopback the
  per-request service time is invisible, so — the fetch_bench/
  merge_bench precedent — a serve-side delay shim charges each
  dispatched request a deterministic cost proportional to its bytes
  (the stand-in for the disk/NIC time a real server pays). Fairness
  changes ONLY dispatch order, so the shim prices exactly what DRR
  schedules.

* :func:`run_sustained_bench` — the "millions of users" harness the
  repo lacked: N tenants submit terasort-, pagerank-, and join-shaped
  jobs at a target arrival rate through the admission-controlled
  driver for a fixed duration. Reported as aggregate rows/s and
  per-tenant job p99, with every completed job verified byte-identical
  to its own input, admission accounting closed (accepted + rejected
  == submitted), and ZERO cross-tenant cache evictions.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle import dist_cache
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec, TpuShuffleManager
from sparkrdma_tpu_torch.shuffle.tenancy import AdmissionRejected

VICTIM, ANTAGONIST = 1, 2


def _canon_rows(keys: np.ndarray, payload: np.ndarray) -> np.ndarray:
    rows = np.concatenate(
        [keys[:, None].view(np.uint8).reshape(len(keys), 8),
         payload.reshape(len(keys), -1)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _write(driver, owner, sid, tenant, num_maps, rows, payload_w, parts,
           seed):
    handle = driver.register_shuffle(sid, num_maps, parts,
                                     PartitionerSpec("modulo"),
                                     row_payload_bytes=payload_w,
                                     tenant=tenant)
    rng = np.random.default_rng(seed)
    for m in range(num_maps):
        w = owner.get_writer(handle, m)
        w.write_batch(rng.integers(0, 1 << 32, rows).astype(np.uint64),
                      rng.integers(0, 255, (rows, payload_w)
                                   ).astype(np.uint8))
        w.close()
    return handle


def run_isolation_microbench(spill_root: str,
                             victim_reads: int = 30,
                             victim_maps: int = 2,
                             victim_rows: int = 256,
                             antag_maps: int = 16,
                             antag_rows: int = 8192,
                             antag_threads: int = 3,
                             serve_delay_s_per_kb: float = 8e-5,
                             seed: int = 0) -> Dict:
    """Victim-tenant p99 under an antagonist: FIFO vs fair share.

    Returns::

        {"p99_ms": {"fifo": x, "fair": x}, "speedup": fifo/fair,
         "mean_ms": {...}, "identical": bool, "solo_identical": bool,
         "cross_tenant_evictions": 0, "fair_served": {tenant: n},
         "antag_reads": {"fifo": n, "fair": n}, ...}
    """
    conf_kw = dict(connect_timeout_ms=20000, use_cpp_runtime=False,
                   pre_warm_connections=True, serve_threads=1,
                   shuffle_read_block_size="64k",
                   max_vectored_bytes="64k", read_ahead_depth=8,
                   fair_share_serving=True,
                   fair_share_quantum_bytes="64k")
    driver = TpuShuffleManager(TpuShuffleConf(**conf_kw), is_driver=True)
    server = TpuShuffleManager(
        TpuShuffleConf(**conf_kw), driver_addr=driver.driver_addr,
        executor_id="srv", spill_dir=os.path.join(spill_root, "tsrv"))
    client = TpuShuffleManager(
        TpuShuffleConf(**conf_kw), driver_addr=driver.driver_addr,
        executor_id="cli", spill_dir=os.path.join(spill_root, "tcli"))
    try:
        for ex in (server, client):
            ex.executor.wait_for_members(2)
        payload_w = 8
        h_victim = _write(driver, server, 1, VICTIM, victim_maps,
                          victim_rows, payload_w, 4, seed)
        h_antag = _write(driver, server, 2, ANTAGONIST, antag_maps,
                         antag_rows, payload_w, 4, seed + 1)

        # serve-cost shim on the SERVING executor: every dispatched data
        # request pays its byte-proportional service time. Installed on
        # _serve_blocks, i.e. AFTER scheduling (FIFO pool order or DRR
        # dispatch), so both modes price identical work in the order
        # they actually chose.
        ep = server.executor
        orig_serve = ep._serve_blocks

        def shim(conn, msg):
            nbytes = sum(length for _, _, length in msg.blocks)
            time.sleep(serve_delay_s_per_kb * (nbytes / 1024.0))
            return orig_serve(conn, msg)

        ep._serve_blocks = shim

        def victim_read():
            return client.get_reader(h_victim, 0, 4).read_all()

        def antag_read():
            return client.get_reader(h_antag, 0, 4).read_all()

        # solo baseline: the victim's bytes with a quiet serve path
        solo_k, solo_p = victim_read()
        solo = _canon_rows(solo_k, solo_p)
        antag_solo_k, antag_solo_p = antag_read()
        antag_solo = _canon_rows(antag_solo_k, antag_solo_p)

        stop = threading.Event()
        antag_reads: Dict[str, int] = {}
        antag_canon: Dict[str, Optional[np.ndarray]] = {}

        def antagonist(mode: str):
            # sustained wide fan-in: full re-reads back to back keep
            # read_ahead_depth requests queued on the serve path
            while not stop.is_set():
                k, p = antag_read()
                antag_reads[mode] = antag_reads.get(mode, 0) + 1
                if antag_canon.get(mode) is None:
                    antag_canon[mode] = _canon_rows(k, p)

        lat_ms: Dict[str, List[float]] = {}
        canon: Dict[str, np.ndarray] = {}
        for mode in ("fifo", "fair"):
            # flip ONLY the serving discipline, same cluster, same data
            ep.conf.fair_share_serving = (mode == "fair")
            stop.clear()
            antag_reads[mode] = 0
            antag_canon[mode] = None
            threads = [threading.Thread(target=antagonist, args=(mode,),
                                        daemon=True)
                       for _ in range(antag_threads)]
            for t in threads:
                t.start()
            time.sleep(0.3)  # let the backlog build
            lat = []
            ks, ps = [], []
            for _ in range(victim_reads):
                t0 = time.perf_counter()
                k, p = victim_read()
                lat.append((time.perf_counter() - t0) * 1000)
                ks.append(k)
                ps.append(p)
            stop.set()
            for t in threads:
                t.join(timeout=30)
            lat_ms[mode] = lat
            # every victim read in this mode must return the solo bytes
            canon[mode] = _canon_rows(ks[-1], ps[-1])
            for k, p in zip(ks, ps):
                if not np.array_equal(_canon_rows(k, p), solo):
                    canon[mode] = np.zeros((0, 16), dtype=np.uint8)
                    break

        p99 = {m: float(np.percentile(v, 99)) for m, v in lat_ms.items()}
        mean = {m: float(np.mean(v)) for m, v in lat_ms.items()}
        identical = (np.array_equal(canon["fifo"], solo)
                     and np.array_equal(canon["fair"], solo)
                     and all(antag_canon[m] is not None
                             and np.array_equal(antag_canon[m], antag_solo)
                             for m in ("fifo", "fair")))
        return {
            "p99_ms": {m: round(v, 3) for m, v in p99.items()},
            "mean_ms": {m: round(v, 3) for m, v in mean.items()},
            "speedup": (round(p99["fifo"] / p99["fair"], 2)
                        if p99["fair"] else 0.0),
            "identical": bool(identical),
            "antag_reads": dict(antag_reads),
            "victim_reads": victim_reads,
            "fair_served": dict(ep.fair_served),
            "drr_reordered": (ep._serve_drr.reordered
                              if ep._serve_drr is not None else 0),
            "cross_tenant_evictions": dist_cache.cross_tenant_evictions,
            "serve_delay_s_per_kb": serve_delay_s_per_kb,
        }
    finally:
        client.stop()
        server.stop()
        driver.stop()


# -- sustained-traffic driver --------------------------------------------


class _TenantStats:
    def __init__(self):
        self.latencies_ms: List[float] = []
        self.rows = 0
        self.completed = 0
        self.shed = 0
        self.mismatches = 0
        self.lock = threading.Lock()


def _job_rows(kind: str, rows: int) -> int:
    return rows * (2 if kind == "join" else 1)


def run_sustained_bench(spill_root: str,
                        tenants: int = 3,
                        duration_s: float = 3.0,
                        arrival_hz: float = 6.0,
                        rows_per_map: int = 512,
                        num_maps: int = 2,
                        max_outstanding: int = 4,
                        metadata_shards: int = 2,
                        shard_ownership: bool = True,
                        seed: int = 0) -> Dict:
    """N tenants submit terasort/pagerank/join jobs at ``arrival_hz``
    each through the admission-controlled driver for ``duration_s``.

    Registrations flow through the SHARDED control plane by default
    (``metadata_shards``/``shard_ownership``): every register assigns a
    shard map and every publish takes the direct-to-owner path, so this
    bench doubles as the sustained-traffic soak for partitioned
    metadata ownership (``shard_batches`` in the result records the
    owner->driver convergence actually happening).

    Returns aggregate rows/s, per-tenant p99 job latency, admission
    accounting, and the zero-cross-tenant-eviction gate."""
    conf_kw = dict(connect_timeout_ms=20000, use_cpp_runtime=False,
                   pre_warm_connections=True,
                   admission_max_inflight=2, admission_queue_depth=1,
                   admission_retry_after_ms=200,
                   warm_read_cache=True, dist_cache_budget="64k",
                   metadata_shards=metadata_shards,
                   shard_ownership=shard_ownership)
    driver = TpuShuffleManager(TpuShuffleConf(**conf_kw), is_driver=True)
    execs = [TpuShuffleManager(
        TpuShuffleConf(**conf_kw), driver_addr=driver.driver_addr,
        executor_id=str(i), spill_dir=os.path.join(spill_root, f"s{i}"))
        for i in range(2)]
    try:
        for ex in execs:
            ex.executor.wait_for_members(2)
        parts = 4
        payload_w = 8
        stats = {t: _TenantStats() for t in range(1, tenants + 1)}
        submitted = {t: 0 for t in stats}
        sid_counter = {t: 0 for t in stats}
        kinds = ("terasort", "pagerank", "join")

        def run_job(tenant: int, kind: str, job_seed: int):
            st = stats[tenant]
            sid_counter[tenant] += 1
            sid = tenant * 100_000 + sid_counter[tenant]
            t0 = time.perf_counter()
            rng = np.random.default_rng(job_seed)
            handles = []
            try:
                n_shuffles = 2 if kind == "join" else 1
                written = []
                for j in range(n_shuffles):
                    h = driver.register_shuffle(
                        sid + j * 50_000, num_maps, parts,
                        PartitionerSpec("modulo"),
                        row_payload_bytes=payload_w, tenant=tenant)
                    handles.append(h)
                    keys = rng.integers(0, 1 << 20,
                                        num_maps * rows_per_map
                                        ).astype(np.uint64)
                    payload = rng.integers(
                        0, 255, (len(keys), payload_w)).astype(np.uint8)
                    written.append((keys, payload))
                    for m in range(num_maps):
                        w = execs[m % 2].get_writer(h, m)
                        s = slice(m * rows_per_map, (m + 1) * rows_per_map)
                        w.write_batch(keys[s], payload[s])
                        w.close()
                got_rows = 0
                ok = True
                supersteps = 2 if kind == "pagerank" else 1
                for h, (keys, payload) in zip(handles, written):
                    for _ in range(supersteps):
                        reader = execs[(tenant + 1) % 2].get_reader(h, 0,
                                                                    parts)
                        if kind == "terasort":
                            k, p = reader.read_sorted()
                            ok &= bool((np.diff(k.astype(np.int64))
                                        >= 0).all())
                        else:
                            k, p = reader.read_all()
                        got_rows += len(k)
                    ok &= np.array_equal(_canon_rows(k, p),
                                         _canon_rows(keys, payload))
                for j, h in enumerate(handles):
                    driver.unregister_shuffle(h.shuffle_id)
                with st.lock:
                    st.completed += 1
                    st.rows += got_rows
                    st.latencies_ms.append(
                        (time.perf_counter() - t0) * 1000)
                    if not ok:
                        st.mismatches += 1
            except AdmissionRejected:
                # a join job's SECOND register can reject after its
                # first was admitted: shed cleanly, nothing leaks
                for h in handles:
                    driver.unregister_shuffle(h.shuffle_id)
                with st.lock:
                    st.shed += 1

        job_threads: List[threading.Thread] = []

        def tenant_loop(tenant: int):
            # a Poisson-ish open-loop arrival process: one job every
            # 1/arrival_hz regardless of completions, up to the local
            # outstanding bound (beyond it the submission itself sheds)
            period = 1.0 / arrival_hz
            deadline = time.monotonic() + duration_s
            i = 0
            while time.monotonic() < deadline:
                live = [t for t in job_threads
                        if t.is_alive() and t.name == f"job-{tenant}"]
                submitted[tenant] += 1
                if len(live) >= max_outstanding:
                    with stats[tenant].lock:
                        stats[tenant].shed += 1
                else:
                    kind = kinds[i % len(kinds)]
                    t = threading.Thread(
                        target=run_job,
                        args=(tenant, kind,
                              seed * 1000 + tenant * 100 + i),
                        name=f"job-{tenant}", daemon=True)
                    job_threads.append(t)
                    t.start()
                i += 1
                time.sleep(period)

        t_start = time.perf_counter()
        loops = [threading.Thread(target=tenant_loop, args=(t,),
                                  daemon=True) for t in stats]
        for t in loops:
            t.start()
        for t in loops:
            t.join()
        for t in job_threads:
            t.join(timeout=60)
        wall_s = time.perf_counter() - t_start

        total_rows = sum(st.rows for st in stats.values())
        completed = sum(st.completed for st in stats.values())
        shed = sum(st.shed for st in stats.values())
        adm = driver.driver.admission.snapshot()
        return {
            "aggregate_rows_per_s": round(total_rows / wall_s, 0),
            "per_tenant_p99_ms": {
                t: (round(float(np.percentile(st.latencies_ms, 99)), 2)
                    if st.latencies_ms else None)
                for t, st in stats.items()},
            "jobs": {"submitted": sum(submitted.values()),
                     "completed": completed, "shed": shed},
            "identical": all(st.mismatches == 0 for st in stats.values()),
            "admission": adm,
            "cross_tenant_evictions": dist_cache.cross_tenant_evictions,
            "cache_evicted": dist_cache.stats()["evicted"],
            "wall_s": round(wall_s, 2),
            "tenants": tenants,
            "arrival_hz": arrival_hz,
            "metadata_shards": metadata_shards,
            "shard_batches": driver.driver.shard_batches,
            "shard_handoffs": driver.driver.shard_handoffs,
        }
    finally:
        for ex in execs:
            ex.stop()
        driver.stop()
