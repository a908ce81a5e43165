"""CLI: ``python -m sparkrdma_tpu_torch {info | config | selftest | demo |
engine-demo | engine-mesh-demo | rdd-demo | shuffle-service}``.

Port of ``sparkrdma_tpu/__main__.py``, name for name: the same handlers,
output lines and exit codes. The two commands that drive the device,
``demo`` and ``engine-mesh-demo``, run an 8-shard ``VirtualMesh`` on
``cuda`` and take one optional flag, ``--device`` (default ``cuda``), to
run elsewhere (``--device cpu``). Without a card and without that flag
they fail with ``resolve_device``'s message.
"""

import argparse
import json
import sys

SHARDS = 8  # the virtual mesh every path of the port uses on one card


def _device_flag(cmd: str, args) -> str:
    ap = argparse.ArgumentParser(prog=f"python -m sparkrdma_tpu_torch {cmd}")
    ap.add_argument("--device", default="cuda",
                    help="torch device the mesh lives on (default cuda)")
    return ap.parse_args(args).device


def _info(args=()) -> int:
    import sparkrdma_tpu_torch
    from sparkrdma_tpu_torch.runtime import native

    print(f"sparkrdma_tpu_torch {sparkrdma_tpu_torch.__version__}")
    print(f"native runtime: {'built' if native.available() else 'pure-Python fallback'}")
    import torch

    from sparkrdma_tpu_torch.parallel.mesh import resolve_device

    try:
        dev = resolve_device()
    except RuntimeError as e:
        print(f"devices: unavailable ({type(e).__name__})")
        return 0
    print(f"devices: {torch.cuda.device_count()} x "
          f"{torch.cuda.get_device_name(dev)} ({dev.type})")
    return 0


def _config(args=()) -> int:
    from sparkrdma_tpu_torch.config import TpuShuffleConf, _KEYS

    defaults = TpuShuffleConf().to_dict()
    for k in _KEYS:
        print(f"{k.name:40s} {str(defaults[k.name]):>12s}  {k.doc}")
    return 0


def _selftest(args=()) -> int:
    """In-process smoke test: 2-executor shuffle cycle + pool + staging."""
    import tempfile

    import numpy as np

    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.shuffle.manager import (
        PartitionerSpec,
        TpuShuffleManager,
    )

    conf = TpuShuffleConf()
    driver = TpuShuffleManager(conf, is_driver=True)
    execs = [TpuShuffleManager(conf, driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=tempfile.mkdtemp())
             for i in range(2)]
    try:
        for e in execs:
            e.executor.wait_for_members(2)
        handle = driver.register_shuffle(1, 2, 4, PartitionerSpec("hash"),
                                         row_payload_bytes=8)
        rng = np.random.default_rng(0)
        n = 0
        for m in range(2):
            w = execs[m].get_writer(handle, m)
            keys = rng.integers(0, 10_000, 5000).astype(np.uint64)
            w.write_batch(keys, rng.integers(0, 255, (5000, 8)).astype(np.uint8))
            w.close()
            n += len(keys)
        k, _ = execs[0].get_reader(handle, 0, 4).read_all()
        k2, _ = execs[1].get_reader(handle, 0, 4).read_all()
        assert len(k) == n and len(k2) == n, "row count mismatch"
        print(json.dumps({"selftest": "ok", "rows": n,
                          "native_server": execs[0].block_server is not None}))
        return 0
    finally:
        for e in execs:
            e.stop()
        driver.stop()


def _demo(args=()) -> int:
    """On-mesh TeraSort demo on an 8-shard mesh of the chosen device."""
    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig, generate_rows, run_terasort, verify_terasort)
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    mesh = VirtualMesh(SHARDS, _device_flag("demo", args))
    cfg = TeraSortConfig(rows_per_device=100_000, payload_words=4,
                         out_factor=2)
    rows = generate_rows(cfg, SHARDS)
    out, counts, dt = run_terasort(mesh, cfg, rows=rows)
    verify_terasort(out, counts, rows, SHARDS)
    print(json.dumps({"demo": "terasort", "rows": len(rows),
                      "devices": SHARDS, "step_s": round(dt, 4),
                      "verified": True}))
    return 0


def _engine_demo(use_mesh: bool = False, args=()) -> int:
    """Multi-stage TPC-DS star job through the DAG engine (drop-in SPI).
    With ``use_mesh``, reduce-side reads ride the device data plane
    (engine mesh mode over an 8-shard mesh) instead of the TCP fetcher,
    verified by the exchange dispatch counter."""
    import tempfile

    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.engine import DAGEngine
    from sparkrdma_tpu_torch.models.tpcds import (
        TpcdsConfig, build_tpcds_job, generate_star, numpy_tpcds)
    from sparkrdma_tpu_torch.shuffle.spark_compat import (
        SparkCompatShuffleManager,
    )

    mesh = None
    if use_mesh:
        from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

        # resolved first: without a card this raises before any cluster
        mesh = VirtualMesh(SHARDS, _device_flag("engine-mesh-demo", args))
    conf = TpuShuffleConf()
    driver = SparkCompatShuffleManager(conf, isDriver=True)
    execs = [SparkCompatShuffleManager(
        conf, driverAddr=driver.driverAddr, executorId=str(i),
        spill_dir=tempfile.mkdtemp()) for i in range(2)]
    exchanges = 0
    if use_mesh:
        from sparkrdma_tpu_torch.parallel import exchange as exchange_mod

        exchanges = exchange_mod.DATA_PLANE["exchanges"]
    try:
        for e in execs:
            e.native.executor.wait_for_members(2)
        cfg = TpcdsConfig(fact_rows_per_device=4096, dim1_size=256,
                          dim2_size=256, num_groups=64)
        job, finish = build_tpcds_job(cfg, num_maps=3, num_partitions=4,
                                      seed=1)
        engine = DAGEngine(driver, execs, mesh=mesh)
        counts, sums = finish(engine.run(job))
        fact, d1, d2 = generate_star(cfg, 1, seed=1)
        want_c, want_s = numpy_tpcds(fact, d1, d2, cfg.num_groups)
        ok = (counts == want_c).all() and (sums == want_s).all()
        record = {"demo": "tpcds-engine", "joined_rows": int(counts.sum()),
                  "groups": cfg.num_groups, "oracle_exact": bool(ok)}
        if use_mesh:
            from sparkrdma_tpu_torch.parallel import exchange as exchange_mod

            record["data_plane"] = "mesh"
            record["collective_exchanges"] = (
                exchange_mod.DATA_PLANE["exchanges"] - exchanges)
            ok = ok and record["collective_exchanges"] > 0
        print(json.dumps(record))
        return 0 if ok else 1
    finally:
        for e in execs:
            e.stop()
        driver.stop()


def _shuffle_service(args=()) -> int:
    """Standalone shuffle service: adopt a dead executor's spill
    directory and serve its COMMITTED map outputs so reducers finish
    without recomputation, the role Spark's external shuffle service
    plays. Committed spills are plain files + sidecar indexes, so any
    process can re-register them.

    Usage:
      python -m sparkrdma_tpu_torch shuffle-service DRIVER_HOST:PORT \\
          SPILL_DIR [SERVICE_ID]
    """
    import signal
    import threading

    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.shuffle.manager import TpuShuffleManager

    if len(args) < 2 or ":" not in args[0] \
            or not args[0].rsplit(":", 1)[1].isdigit():
        print(_shuffle_service.__doc__)
        return 2
    host, port = args[0].rsplit(":", 1)
    spill_dir = args[1]
    service_id = args[2] if len(args) > 2 else "shuffle-svc"
    mgr = TpuShuffleManager(TpuShuffleConf(), driver_addr=(host, int(port)),
                            executor_id=service_id, spill_dir=spill_dir)
    recovered = mgr.recover_and_republish()
    n_maps = sum(len(v) for v in recovered.values())
    print(f"shuffle-service {service_id}: serving {n_maps} recovered map "
          f"outputs across {len(recovered)} shuffles from {spill_dir}",
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    mgr.stop()
    return 0


def _rdd_demo(args=()) -> int:
    """Word-count + global sort through the RDD API (the pyspark-shaped
    front half) over a 3-executor in-process cluster: textFile ->
    flatMap -> reduceByKey (map-side combine) -> sortByKey ->
    saveAsTextFile, every shuffle through the full SPI underneath."""
    import os
    import tempfile

    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.engine import DAGEngine
    from sparkrdma_tpu_torch.rdd import EngineContext
    from sparkrdma_tpu_torch.shuffle.spark_compat import (
        SparkCompatShuffleManager,
    )

    conf = TpuShuffleConf()
    driver = SparkCompatShuffleManager(conf, isDriver=True)
    execs = [SparkCompatShuffleManager(
        conf, driverAddr=driver.driverAddr, executorId=str(i),
        spill_dir=tempfile.mkdtemp()) for i in range(3)]
    try:
        for e in execs:
            e.native.executor.wait_for_members(3)
        workdir = tempfile.mkdtemp()
        src = os.path.join(workdir, "input.txt")
        vocab = ["shuffle", "exchange", "mesh", "ici", "spill", "stage"]
        with open(src, "w") as f:
            for i in range(5000):
                f.write(vocab[i * 7 % len(vocab)] + " "
                        + vocab[i * 3 % len(vocab)] + "\n")
        ctx = EngineContext(DAGEngine(driver, execs))
        out = os.path.join(workdir, "counts")
        (ctx.text_file(src, 6)
            .flat_map(str.split)
            .map(lambda w: (w, 1))
            .reduce_by_key(lambda a, b: a + b, 4)
            .sort_by_key(2)
            .map(lambda kv: f"{kv[0]}\t{kv[1]}")
            .save_as_text_file(out))
        lines = []
        for part in sorted(os.listdir(out)):
            if part.startswith("part-"):
                with open(os.path.join(out, part)) as f:
                    lines += f.read().splitlines()
        total = sum(int(ln.split("\t")[1]) for ln in lines)
        print(json.dumps({"demo": "rdd-wordcount", "distinct_words":
                          len(lines), "total_words": total,
                          "sorted": lines == sorted(lines),
                          "verified": total == 10000
                          and len(lines) == len(vocab)}))
        return 0
    finally:
        for e in execs:
            e.stop()
        driver.stop()


def main(argv=None) -> int:
    """Run one command; ``argv`` is the command and its arguments
    (``sys.argv[1:]`` when None)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = argv[0] if argv else "info"
    handlers = {"info": _info, "config": _config,
                "selftest": _selftest, "demo": _demo,
                "engine-demo": lambda args: _engine_demo(False, args),
                "engine-mesh-demo": lambda args: _engine_demo(True, args),
                "rdd-demo": _rdd_demo,
                "shuffle-service": _shuffle_service}
    if cmd not in handlers:
        print(f"usage: python -m sparkrdma_tpu_torch {{{' | '.join(handlers)}}}")
        return 2
    return handlers[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
