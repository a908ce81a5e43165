"""The port's ``DAGEngine`` in mesh mode against the JAX package's.

``tests/test_engine_mesh.py``'s four cases (a job riding the mesh in one
shot and in rounds, an executor lost after the map stage, a two-table
join, remote executors refused) run on the port's engine over
``VirtualMesh(8, "cpu")`` and on the JAX engine over the conftest's
8-device CPU mesh, each on a cluster of its own package's managers; the
task results must be equal, and equal to the host truth. The port side
must also dispatch exchanges (``exchange.DATA_PLANE``), build no TCP
fetcher and read no remote byte. The ring transport, the card's default,
keeps a partition-contiguous stage on the device plane. Also: the
README's ``EngineContext``
word count and ``BatchRDD.sort_by_key`` on both engines, a receive
overflow that degrades its stage to the host plane, and distributed
mesh mode refused."""

import logging
import time

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from sparkrdma_tpu import engine as jengine
from sparkrdma_tpu import rdd as jrdd
from sparkrdma_tpu.config import TpuShuffleConf as JConf
from sparkrdma_tpu.shuffle import manager as jmanager
from sparkrdma_tpu.shuffle import spark_compat as jcompat
from sparkrdma_tpu_torch import engine as tengine
from sparkrdma_tpu_torch import rdd as trdd
from sparkrdma_tpu_torch.config import TpuShuffleConf as TConf
from sparkrdma_tpu_torch.parallel import exchange as texchange
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.shuffle import fetcher as tfetcher
from sparkrdma_tpu_torch.shuffle import manager as tmanager
from sparkrdma_tpu_torch.shuffle import spark_compat as tcompat
from sparkrdma_tpu_torch.tasks import RemoteExecutor
from sparkrdma_tpu_torch.utils.trace import Tracer

D = 8
PKGS = {"jax": (jengine, jmanager, jcompat, JConf),
        "port": (tengine, tmanager, tcompat, TConf)}


def _make_cluster(pkg, tmp, n=3):
    """(driver, executors) of ``pkg`` with membership settled."""
    _, _, compat, conf_cls = PKGS[pkg]
    conf = conf_cls(connect_timeout_ms=1000, max_connection_attempts=2)
    driver = compat.SparkCompatShuffleManager(conf, isDriver=True)
    execs = [compat.SparkCompatShuffleManager(
        conf, driverAddr=driver.driverAddr, executorId=str(i),
        spill_dir=str(tmp / f"{pkg}_e{i}")) for i in range(n)]
    for ex in execs:
        ex.native.executor.wait_for_members(n)
    return driver, execs


def _stop(driver, execs):
    for ex in execs:
        ex.stop()
    driver.stop()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """One cluster per package for the whole module."""
    tmp = tmp_path_factory.mktemp("torch_engine")
    made = {}
    try:
        for pkg in PKGS:
            made[pkg] = _make_cluster(pkg, tmp)
        yield made
    finally:
        for driver, execs in made.values():
            _stop(driver, execs)


@pytest.fixture(scope="module")
def meshes():
    return {"jax": Mesh(np.array(jax.devices()[:D]), ("shuffle",)),
            "port": VirtualMesh(D, "cpu")}


def _u32_payload(values) -> np.ndarray:
    return np.ascontiguousarray(values, dtype="<u4").view(
        np.uint8).reshape(-1, 4)


def _payload_u32(payload: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(payload).view("<u4").ravel()


def _table(seed: int, rows: int, key_space: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_space, size=rows).astype(np.uint64)
    vals = rng.integers(0, 1000, size=rows).astype(np.uint32)
    return keys, vals


def _no_tcp_fetchers(monkeypatch):
    """A counter that ticks if the port builds any TCP fetcher."""
    built = {"n": 0}
    orig = tfetcher.ShuffleFetcher.__init__

    def spy(self, *a, **kw):
        built["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(tfetcher.ShuffleFetcher, "__init__", spy)
    return built


def _sum_job(pkg, P, maps, rows, key_space, seed):
    """The sum-by-partition job of ``test_engine_mesh.py``: each reduce
    returns (sum of values, rows, remote bytes read)."""
    eng, manager, compat, _ = PKGS[pkg]

    def map_fn(ctx, writer, task_id):
        keys, vals = _table(seed + task_id, rows, key_space)
        writer.write((keys, _u32_payload(vals)))

    def reduce_fn(ctx, task_id):
        reader = ctx.read(0)
        total = n = 0
        for keys, payload in reader.readBatches():
            total += int(_payload_u32(payload).astype(np.int64).sum())
            n += len(keys)
        return total, n, reader.metrics.remote_bytes

    stage = eng.MapStage(maps, compat.ShuffleDependency(
        P, manager.PartitionerSpec("modulo"), row_payload_bytes=4), map_fn)
    return eng.ResultStage(P, reduce_fn, parents=[stage])


@pytest.mark.parametrize("rows_per_round", [0, 256])
def test_engine_job_rides_mesh(clusters, meshes, monkeypatch,
                               rows_per_round):
    P, maps, rows, key_space, seed = 4, 6, 700, 5000, 100
    out = {}
    built = _no_tcp_fetchers(monkeypatch)
    before = texchange.DATA_PLANE["exchanges"]
    for pkg in PKGS:
        driver, execs = clusters[pkg]
        engine = PKGS[pkg][0].DAGEngine(driver, execs, mesh=meshes[pkg],
                                        mesh_rows_per_round=rows_per_round)
        out[pkg] = engine.run(_sum_job(pkg, P, maps, rows, key_space, seed))
    assert out["port"] == out["jax"]
    want = [0] * P
    for m in range(maps):
        keys, vals = _table(seed + m, rows, key_space)
        for p in range(P):
            want[p] += int(vals[keys % P == p].astype(np.int64).sum())
    assert [t for t, _, _ in out["port"]] == want
    assert sum(n for _, n, _ in out["port"]) == maps * rows
    assert all(remote == 0 for _, _, remote in out["port"])
    moved = texchange.DATA_PLANE["exchanges"] - before
    assert moved > (1 if rows_per_round else 0), \
        "the port's job did not ride the mesh"
    assert built["n"] == 0, "TCP fetcher constructed in mesh mode"


@pytest.mark.parametrize("rows_per_round", [0, 256])
def test_engine_job_on_the_ring_stays_on_the_device(clusters, meshes,
                                                    monkeypatch,
                                                    rows_per_round):
    """The card's transport (``mesh_impl="ring"``, its plain version on
    the CPU) over 4 partitions: committed outputs are partition-contiguous,
    so a round's source shard sends to one or two destinations, past the
    even slot share. Each round's slots fit its largest pair, so the stage
    stays on the device plane with no degrade, and its results equal the
    JAX engine's."""
    P, maps, rows, key_space, seed = 4, 6, 700, 5000, 100
    built = _no_tcp_fetchers(monkeypatch)
    out = {}
    for pkg in PKGS:
        driver, execs = clusters[pkg]
        kw = dict(mesh_impl="ring") if pkg == "port" else {}
        engine = PKGS[pkg][0].DAGEngine(driver, execs, mesh=meshes[pkg],
                                        mesh_rows_per_round=rows_per_round,
                                        **kw)
        if pkg == "port":
            engine.tracer = tracer = Tracer()
        out[pkg] = engine.run(_sum_job(pkg, P, maps, rows, key_space, seed))
    assert out["port"] == out["jax"]
    assert [e["args"]["plane"]
            for e in tracer.events("exchange.select")] == ["device"]
    assert [e["args"]["impl"]
            for e in tracer.events("exchange.select")] == ["ring"]
    assert tracer.events("exchange.degrade") == []
    assert all(remote == 0 for _, _, remote in out["port"])
    assert built["n"] == 0


def test_engine_mesh_survives_executor_loss(tmp_path, meshes, caplog):
    """An executor dies after the map stage: staging raises FetchFailed,
    the retry recomputes on survivors, and the reduce is exact, on
    clusters of their own (the loss would break the module's)."""
    caplog.set_level(logging.WARNING)
    P, maps, rows, key_space, seed = 4, 6, 500, 5000, 9100
    got = {}
    for pkg in PKGS:
        driver, execs = _make_cluster(pkg, tmp_path)
        try:
            eng, manager, compat, _ = PKGS[pkg]
            killed = {"done": False}

            def map_fn(ctx, writer, task_id):
                keys, vals = _table(seed + task_id, rows, key_space)
                writer.write((keys, _u32_payload(vals)))

            def reduce_fn(ctx, task_id, _execs=execs, _driver=driver,
                          _killed=killed):
                if task_id == 0 and not _killed["done"]:
                    _killed["done"] = True
                    victim = _execs[1].native
                    mid = victim.executor.manager_id
                    victim.executor.stop()
                    _driver.native.driver.remove_member(mid)
                    time.sleep(0.3)
                total = 0
                for _, payload in ctx.read(0).readBatches():
                    total += int(_payload_u32(payload).astype(np.int64).sum())
                return total

            stage = eng.MapStage(maps, compat.ShuffleDependency(
                P, manager.PartitionerSpec("modulo"), row_payload_bytes=4),
                map_fn)
            engine = eng.DAGEngine(driver, execs, mesh=meshes[pkg],
                                   max_parallel_tasks=1)
            got[pkg] = engine.run(eng.ResultStage(P, reduce_fn,
                                                  parents=[stage]))
            assert killed["done"], "failure injection never ran"
        finally:
            _stop(driver, execs)
    assert got["port"] == got["jax"]
    want = sum(int(_table(seed + m, rows, key_space)[1].astype(
        np.int64).sum()) for m in range(maps))
    assert sum(got["port"]) == want
    recovered = [r for r in caplog.records
                 if "recovering shuffle" in r.message]
    assert {r.name.split(".")[0] for r in recovered} == {
        "sparkrdma_tpu", "sparkrdma_tpu_torch"}


def test_engine_mesh_two_table_join(clusters, meshes, monkeypatch):
    """Two parent shuffles read by one stage, both reduced on the mesh."""
    P, maps, rows, key_space = 4, 3, 400, 64
    built = _no_tcp_fetchers(monkeypatch)
    got = {}
    for pkg in PKGS:
        eng, manager, compat, _ = PKGS[pkg]

        def writer_fn(base_seed):
            def fn(ctx, writer, task_id):
                keys, vals = _table(base_seed + task_id, rows, key_space)
                writer.write((keys, _u32_payload(vals)))
            return fn

        def join_fn(ctx, task_id):
            lk, lp = ctx.read(0)._r.read_all()
            rk, rp = ctx.read(1)._r.read_all()
            lv, rv = _payload_u32(lp), _payload_u32(rp)
            return sum(int(lv[lk == k].astype(np.int64).sum()
                           * rv[rk == k].astype(np.int64).sum())
                       for k in np.unique(lk))

        def dep():
            return compat.ShuffleDependency(
                P, manager.PartitionerSpec("modulo"), row_payload_bytes=4)

        left = eng.MapStage(maps, dep(), writer_fn(7000))
        right = eng.MapStage(maps, dep(), writer_fn(8000))
        driver, execs = clusters[pkg]
        engine = eng.DAGEngine(driver, execs, mesh=meshes[pkg])
        got[pkg] = engine.run(eng.ResultStage(P, join_fn,
                                              parents=[left, right]))
    assert got["port"] == got["jax"]
    tables = {s: [_table(s + m, rows, key_space) for m in range(maps)]
              for s in (7000, 8000)}
    lk, lv = (np.concatenate(c) for c in zip(*tables[7000]))
    rk, rv = (np.concatenate(c) for c in zip(*tables[8000]))
    want = sum(int(lv[lk == k].astype(np.int64).sum()
                   * rv[rk == k].astype(np.int64).sum())
               for k in np.unique(lk))
    assert sum(got["port"]) == want
    assert built["n"] == 0


def test_engine_mesh_rejects_remote_executors(clusters, meshes):
    driver, execs = clusters["port"]
    fake = RemoteExecutor.__new__(RemoteExecutor)
    with pytest.raises(ValueError, match="in-process"):
        tengine.DAGEngine(driver, [*execs, fake], mesh=meshes["port"])


def test_dist_mesh_mode_is_not_ported(clusters):
    driver, execs = clusters["port"]
    with pytest.raises(NotImplementedError, match="multihost"):
        tengine.DAGEngine(driver, execs, dist_mesh_axis="shuffle")


def test_word_count_matches_jax(clusters, meshes):
    """The README's ``EngineContext`` word count, under each mesh engine."""
    words = ("the quick brown fox jumps over the lazy dog the end "
             "a b a c a b d " * 7).split()
    got = {}
    for pkg, mod in (("jax", jrdd), ("port", trdd)):
        driver, execs = clusters[pkg]
        ctx = mod.EngineContext(PKGS[pkg][0].DAGEngine(
            driver, execs, mesh=meshes[pkg]))
        got[pkg] = dict(ctx.parallelize(words, 4)
                        .map(lambda w: (w, 1))
                        .reduceByKey(lambda a, b: a + b)
                        .collect())
    assert got["port"] == got["jax"]
    assert got["port"] == {w: words.count(w) for w in set(words)}


def test_sort_by_key_matches_jax(clusters, meshes):
    """``BatchRDD.sort_by_key`` under each mesh engine: the same
    partitions, each key-sorted by the mesh reduce itself."""
    rng = np.random.default_rng(21)
    parts = []
    for _ in range(3):
        keys = rng.integers(0, 2**64, 1500, dtype=np.uint64)
        parts.append((keys, rng.integers(0, 256, (1500, 6),
                                         dtype=np.uint8)))
    got = {}
    for pkg, mod in (("jax", jrdd), ("port", trdd)):
        driver, execs = clusters[pkg]
        ctx = mod.EngineContext(PKGS[pkg][0].DAGEngine(
            driver, execs, mesh=meshes[pkg]))
        got[pkg] = ctx.batches(parts).sort_by_key(4).collect_batches()
    assert len(got["port"]) == len(got["jax"]) == 4
    for (tk, tp), (jk, jp) in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tp, jp)
    keys = np.concatenate([k for k, _ in got["port"]])
    np.testing.assert_array_equal(keys, np.sort(np.concatenate(
        [k for k, _ in parts])))


def test_overflow_degrades_stage_to_host_plane(clusters, meshes,
                                               monkeypatch, caplog):
    """Every key in one partition: the port's receive overflows its
    headroom, the stage (not the job) is served by the host plane, and
    the result equals the JAX engine's."""
    caplog.set_level(logging.WARNING, logger="sparkrdma_tpu_torch.engine")
    P, maps, rows = 4, 4, 500
    built = _no_tcp_fetchers(monkeypatch)
    out, degraded, engines = {}, {}, {}
    for pkg in PKGS:
        eng, manager, compat, _ = PKGS[pkg]
        driver, execs = clusters[pkg]
        engine = engines[pkg] = eng.DAGEngine(driver, execs,
                                              mesh=meshes[pkg],
                                              dataplane="device")
        engine.tracer = Tracer() if pkg == "port" else engine.tracer

        def map_fn(ctx, writer, task_id):
            rng = np.random.default_rng(300 + task_id)
            keys = rng.integers(0, 1000, rows).astype(np.uint64) * P
            writer.write((keys, _u32_payload(
                rng.integers(0, 1000, rows).astype(np.uint32))))

        def reduce_fn(ctx, task_id, _pkg=pkg, _engine=engine):
            keys, payload = ctx.read(0)._r.read_all()
            # the degrade memo is dropped when the job ends: read it here
            degraded.setdefault(_pkg, {}).update(_engine._mesh_degraded)
            order = np.lexsort((_payload_u32(payload), keys))
            return keys[order].tobytes() + payload[order].tobytes()

        stage = eng.MapStage(maps, compat.ShuffleDependency(
            P, manager.PartitionerSpec("modulo"), row_payload_bytes=4),
            map_fn)
        out[pkg] = engine.run(eng.ResultStage(P, reduce_fn,
                                              parents=[stage]))
    assert out["port"] == out["jax"]
    assert list(degraded["port"].values()) == ["receive overflow"]
    assert built["n"] > 0, "the degrade never reached the host plane"
    events = engines["port"].tracer.events("exchange.degrade")
    assert [e["args"]["reason"] for e in events] == ["overflow"]
    assert any("host dataplane" in r.message for r in caplog.records)
    assert len(out["port"][0]) == maps * rows * 12
    assert out["port"][1:] == [b""] * (P - 1)
