"""The port's engine in DISTRIBUTED mesh mode, mirroring
``test_dist_engine.py`` test for test: executor processes of the port form
a 2-process ``torch.distributed`` group (gloo, 4 CPU shards each, through
``multihost.init_multihost``), and the DAG engine's reduce-side reads ride
ONE global-mesh exchange per parent shuffle. This file imports no JAX."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.engine import DAGEngine, MapStage, ResultStage
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec
from sparkrdma_tpu_torch.shuffle.spark_compat import (
    ShuffleDependency,
    SparkCompatShuffleManager,
)
from sparkrdma_tpu_torch.tasks import remote_executors

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv[6], when given, is seconds each exchange round of this process
# sleeps: it holds the collective open long enough for a kill to land in
# it (the JAX package's rounds take that long compiling)
_WORKER = f'''
import sys, time
sys.path.insert(0, {REPO_ROOT!r})
pid, coord, host, port, spill = (int(sys.argv[1]), sys.argv[2],
                                 sys.argv[3], int(sys.argv[4]), sys.argv[5])
from sparkrdma_tpu_torch.parallel import exchange, multihost
multihost.init_multihost(coord, num_processes=2, process_id=pid,
                         local_device_count=4, platform="cpu")
mesh = multihost.global_mesh()
assert mesh.num_shards == 8 and mesh.local_shards == 4
if len(sys.argv) > 6:
    pause, inner = float(sys.argv[6]), exchange.ragged_exchange_global
    def slowed(*a, **kw):
        time.sleep(pause)
        return inner(*a, **kw)
    exchange.ragged_exchange_global = slowed
from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.spark_compat import SparkCompatShuffleManager
from sparkrdma_tpu_torch.tasks import install_task_server
mgr = SparkCompatShuffleManager(
    TpuShuffleConf(connect_timeout_ms=5000), driverAddr=(host, port),
    executorId=f"w{{pid}}", spill_dir=spill)
install_task_server(mgr)
print("WORKER_READY", pid, flush=True)
time.sleep(600)
'''

CONF = TpuShuffleConf(connect_timeout_ms=3000, max_connection_attempts=2,
                      task_timeout_ms=120_000)

P, MAPS, ROWS = 8, 4, 400


def _make_fns():
    """Task closures (NOT module-level: cloudpickle would ship them by
    reference to this test module, which worker processes can't import)."""
    rows = ROWS

    def map_fn(ctx, writer, task_id, _rows=rows):
        import numpy as np
        rng = np.random.default_rng(40 + task_id)
        keys = rng.integers(0, 10_000, _rows).astype(np.uint64)
        vals = rng.integers(0, 1000, _rows).astype("<u4")
        writer.write((keys, vals.view(np.uint8).reshape(_rows, 4)))

    def reduce_fn(ctx, task_id):
        import numpy as np
        from sparkrdma_tpu_torch.shuffle import dist_cache

        handle = ctx._parents[0]
        from_collective = dist_cache.get(handle.shuffle_id,
                                         task_id) is not None
        total = 0
        for keys, payload in ctx.read(0).readBatches():
            vals = np.ascontiguousarray(payload).view("<u4")
            total += int(vals.astype(np.int64).sum())
        return total, from_collective, handle.shuffle_id

    return map_fn, reduce_fn


def _expected_partition_sums():
    sums = np.zeros(P, dtype=np.int64)
    for m in range(MAPS):
        rng = np.random.default_rng(40 + m)
        keys = rng.integers(0, 10_000, ROWS).astype(np.uint64)
        vals = rng.integers(0, 1000, ROWS).astype(np.int64)
        np.add.at(sums, (keys % P).astype(np.int64), vals)
    return sums


def test_dist_collective_retries_through_recovery(monkeypatch, tmp_path):
    """Driver-side orchestration in isolation (no process group): a
    group-wide FetchFailed on the first collective round triggers ONE
    recovery, the group re-enters, ownership lands; coverage and
    duplicate-process validation raise clearly."""
    from sparkrdma_tpu_torch.engine import DAGEngine
    from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError
    from sparkrdma_tpu_torch.shuffle.manager import ShuffleHandle

    class StubRemote:
        alive = True

        def __init__(self, pidx, nproc, parts, fail_rounds=0):
            self.pidx, self.nproc, self.parts = pidx, nproc, parts
            self.fail_rounds = fail_rounds
            self.calls = 0

        def run_result_task(self, fn, parents, task_id):
            self.calls += 1
            if self.calls <= self.fail_rounds:
                raise FetchFailedError(7, 1, 0, "spill disposed")
            return (self.pidx, self.nproc, self.parts), {}

    driver = SparkCompatShuffleManager(CONF, isDriver=True)
    try:
        a = StubRemote(0, 2, [0, 2, 4, 6], fail_rounds=1)
        b = StubRemote(1, 2, [1, 3, 5, 7], fail_rounds=1)
        engine = DAGEngine.__new__(DAGEngine)  # orchestration state only
        engine.executors = [a, b]
        engine.dist_mesh_axis = "shuffle"
        engine.dist_rows_per_round = 0
        engine.mesh_impl = "auto"
        engine.max_stage_retries = 2
        engine.tracer = driver.native.tracer
        import threading
        engine._dist_lock = threading.RLock()
        engine._dist_owner = {}
        recoveries = []
        engine._recover_shuffle = lambda e: recoveries.append(e.shuffle_id)
        handle = ShuffleHandle(7, 4, 8, 4, PartitionerSpec("modulo"))
        engine._dist_mesh_reduce(handle)
        assert recoveries == [7]
        owner = engine._dist_owner[7]
        assert {p for p, ex in owner.items() if ex is a} == {0, 2, 4, 6}
        assert {p for p, ex in owner.items() if ex is b} == {1, 3, 5, 7}
        # duplicate process index -> loud config error
        engine._dist_owner.clear()
        engine.executors = [StubRemote(0, 2, [0]), StubRemote(0, 2, [1])]
        with pytest.raises(RuntimeError, match="two engine executors"):
            engine._dist_mesh_reduce(handle)
        # missing process -> loud coverage error
        engine._dist_owner.clear()
        engine.executors = [StubRemote(0, 2, [0])]
        with pytest.raises(RuntimeError, match="covered 1/2"):
            engine._dist_mesh_reduce(handle)
    finally:
        driver.stop()


def test_rdd_over_distributed_mesh(tmp_path):
    """The RDD layer's pickled-blob shuffles ride the cross-process
    collective unchanged — including BOUNDED ROUNDS that split a map's
    multi-row blobs across collectives and interleave sources: the
    per-row (map, seq) tags make decoding order-independent."""
    from sparkrdma_tpu_torch.rdd import EngineContext

    driver = SparkCompatShuffleManager(CONF, isDriver=True)
    host, port = driver.driverAddr
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = "127.0.0.1:%d" % s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), coord, host, str(port),
         str(tmp_path / f"w{i}")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    remotes = []
    try:
        remotes = remote_executors(driver, CONF, expect=2, timeout=60)
        # dist_rows_per_round forces multiple bounded collective rounds;
        # blob framing must survive the round slicing (a boundary splits
        # exactly one map, head/tail stay adjacent per destination)
        ctx = EngineContext(DAGEngine(driver, remotes,
                                      dist_mesh_axis="shuffle",
                                      dist_rows_per_round=2))
        # 3 KB values -> multi-row blobs; rows_per_round=2 forces many
        # rounds, so blobs genuinely split and interleave in transit
        pairs = [(i % 7, "v%d" % i + "x" * 3000) for i in range(42)]
        got = (ctx.parallelize(pairs, 4)
               .group_by_key(8)
               .map_values(len)
               .collect())
        assert dict(got) == {k: 6 for k in range(7)}
    finally:
        for p in procs:
            p.kill()
        for r in remotes:
            r.stop()
        driver.stop()


def test_kill_executor_mid_collective_fails_fast(tmp_path):
    """SIGKILL one executor process while ``run_multihost_mesh_reduce``
    is in flight (SURVEY §7 hard part 4: a failed participant stalls the
    whole mesh). The driver must surface a group-wide failure within the
    short fail grace — NOT block the full task budget on the wedged
    survivor — and must name the lost process, not the survivor
    (RdmaShuffleFetcherIterator.scala:376-381 is the reference's
    stage-retry precedent; a torch.distributed group can't re-form around
    a dead process, so the contract here is bounded-time fail-fast)."""
    import threading

    driver = SparkCompatShuffleManager(CONF, isDriver=True)
    host, port = driver.driverAddr
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = "127.0.0.1:%d" % s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), coord, host, str(port),
         str(tmp_path / f"w{i}"), "0.2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    remotes = []
    try:
        remotes = remote_executors(driver, CONF, expect=2, timeout=60)
        # many bounded rounds, each slowed by the workers, stretch the
        # collective so the kill lands genuinely in flight (25 rounds of
        # 0.2 s >> the 1s kill delay)
        engine = DAGEngine(driver, remotes, dist_mesh_axis="shuffle",
                           dist_rows_per_round=8, dist_fail_grace_s=3.0)
        map_fn, reduce_fn = _make_fns()
        stage = MapStage(MAPS, ShuffleDependency(
            P, PartitionerSpec("modulo"), row_payload_bytes=4), map_fn)

        # instrument the victim's proxy so the kill fires only once the
        # collective dispatch is actually in flight on the workers.
        # remote_executors returns proxies in driver-REGISTRATION order —
        # a startup race — so map proxy->process by executor id ("w{i}"
        # is process i by construction in _WORKER)
        by_id = {r.manager_id.executor_id.executor: r for r in remotes}
        victim, survivor = by_id["w1"], by_id["w0"]
        dispatched = threading.Event()
        orig = victim.run_result_task

        def tapped(fn, parents, task_id):
            dispatched.set()
            return orig(fn, parents, task_id)

        victim.run_result_task = tapped

        outcome = {}

        def run_job():
            try:
                outcome["got"] = engine.run(
                    ResultStage(P, reduce_fn, parents=[stage]))
            except BaseException as e:
                outcome["err"] = e

        t = threading.Thread(target=run_job)
        t.start()
        assert dispatched.wait(90), "collective was never dispatched"
        time.sleep(1.0)  # let both processes enter the collective
        procs[1].kill()
        t_kill = time.monotonic()
        t.join(timeout=60)
        elapsed = time.monotonic() - t_kill
        assert not t.is_alive(), \
            "driver still blocked >60s after executor death"
        err = outcome.get("err")
        assert err is not None, f"job succeeded?! {outcome.get('got')}"
        assert "restart the process group" in str(err) or \
            "mid-collective" in str(err), f"unexpected failure: {err!r}"
        # bounded: grace (3s) + transport detection, nowhere near the
        # 120s task budget the survivor's RPC would otherwise hold
        assert elapsed < 45, f"fail-fast took {elapsed:.0f}s"
        # the SURVIVOR must not be blamed or written off as dead
        assert getattr(survivor, "alive", True), \
            "healthy survivor was marked dead"
    finally:
        for p in procs:
            p.kill()
        for r in remotes:
            r.stop()
        driver.stop()


def test_engine_distributed_mesh_reduce(tmp_path):
    driver = SparkCompatShuffleManager(CONF, isDriver=True)
    host, port = driver.driverAddr
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = "127.0.0.1:%d" % s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers pin their own 4-device split
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), coord, host, str(port),
         str(tmp_path / f"w{i}")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    remotes = []
    try:
        remotes = remote_executors(driver, CONF, expect=2, timeout=60)
        engine = DAGEngine(driver, remotes, dist_mesh_axis="shuffle")
        map_fn, reduce_fn = _make_fns()
        stage = MapStage(MAPS, ShuffleDependency(
            P, PartitionerSpec("modulo"), row_payload_bytes=4), map_fn)
        got = engine.run(ResultStage(P, reduce_fn, parents=[stage]))
        sums = np.array([t for t, _, _ in got], dtype=np.int64)
        np.testing.assert_array_equal(sums, _expected_partition_sums())
        # owner-placement must have made every reduce read a local
        # collective-cache hit — rows moved over the mesh, not TCP
        assert all(flag for _, flag, _ in got), \
            f"reads fell back to TCP: {[f for _, f, _ in got]}"
        # job teardown drops the worker-side collective caches (the
        # unregister ship): stale rows must not survive the job
        sid = got[0][2]

        def probe(ctx, task_id, _sid=sid):
            from sparkrdma_tpu_torch.shuffle import dist_cache
            return dist_cache.has_shuffle(_sid)

        for r in remotes:
            held, _ = r.run_result_task(probe, [], 0)
            assert held is False, "worker kept a torn-down shuffle's cache"
    finally:
        for p in procs:
            p.kill()
        for r in remotes:
            r.stop()
        driver.stop()
        for p in procs:
            try:
                out = p.stdout.read().decode(errors="replace")
                if out and "WORKER_READY" not in out:
                    print("worker output:", out[-2000:])
            except Exception:
                pass
