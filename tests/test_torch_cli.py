"""``python -m sparkrdma_tpu_torch`` against ``python -m sparkrdma_tpu``,
each command as a real process.

The commands that need no device are held to the JAX package's output
(``config`` byte for byte, ``selftest``'s rows, ``rdd-demo``'s JSON, the
star's joined rows); the two device commands run with ``--device cpu``
and must verify; without that flag, on a host with no card, ``demo``
fails. The ``shuffle-service`` process adopts a stopped executor's spill
directory on the port's managers, as ``tests/test_rejoin.py`` runs the
JAX one. The one-shot commands start together in one module fixture,
so the file's wall time is about that of the slowest."""

import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.shuffle.manager import (
    PartitionerSpec,
    TpuShuffleManager,
)

ROOT = Path(__file__).resolve().parents[1]
CONF = TpuShuffleConf(connect_timeout_ms=1000, max_connection_attempts=2)
RUNS = {
    "config": ("sparkrdma_tpu_torch", "config"),
    "jax_config": ("sparkrdma_tpu", "config"),
    "selftest": ("sparkrdma_tpu_torch", "selftest"),
    "jax_selftest": ("sparkrdma_tpu", "selftest"),
    "unknown": ("sparkrdma_tpu_torch", "nope"),
    "demo_cpu": ("sparkrdma_tpu_torch", "demo", "--device", "cpu"),
    "demo_default": ("sparkrdma_tpu_torch", "demo"),
    "engine_mesh_cpu": ("sparkrdma_tpu_torch", "engine-mesh-demo",
                        "--device", "cpu"),
    "jax_engine": ("sparkrdma_tpu", "engine-demo"),
    "rdd": ("sparkrdma_tpu_torch", "rdd-demo"),
    "jax_rdd": ("sparkrdma_tpu", "rdd-demo"),
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def runs():
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
        for name, argv in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return out


def _ok(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, f"{name} exited {rc}:\n{stderr[-2000:]}"
    return stdout


def _json_line(runs, name) -> dict:
    lines = [ln for ln in _ok(runs, name).splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, runs[name][1]
    return json.loads(lines[0])


def test_config_is_byte_equal_to_the_reference(runs):
    got = _ok(runs, "config")
    assert got == _ok(runs, "jax_config")
    assert "shuffle_read_block_size" in got


def test_selftest(runs):
    got = _json_line(runs, "selftest")
    assert got["selftest"] == "ok"
    assert got["rows"] == _json_line(runs, "jax_selftest")["rows"] == 10000


def test_unknown_command_prints_usage(runs):
    rc, stdout, _ = runs["unknown"]
    assert rc == 2
    assert stdout.strip() == (
        "usage: python -m sparkrdma_tpu_torch {info | config | selftest | "
        "demo | engine-demo | engine-mesh-demo | rdd-demo | "
        "shuffle-service}")


def test_demo_on_the_cpu(runs):
    got = _json_line(runs, "demo_cpu")
    assert got["demo"] == "terasort" and got["verified"] is True
    assert got["rows"] == 800_000 and got["devices"] == 8


def test_demo_without_a_card_fails(runs):
    """No fallback: ``demo`` without ``--device cpu`` needs a card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: demo runs on it")
    rc, stdout, stderr = runs["demo_default"]
    assert rc != 0
    assert "no CUDA device is available" in stderr
    assert "verified" not in stdout


def test_engine_mesh_demo_on_the_cpu(runs):
    got = _json_line(runs, "engine_mesh_cpu")
    assert got["oracle_exact"] is True and got["data_plane"] == "mesh"
    assert got["collective_exchanges"] > 0
    want = _json_line(runs, "jax_engine")
    assert want["oracle_exact"] is True
    assert got["joined_rows"] == want["joined_rows"] > 0
    assert got["groups"] == want["groups"]


def test_rdd_demo_equals_the_reference(runs):
    got = _json_line(runs, "rdd")
    assert got == _json_line(runs, "jax_rdd")
    assert got["verified"] is True


def test_device_flag_is_only_a_device():
    proc = subprocess.run(
        [sys.executable, "-m", "sparkrdma_tpu_torch", "demo", "--rows", "9"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode == 2
    assert "unrecognized arguments: --rows 9" in proc.stderr


def test_standalone_shuffle_service_process(tmp_path):
    """The ``shuffle-service`` command as a real process on the port's
    managers: it adopts a stopped executor's spill directory,
    re-publishes the committed outputs, a reducer reads every partition
    exactly with no recompute, and SIGTERM ends it with exit 0."""
    driver = TpuShuffleManager(CONF, is_driver=True)
    execs = [TpuShuffleManager(CONF, driver_addr=driver.driver_addr,
                               executor_id=str(i),
                               spill_dir=str(tmp_path / f"e{i}"))
             for i in range(2)]
    for ex in execs:
        ex.executor.wait_for_members(2)
    svc = None
    try:
        handle = driver.register_shuffle(5, num_maps=4, num_partitions=4,
                                         partitioner=PartitionerSpec("modulo"))
        rng = np.random.default_rng(3)
        truth = []
        for m in range(4):
            keys = rng.integers(0, 9999, 200).astype(np.uint64)
            w = execs[m % 2].get_writer(handle, m)
            w.write_batch(keys)
            w.close()
            truth.append(keys)
        expect = np.sort(np.concatenate(truth))

        lost = execs[1].executor.manager_id
        execs[1].executor.stop()
        if execs[1].block_server is not None:
            execs[1].block_server.stop()
        driver.driver.remove_member(lost)
        time.sleep(0.3)

        host, port = driver.driver_addr
        svc = subprocess.Popen(
            [sys.executable, "-m", "sparkrdma_tpu_torch", "shuffle-service",
             f"{host}:{port}", str(tmp_path / "e1"), "svc1"],
            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        # banner read with a deadline: a wedged service must FAIL the
        # test, not hang the suite on a blocking readline
        banner: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=lambda: banner.put(svc.stdout.readline()),
                         daemon=True).start()
        line = banner.get(timeout=30)
        assert "serving 2 recovered map outputs" in line, line

        execs[0].executor.invalidate_shuffle(5)
        keys, _ = execs[0].get_reader(handle, 0, 4).read_all()
        np.testing.assert_array_equal(np.sort(keys), expect)
        svc.terminate()
        assert svc.wait(timeout=20) == 0
    finally:
        if svc is not None and svc.poll() is None:
            svc.kill()
            svc.wait(timeout=10)
        for ex in execs:
            ex.stop()
        driver.stop()
