"""The port's multi-process path (``sparkrdma_tpu_torch.parallel.multihost``)
against the JAX package's, on the CPU: two port processes of 4 shards each
form a global mesh of 8 over a gloo group.

One pair of port processes and one pair of JAX processes run every check
once per module (``reports``): the global-mesh exchange for each transport
(``ring`` is the plain cross-process move, an ``all_to_all_single``), the
multi-process TeraSort, the mesh reduce of committed spills one shot and in
rounds, an unstaged map, and the topology. The tests hold their results
byte for byte against the JAX package on the conftest's 8-device CPU mesh
(exchange, TeraSort), against a numpy oracle and against the JAX
``run_multihost_mesh_reduce`` in two JAX processes (mesh reduce)."""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.models.terasort import TeraSortConfig as JaxTeraSortConfig
from sparkrdma_tpu.models.terasort import make_terasort_step as jax_terasort
from sparkrdma_tpu.parallel.exchange import make_shuffle_exchange
from sparkrdma_tpu_torch.parallel import exchange as tx
from sparkrdma_tpu_torch.parallel import multihost
from sparkrdma_tpu_torch.parallel.mesh import GlobalMesh, VirtualMesh

from multihost_inputs import (
    CAP, DL, G, MAPS, OUT_FACTOR, PARTS, ROWS, TS_ROWS, TS_SEED, TS_WORDS,
    W, exchange_inputs, table)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
IMPLS = ("gather", "dense", "ring", "native")
# the JAX transport each port transport is held to: XLA:CPU has no
# ragged all-to-all, so native is held to gather
JAX_IMPL = {"gather": "gather", "dense": "dense", "ring": "ring_interpret",
            "native": "gather"}
REDUCES = ("one_shot", "rounds", "one_shot_ring", "rounds_ring")


_SHUFFLE_SETUP = '''
import pathlib, tempfile, time
conf = TpuShuffleConf(connect_timeout_ms=5000)
addr_file = pathlib.Path(out_dir) / "{name}_driver.txt"
driver = None
if pid == 0:
    driver = TpuShuffleManager(conf, is_driver=True)
    handle = driver.register_shuffle(7, MAPS, PARTS, PartitionerSpec("modulo"),
                                     row_payload_bytes=PAYLOAD)
    tmp = addr_file.with_suffix(".tmp")
    tmp.write_text("%s:%d" % driver.driver_addr)
    tmp.replace(addr_file)
    driver_addr = driver.driver_addr
else:
    handle = ShuffleHandle(7, MAPS, PARTS, PAYLOAD, PartitionerSpec("modulo"))
    deadline = time.monotonic() + 60
    while not addr_file.exists():
        assert time.monotonic() < deadline, "driver address never appeared"
        time.sleep(0.05)
    h, p = addr_file.read_text().split(":")
    driver_addr = (h, int(p))
mgr = TpuShuffleManager(conf, driver_addr=driver_addr, executor_id=f"h{{pid}}",
                        spill_dir=tempfile.mkdtemp(dir=out_dir))
mgr.executor.wait_for_members(2)
for m in ((0, 1) if pid == 0 else (2, 3)):
    w = mgr.get_writer(handle, m)
    w.write_batch(*table(m))
    w.close()
'''

_PORT_WORKER = f'''
import sys
import numpy as np
import torch
pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path[:0] = [{ROOT!r}, {TESTS!r}]
from multihost_inputs import (
    CAP, DL, G, MAPS, OUT_FACTOR, PARTS, PAYLOAD, ROUND_ROWS,
    TS_ROWS, TS_SEED, TS_WORDS, exchange_inputs, table)
from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel import exchange, multihost, topology
from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError
from sparkrdma_tpu_torch.shuffle.manager import (
    PartitionerSpec, ShuffleHandle, TpuShuffleManager)
multihost.init_multihost(f"127.0.0.1:{{port}}", num_processes=2,
                         process_id=pid, local_device_count=DL,
                         platform="cpu")
mesh = multihost.global_mesh("shuffle")
out = {{}}
lo = pid * DL

# 1. the exchange, every transport
data, dest = exchange_inputs()
for impl in {IMPLS!r}:
    ex = exchange.make_shuffle_exchange(mesh, impl, OUT_FACTOR)
    got = ex(torch.from_numpy(data[lo:lo + DL].view(np.int32)),
             torch.from_numpy(dest[lo:lo + DL]))
    for name, t in zip(("received", "counts", "offsets", "overflowed"), got):
        out[f"x_{{impl}}_{{name}}"] = t.numpy()

# 2. TeraSort
ts_out, ts_counts = multihost.run_multihost_terasort(
    mesh, "shuffle", TS_ROWS, payload_words=TS_WORDS, seed=TS_SEED)
out["ts_out"], out["ts_counts"] = ts_out, ts_counts

# 3. the mesh reduce of committed spills, one shot and in rounds
{_SHUFFLE_SETUP.format(name="port")}
moves = {{"n": 0}}
plain = exchange.ring_all_to_all_peers
def counted(blocks, m):
    moves["n"] += 1
    return plain(blocks, m)
exchange.ring_all_to_all_peers = counted
before = topology.cross_slice_snapshot()
for name, kw in (("one_shot", {{}}), ("rounds", {{"rows_per_round": ROUND_ROWS}}),
                 ("one_shot_ring", {{"impl": "ring"}}),
                 ("rounds_ring", {{"impl": "ring", "rows_per_round": ROUND_ROWS}})):
    moves["n"] = 0
    res = multihost.run_multihost_mesh_reduce([mgr], handle, mesh, **kw)
    out[f"moves_{{name}}"] = np.array(moves["n"])
    for d, (k, p, parts) in enumerate(res):
        out[f"r_{{name}}_{{d}}_k"], out[f"r_{{name}}_{{d}}_p"] = k, p
        out[f"r_{{name}}_{{d}}_parts"] = parts
after = topology.cross_slice_snapshot()
out["cross_slice_bytes"] = np.array(after["bytes"] - before["bytes"])
out["slice_sizes"] = np.array(topology.detect_topology(mesh).slice_sizes)

# 4. an unstaged map: process 1 loses map 2 mid-staging
class Losing:
    def __init__(self, inner):
        self.inner = inner
    def local_blocks(self, sid, m, lo, hi):
        return None if m == 2 else self.inner.local_blocks(sid, m, lo, hi)
class Mgr:
    executor = mgr.executor
    resolver = Losing(mgr.resolver) if pid == 1 else mgr.resolver
try:
    multihost.run_multihost_mesh_reduce([Mgr()], handle, mesh)
    out["fetch_failed_map"] = np.array(-1)
except FetchFailedError as e:
    out["fetch_failed_map"] = np.array(e.map_id)
# the group still works after the group-wide failure
res = multihost.run_multihost_mesh_reduce([mgr], handle, mesh)
out["after_failure_rows"] = np.array(sum(len(k) for k, _, _ in res))

np.savez(f"{{out_dir}}/port_{{pid}}.npz", **out)
multihost.shutdown_multihost()
mgr.stop()
if driver is not None:
    driver.stop()
print("PORT_OK", pid, flush=True)
'''

_JAX_WORKER = f'''
import sys
import numpy as np
pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path[:0] = [{ROOT!r}, {TESTS!r}]
from sparkrdma_tpu.parallel.multihost import (
    global_mesh, init_multihost, run_multihost_mesh_reduce)
init_multihost(f"127.0.0.1:{{port}}", num_processes=2, process_id=pid,
               local_device_count=4, platform="cpu")
from multihost_inputs import (
    MAPS, PARTS, PAYLOAD, ROUND_ROWS, table)
from sparkrdma_tpu.config import TpuShuffleConf
from sparkrdma_tpu.shuffle.manager import (
    PartitionerSpec, ShuffleHandle, TpuShuffleManager)
{_SHUFFLE_SETUP.format(name="jax")}
mesh = global_mesh("shuffle")
out = {{}}
for name, kw in (("one_shot", {{}}), ("rounds", {{"rows_per_round": ROUND_ROWS}})):
    res = run_multihost_mesh_reduce([mgr], handle, mesh, **kw)
    for d, (k, p, parts) in enumerate(res):
        out[f"r_{{name}}_{{d}}_k"], out[f"r_{{name}}_{{d}}_p"] = k, p
        out[f"r_{{name}}_{{d}}_parts"] = parts
np.savez(f"{{out_dir}}/jax_{{pid}}.npz", **out)
from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("done")
mgr.stop()
if driver is not None:
    driver.stop()
print("JAX_OK", pid, flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Run the port pair and the JAX pair at once; returns
    ``{"port": [npz of process 0, 1], "jax": [...]}``."""
    out_dir = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for kind, code in (("port", _PORT_WORKER), ("jax", _JAX_WORKER)):
        port = str(_free_port())
        procs += [(kind, i, subprocess.Popen(
            [sys.executable, "-c", code, str(i), port, str(out_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=str(out_dir))) for i in range(2)]
    deadline = time.monotonic() + 150
    outputs = {}
    try:
        for kind, i, proc in procs:
            out, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outputs[(kind, i)] = out.decode(errors="replace")
    finally:
        for _, _, proc in procs:
            proc.kill()
    for (kind, i), text in outputs.items():
        assert f"{kind.upper()}_OK {i}" in text, \
            f"{kind} process {i} failed:\n{text[-3000:]}"
    return {kind: [dict(np.load(out_dir / f"{kind}_{i}.npz"))
                   for i in range(2)] for kind in ("port", "jax")}


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:G]), ("shuffle",))


def _sharded(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P("shuffle")))


@pytest.mark.parametrize("impl", IMPLS)
def test_global_exchange_matches_jax(reports, jax_mesh, impl):
    data, dest = exchange_inputs()
    # the port sizes slots from the largest pair, JAX from the even share:
    # equal only while no pair exceeds the even share
    counts = np.stack([np.bincount(d[d >= 0], minlength=G) for d in dest])
    assert counts.max() <= CAP * OUT_FACTOR // G
    ex = make_shuffle_exchange(jax_mesh, "shuffle", impl=JAX_IMPL[impl],
                               out_factor=OUT_FACTOR)
    want = [np.asarray(a) for a in ex(_sharded(jax_mesh, data.reshape(
        G * CAP, W)), _sharded(jax_mesh, dest.reshape(-1)))]
    out_cap = CAP * OUT_FACTOR
    for pid, rep in enumerate(reports["port"]):
        lo = pid * DL
        got = rep[f"x_{impl}_received"].view(np.uint32)
        np.testing.assert_array_equal(
            got, want[0].reshape(G, out_cap, W)[lo:lo + DL])
        for name, w in zip(("counts", "offsets", "overflowed"), want[1:]):
            np.testing.assert_array_equal(
                rep[f"x_{impl}_{name}"],
                w.reshape(G, -1)[lo:lo + DL].reshape(
                    rep[f"x_{impl}_{name}"].shape), err_msg=name)


def test_terasort_matches_jax(reports, jax_mesh):
    cfg = JaxTeraSortConfig(rows_per_device=TS_ROWS, payload_words=TS_WORDS,
                            out_factor=2)
    from sparkrdma_tpu.models.terasort import generate_rows

    rows = np.concatenate([generate_rows(cfg, DL, seed=TS_SEED * 100_003 + p)
                           for p in range(2)])
    out, counts, overflowed = (np.asarray(a) for a in jax_terasort(
        jax_mesh, "shuffle", cfg)(_sharded(jax_mesh, rows)))
    assert not overflowed.any()
    out = out.reshape(G, -1, 1 + TS_WORDS)
    counts = counts.reshape(G, G)
    total = 0
    for pid, rep in enumerate(reports["port"]):
        lo = pid * DL
        np.testing.assert_array_equal(
            rep["ts_out"].reshape(DL, -1, 1 + TS_WORDS), out[lo:lo + DL])
        np.testing.assert_array_equal(rep["ts_counts"].reshape(DL, G),
                                      counts[lo:lo + DL])
        total += int(rep["ts_counts"].sum())
    assert total == G * TS_ROWS


def _oracle(d):
    keys = np.concatenate([table(m)[0] for m in range(MAPS)])
    payload = np.concatenate([table(m)[1] for m in range(MAPS)])
    parts = (keys % PARTS).astype(np.int64)
    mine = np.flatnonzero(parts % G == d)
    order = mine[np.argsort(keys[mine], kind="stable")]
    return keys[order], payload[order], parts[order]


def _canon(k, p):
    rows = np.concatenate([k[:, None].view(np.uint8).reshape(len(k), 8), p],
                          axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("run", REDUCES)
def test_mesh_reduce_matches_oracle(reports, run):
    rows = 0
    for pid, rep in enumerate(reports["port"]):
        for d in range(DL):
            k, p, parts = (rep[f"r_{run}_{d}_{x}"] for x in ("k", "p",
                                                              "parts"))
            wk, wp, wparts = _oracle(pid * DL + d)
            assert (np.diff(k.astype(np.int64)) >= 0).all()
            np.testing.assert_array_equal(k, wk)
            np.testing.assert_array_equal(parts, wparts)
            # ties in key keep arrival order, which the oracle does not
            # model: compare the payload as a multiset per shard
            np.testing.assert_array_equal(_canon(k, p), _canon(wk, wp))
            rows += len(k)
    assert rows == MAPS * ROWS
    if run.endswith("ring"):
        moves = reports["port"][0][f"moves_{run}"]
        assert moves >= (2 if run.startswith("rounds") else 1)


@pytest.mark.parametrize("run", ("one_shot", "rounds"))
def test_mesh_reduce_matches_two_process_jax(reports, run):
    for pid in range(2):
        port, ref = reports["port"][pid], reports["jax"][pid]
        for d in range(DL):
            for x in ("k", "p", "parts"):
                got, want = port[f"r_{run}_{d}_{x}"], ref[f"r_{run}_{d}_{x}"]
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=(pid, d, x))


def test_unstaged_map_fails_on_every_process(reports):
    """Process 1 loses map 2 while staging: the completeness check raises
    ``FetchFailedError`` for map 2 on BOTH processes, before any exchange
    could strand one, and the group runs the next reduce."""
    for rep in reports["port"]:
        assert int(rep["fetch_failed_map"]) == 2
        assert 0 < int(rep["after_failure_rows"]) < MAPS * ROWS
    assert sum(int(r["after_failure_rows"])
               for r in reports["port"]) == MAPS * ROWS


def test_topology_has_a_slice_per_process(reports):
    """Unlike the JAX package's multi-process CPU devices here, the port's
    global mesh exposes each shard's process: two slices of 4, and the
    reduce counted the bytes crossing between them."""
    for rep in reports["port"]:
        assert rep["slice_sizes"].tolist() == [DL, DL]
        assert int(rep["cross_slice_bytes"]) > 0


def _fake_mesh(device: str, data_group=None) -> GlobalMesh:
    return GlobalMesh(2, DL, 0, torch.device(device), group=None,
                      data_group=data_group)


def test_global_mesh_shards_and_hash():
    mesh = _fake_mesh("cpu")
    assert mesh.num_shards == G and mesh.first_shard == 0
    assert [d.process_index for d in mesh.devices] == [0] * DL + [1] * DL
    assert [d.device for d in mesh.devices][DL:] == [None] * DL
    assert hash(mesh) == hash(mesh) and mesh != _fake_mesh("cpu")
    assert mesh.local_view() == VirtualMesh(DL, "cpu")
    assert VirtualMesh(3, "cpu").local_shards == 3


def test_transport_refusals():
    """``native`` needs a GlobalMesh; on a card whose ranks share it the
    collective transports raise and name why, and ``auto`` is the ring."""
    with pytest.raises(NotImplementedError, match="GlobalMesh"):
        tx.resolve_impl(VirtualMesh(G, "cpu"), "native")
    card = _fake_mesh("cuda")
    for impl in ("dense", "gather", "native"):
        with pytest.raises(RuntimeError, match="CUDA IPC"):
            tx.resolve_impl(card, impl)
    assert tx.resolve_impl(card, "auto") == "ring"
    assert tx.resolve_impl(_fake_mesh("cuda", data_group=object()),
                           "native") == "native"
    assert tx.resolve_impl(_fake_mesh("cpu", data_group=object()),
                           "auto") == "gather"


def test_init_multihost_refuses_bad_platforms():
    with pytest.raises(ValueError, match="platform"):
        multihost.init_multihost("127.0.0.1:1", 1, 0, platform="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.init_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="init_multihost first"):
        multihost.global_mesh()
