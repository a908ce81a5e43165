"""The port's analysis suite (``sparkrdma_tpu_torch/analysis/``) over the
port's own tree.

Three groups:

1. counterparts of ``tests/test_analysis.py``'s tests on the port's
   modules: the live gate over the port's tree, the seeded-violation
   fixtures of ``tests/fixtures/analysis/`` (copied into ``tmp_path``
   with the package prefix rewritten, so the two that import ``World``
   run on the port's model checker), the pragma rules, the lock graph,
   the model checker, the resource lints, the CLI and the gated
   sanitizer harness (built through ``runtime/shim_build.py``);
2. parity with the JAX package's passes on the same inputs: the
   concurrency and resource lints over every fixture and every
   ``LOCKSTEP`` module, the message-ID doc tables, the model-check
   catalogs' schedule counts, the bad-trace fixture's violating
   schedule, and the trace registries (the port's is the reference's
   plus the seven names only the port emits);
3. the port's trace-name repair (every name emitted as a literal, the
   spans' names and nesting as before), and the lock-order shim over
   the engine's mesh mode on ``VirtualMesh(8, "cpu")`` in a process that
   installs the port's shim before it imports anything else of the port.

The port's shim is never installed in a process where the JAX package's
is: both patch ``threading.Lock``.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import sparkrdma_tpu_torch.analysis as analysis
from sparkrdma_tpu.analysis import concurrency as jconcurrency
from sparkrdma_tpu.analysis import modelcheck as jmodelcheck
from sparkrdma_tpu.analysis import resources as jresources
from sparkrdma_tpu.analysis import scheduler as jscheduler
from sparkrdma_tpu.analysis import wire as jwire
from sparkrdma_tpu.utils import trace_names as jtrace_names
from sparkrdma_tpu_torch.analysis import (concurrency, core, drift,
                                          lockgraph, modelcheck, resources,
                                          scheduler, wire)
from sparkrdma_tpu_torch.parallel import device_plane
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.runtime import shim_build
from sparkrdma_tpu_torch.shuffle import mesh_service
from sparkrdma_tpu_torch.utils import trace_names
from sparkrdma_tpu_torch.utils.trace import Tracer

ROOT = core.repo_root()
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "analysis")
PREFIX = re.compile(r"\bsparkrdma_tpu\b")
# the port's step spans (``utils/trace.span``), which the benchmark's
# readers and chip_smoke.py select on by name
STEP_SPANS = {
    "als.group", "als.solve", "chunked.land", "chunked.pack",
    "chunked.slot_fill", "chunked.transport", "exchange.arena_copy",
    "exchange.group",
    "exchange.pack", "exchange.receive_fill", "exchange.slot_fill",
    "exchange.transport", "fused.counts", "fused.local_sort",
    "fused.receive_sort", "join.exchange", "join.merge", "lookup.unique",
    "mesh.take_rows",
    "pagerank.contrib", "pagerank.exchange", "pagerank.sum", "q64.by_item",
    "q64.catalog_group", "q64.catalog_join", "q64.date_join",
    "q64.pair_lookup", "q64.store_join", "q95.addr", "q95.aggregate", "q95.aggregate.sort",
    "q95.by_order", "q95.date", "q95.site", "tpcds.aggregate",
    "tpcds.join1", "tpcds.join2"}
PORT_SPANS = {"exchange.collect", "exchange.merge", "exchange.stage",
              "mesh.decode", "mesh.pack", "mesh.partition",
              "mesh.unpack"} | STEP_SPANS

_spec = importlib.util.spec_from_file_location(
    "port_host_plane", os.path.join(ROOT, "scripts", "port_host_plane.py"))
port_host_plane = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(port_host_plane)


def _port_fixture_path(tmp_path, fname):
    """``tests/fixtures/analysis/<fname>`` with the package prefix
    rewritten, written into ``tmp_path``; line numbers are unchanged."""
    with open(os.path.join(FIXTURES, fname)) as f:
        text = PREFIX.sub("sparkrdma_tpu_torch", f.read())
    path = tmp_path / fname
    path.write_text(text)
    return str(path)


def _load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # inspect needs it to resolve source files
    spec.loader.exec_module(mod)
    return mod


def _load_fixture(tmp_path, name):
    """The rewritten fixture ``name``, imported under a name of its own
    (``port_<name>``) so the JAX tests' module of the same fixture stays
    as it is."""
    return _load_module(f"port_{name}",
                        _port_fixture_path(tmp_path, name + ".py"))


def _load_jax_fixture(name):
    return _load_module(f"jax_{name}", os.path.join(FIXTURES, name + ".py"))


def _marker_line(path, marker="seeded-violation"):
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            if marker in line:
                return i
    raise AssertionError(f"no '{marker}' marker in {path}")


@pytest.fixture(scope="module")
def catalogs():
    """Each package's model-check catalog at the default budgets, run
    once for the module."""
    return {"port": modelcheck.run_catalog(),
            "jax": jmodelcheck.run_catalog()}


# ---------------------------------------------------------- the live gate

def test_live_tree_zero_findings():
    """The gate over the port's tree: wire, concurrency, drift and the
    resource lints."""
    findings = analysis.run_all()
    assert not findings, "\n" + core.format_report(findings)


def test_wire_registry_is_dense_and_unique():
    findings = wire.check_registry(wire.live_pairs())
    assert not findings, "\n" + core.format_report(findings)
    ids = [t for t, _ in wire.live_pairs()]
    assert len(ids) == len(set(ids))
    assert set(ids) | set(wire.rpc_msg.RESERVED_WIRE_IDS) == set(
        range(1, max(ids) + 1))


def test_wire_density_over_full_membership_range():
    ids = [t for t, _ in wire.live_pairs()]
    assert max(ids) == 53
    assert set(ids) | set(wire.rpc_msg.RESERVED_WIRE_IDS) == set(
        range(1, 54))
    for name in ("JoinMsg", "MembershipBumpMsg", "DrainReq", "DrainResp"):
        assert name in wire._EXTRA_CASES, name
    corners = [c() for c in wire._EXTRA_CASES["MembershipBumpMsg"]]
    assert any(m.epoch == 0 for m in corners)
    assert any(m.epoch == (1 << 63) - 1 for m in corners)
    assert any(m.slot_states and all(s == 1 for s in m.slot_states)
               for m in corners)
    for name in ("TieredPublishMsg", "FetchTieredResp"):
        assert name in wire._EXTRA_CASES, name
    tiered = [c() for c in wire._EXTRA_CASES["TieredPublishMsg"]]
    assert any(m.covered == b"" for m in tiered)
    assert any(m.nbytes == (1 << 64) - 1 for m in tiered)
    dirs = [c() for c in wire._EXTRA_CASES["FetchTieredResp"]]
    assert any(m.epoch == wire.M.EPOCH_DEAD and m.data == b""
               for m in dirs)


def test_wire_doc_table_matches_registry():
    """The port's generated table is the committed one in
    docs/CONFIG.md, so ``--write-docs`` would write nothing new."""
    assert not wire.check_doc_table()


def test_legacy_truncation_matrix():
    assert not wire.check_truncation()


def test_native_constant_lockstep():
    assert not wire.check_native_constants()


# ------------------------------------------------------- fixture detection

def test_fixture_duplicate_msg_id(tmp_path):
    mod = _load_fixture(tmp_path, "fixture_dup_msg_id")
    findings = wire.check_registry(mod.FIXTURE_PAIRS,
                                   wire_ids=mod.FIXTURE_WIRE_IDS,
                                   reserved={})
    dups = [f for f in findings if "duplicate wire id 1" in f.message]
    assert dups, core.format_report(findings)
    assert dups[0].path.endswith("fixture_dup_msg_id.py")
    assert dups[0].line == _marker_line(mod.__file__)


def test_fixture_asymmetric_roundtrip(tmp_path):
    mod = _load_fixture(tmp_path, "fixture_asymmetric")
    findings = wire.fuzz_roundtrip(mod.FIXTURE_PAIRS)
    asym = [f for f in findings if "asymmetry" in f.message]
    assert asym, core.format_report(findings)
    assert asym[0].path.endswith("fixture_asymmetric.py")
    assert asym[0].line == _marker_line(mod.__file__)


def test_fixture_unguarded_write(tmp_path):
    path = _port_fixture_path(tmp_path, "fixture_unguarded_write.py")
    with open(path) as f:
        findings = concurrency.scan_source(f.read(), path)
    hits = [f for f in findings if "_count" in f.message
            and "outside any 'with <lock>'" in f.message]
    assert hits, core.format_report(findings)
    assert hits[0].line == _marker_line(path)


def test_fixture_wait_without_loop_and_deadline(tmp_path):
    path = _port_fixture_path(tmp_path, "fixture_wait_no_loop.py")
    with open(path) as f:
        findings = concurrency.scan_source(f.read(), path)
    no_loop = [f for f in findings if "outside a 'while'" in f.message]
    no_deadline = [f for f in findings if "without a deadline" in f.message]
    assert no_loop and no_loop[0].line == _marker_line(path)
    assert no_deadline and no_deadline[0].line == _marker_line(
        path, "seeded-deadline")


def test_fixture_undocumented_and_ghost_key(tmp_path):
    py = _port_fixture_path(tmp_path, "fixture_undocumented_key.py")
    md = _port_fixture_path(tmp_path, "fixture_undocumented_key.md")
    with open(md) as f:
        doc_text = f.read()
    findings = drift.check_config_docs(
        drift._config_key_lines(py), py, doc_text, md)
    missing = [f for f in findings if "mystery_key" in f.message]
    stale = [f for f in findings if "ghost_key" in f.message]
    assert missing and missing[0].path == py
    assert missing[0].line == _marker_line(py)
    assert stale and stale[0].path == md
    assert stale[0].line == _marker_line(md)
    assert len(findings) == 2


# ----------------------------------------------------------- pragma rules

_GUARDED = ("import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._x = 0\n"
            "    def a(self):\n"
            "        with self._lock:\n"
            "            self._x = 1\n")


def test_bare_pragma_is_a_finding():
    src = _GUARDED + ("    def b(self):\n"
                      "        self._x = 2  # analysis: unguarded-ok\n")
    findings = concurrency.scan_source(src, "<mem>")
    assert any(f.pass_name == "pragma" for f in findings)


def test_reasoned_pragma_suppresses():
    src = _GUARDED + ("    def b(self):\n"
                      "        self._x = 2  # analysis: "
                      "unguarded-ok(single-owner)\n")
    assert not concurrency.scan_source(src, "<mem>")


def test_locked_suffix_convention():
    src = _GUARDED + ("    def bump_locked(self):\n"
                      "        self._x += 1\n")
    assert not concurrency.scan_source(src, "<mem>")


# -------------------------------------------------------------- lockgraph

def test_lockgraph_unit_cycle_detection():
    g = lockgraph.LockGraph()
    g._push("A", 1)
    g._note_acquire("B", 2)
    g._push("B", 2)
    g._pop("B", 2)
    g._pop("A", 1)
    g._push("B", 2)
    g._note_acquire("A", 1)  # inversion
    g._push("A", 1)
    cycles = g.cycles()
    assert len(cycles) == 1 and set(cycles[0]) == {"A", "B"}
    assert "A -> B" in g.format_cycles()


def test_lockgraph_same_site_pairs_excluded():
    g = lockgraph.LockGraph()
    g._push("A", 1)
    g._note_acquire("A", 2)
    g._push("A", 2)
    assert not g.cycles() and not g.edges()


def test_lockgraph_reentrant_rlock_no_edge():
    g = lockgraph.LockGraph()
    g._push("A", 1)
    g._note_acquire("A", 1)
    assert not g.edges()


def test_lockgraph_tracks_the_ports_own_package():
    """The copy finds its package from its own path: locks created in
    ``sparkrdma_tpu_torch/`` are tracked, the JAX package's are not."""
    assert lockgraph._PKG_DIR == os.path.join(ROOT, "sparkrdma_tpu_torch")


# The shim's two workloads. Each runs in a process of its own that
# installs the port's shim before it imports anything else of the port
# (``ops/_build.py`` and ``parallel/topology.py`` create their locks at
# import), and prints the graph's verdict as its last line.
_SHIM_PROLOGUE = r"""
import gc, json, tempfile
from sparkrdma_tpu_torch.analysis import lockgraph
graph = lockgraph.install()
import numpy as np
from sparkrdma_tpu_torch.config import TpuShuffleConf
"""

_SHIM_EPILOGUE = r"""
sites = sorted({o._site for o in gc.get_objects()
                if isinstance(o, lockgraph._TrackedLock)})
lockgraph.uninstall()
print(json.dumps({"cycles": graph.cycles(),
                  "report": graph.format_cycles(),
                  "orderings": sorted(f"{a} -> {b}"
                                      for a, b in graph.edges()),
                  "sites": sites}))
"""

_SHUFFLE_UNDER_SHIM = _SHIM_PROLOGUE + r"""
from sparkrdma_tpu_torch.shuffle.manager import (PartitionerSpec,
                                                 TpuShuffleManager)
tmp = tempfile.mkdtemp()
conf = TpuShuffleConf(connect_timeout_ms=5000, shuffle_read_block_size="4k",
                      spill_threshold_bytes=4096)
driver = TpuShuffleManager(conf, is_driver=True)
execs = [TpuShuffleManager(conf, driver_addr=driver.driver_addr,
                           executor_id=str(i), spill_dir=f"{tmp}/e{i}")
         for i in range(2)]
try:
    for ex in execs:
        ex.executor.wait_for_members(2)
    handle = driver.register_shuffle(91, 4, 6, PartitionerSpec("modulo"),
                                     row_payload_bytes=8)
    rng = np.random.default_rng(3)
    for m in range(4):
        keys = rng.integers(0, 5000, size=800).astype(np.uint64)
        payload = rng.integers(0, 255, size=(800, 8)).astype(np.uint8)
        w = execs[m % 2].get_writer(handle, m)
        w.write_batch(keys, payload)
        w.close()
    got = sum(len(ex.get_reader(handle, i * 3, (i + 1) * 3).read_all()[0])
              for i, ex in enumerate(execs))
    assert got == 4 * 800, got
finally:
    for ex in execs:
        ex.stop()
    driver.stop()
""" + _SHIM_EPILOGUE

# the chip_smoke ``analysis`` phase's engine stage at a CPU size: 100-byte
# Sort Benchmark records, 8 maps, 200 hash partitions, 4 executors, the
# card's ring transport (its plain version here), each partition held
# byte-equal to a numpy oracle
_ENGINE_UNDER_SHIM = _SHIM_PROLOGUE + r"""
from sparkrdma_tpu_torch.engine import DAGEngine, MapStage, ResultStage
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec
from sparkrdma_tpu_torch.shuffle.spark_compat import (
    ShuffleDependency, SparkCompatShuffleManager)
from sparkrdma_tpu_torch.utils.trace import Tracer

MAPS, PARTS, ROWS, PAYLOAD, EXECS = 8, 200, 1500, 92, 4
rng = np.random.default_rng(0)
keys = rng.integers(0, 2**64, MAPS * ROWS, dtype=np.uint64)
payload = np.frombuffer(rng.bytes(MAPS * ROWS * PAYLOAD),
                        np.uint8).reshape(-1, PAYLOAD)


def map_fn(ctx, writer, task_id):
    rows = slice(task_id * ROWS, (task_id + 1) * ROWS)
    writer.write((keys[rows], payload[rows]))


def reduce_fn(ctx, task_id):
    got = list(ctx.read(0).readBatches())
    if not got:
        return np.zeros(0, np.uint64), np.zeros((0, PAYLOAD), np.uint8)
    return (np.concatenate([k for k, _ in got]),
            np.concatenate([p for _, p in got]))


tmp = tempfile.mkdtemp()
conf = TpuShuffleConf(connect_timeout_ms=5000)
driver = SparkCompatShuffleManager(conf, isDriver=True)
execs = [SparkCompatShuffleManager(conf, driverAddr=driver.driverAddr,
                                   executorId=str(i),
                                   spill_dir=f"{tmp}/e{i}")
         for i in range(EXECS)]
try:
    for ex in execs:
        ex.native.executor.wait_for_members(EXECS)
    engine = DAGEngine(driver, execs, mesh=VirtualMesh(8, "cpu"),
                       mesh_impl="ring")
    engine.tracer = Tracer()
    stage = MapStage(MAPS, ShuffleDependency(
        PARTS, PartitionerSpec("hash"), row_payload_bytes=PAYLOAD), map_fn)
    out = engine.run(ResultStage(PARTS, reduce_fn, parents=[stage]))
finally:
    for ex in execs:
        ex.stop()
    driver.stop()
planes = [e["args"]["plane"] for e in engine.tracer.events("exchange.select")]
assert planes == ["device"], planes
assert not engine.tracer.events("exchange.degrade")
parts = PartitionerSpec("hash").build(PARTS)(keys)
for p, (k, v) in enumerate(out):
    mine = np.flatnonzero(parts == p)
    order = mine[np.argsort(keys[mine], kind="stable")]
    assert np.array_equal(k, keys[order]), p
    assert np.array_equal(v, payload[order]), p
""" + _SHIM_EPILOGUE


def _run_under_shim(script):
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_shuffle_e2e_under_lockgraph_is_acyclic():
    """A real 2-executor shuffle (streaming writers with background spill,
    socket fetch, driver publishes) under the port's shim: the graph
    records orderings and has no cycle, and the shuffle's bytes check
    out with the patched locks."""
    verdict = _run_under_shim(_SHUFFLE_UNDER_SHIM)
    assert verdict["orderings"], "shim recorded nothing"
    assert not verdict["cycles"], verdict["report"]
    assert all(s.startswith("sparkrdma_tpu_torch/")
               for s in verdict["sites"])


def test_engine_mesh_mode_under_lockgraph_is_acyclic():
    """The engine's mesh mode on ``VirtualMesh(8, "cpu")`` with the ring
    transport under the port's shim, installed before the port's import:
    the module-level lock of ``parallel/topology.py`` is tracked, every
    partition equals the oracle, and the graph has no cycle."""
    verdict = _run_under_shim(_ENGINE_UNDER_SHIM)
    assert verdict["orderings"], "shim recorded nothing"
    assert not verdict["cycles"], verdict["report"]
    assert any(s.startswith("sparkrdma_tpu_torch/parallel/topology.py:")
               for s in verdict["sites"]), verdict["sites"]
    assert any(s.startswith("sparkrdma_tpu_torch/engine.py:")
               for s in verdict["sites"]), verdict["sites"]


# ------------------------------------------------- model checker (pass 5)

def test_modelcheck_catalog_clean_and_enumerates_500(catalogs):
    findings, stats = catalogs["port"]
    assert not findings, "\n" + core.format_report(findings)
    total = sum(s.dfs_schedules for s in stats)
    assert total >= 500, f"only {total} schedules enumerated: {stats}"
    assert {s.name for s in stats} >= {
        "pub_tomb_bump", "fence_loser", "finalize_vs_push",
        "drain_vs_kill", "ttl_vs_late_fetch",
        "driver_failover_mid_publish", "split_brain_two_leases",
        "zombie_primary_publish", "failover_vs_ttl_sweep",
        "handoff_vs_publish", "handoff_vs_driver_failover"}


def test_modelcheck_driver_death_scenarios_enumerate_500():
    driver_death = {"driver_failover_mid_publish",
                    "split_brain_two_leases", "zombie_primary_publish",
                    "failover_vs_ttl_sweep"}
    total = 0
    for scn in modelcheck.catalog():
        if scn.name not in driver_death:
            continue
        runs, st = modelcheck.run_scenario(scn)
        bad = [r for r in runs if r.violation]
        assert not bad, (f"{scn.name}: {bad[0].violation}; "
                         f"schedule: {' -> '.join(bad[0].trace)}")
        total += st.dfs_schedules
    assert total >= 500, f"only {total} driver-death schedules"


def test_scheduler_fifo_channels_and_por():
    order = []

    def build_fifo(sched):
        sched.post("a1", lambda s: order.append("a1"), chan="a")
        sched.post("a2", lambda s: order.append("a2"), chan="a")
        sched.post("b1", lambda s: order.append("b1"), chan="b")
        return None

    runs = scheduler.explore_dfs(build_fifo, lambda st, sc: None)
    assert len(runs) == 3
    for run in runs:
        assert run.trace.index("a1") < run.trace.index("a2")

    def build_commute(sched):
        sched.post("x", lambda s: None, touches={"x"})
        sched.post("y", lambda s: None, touches={"y"})
        return None

    assert len(scheduler.explore_dfs(build_commute,
                                     lambda st, sc: None)) == 1

    def build_conflict(sched):
        sched.post("x", lambda s: None, touches={"shared"})
        sched.post("y", lambda s: None, touches={"shared"})
        return None

    assert len(scheduler.explore_dfs(build_conflict,
                                     lambda st, sc: None)) == 2


def test_fixture_ledger_double_release(tmp_path):
    mod = _load_fixture(tmp_path, "fixture_ledger_double_release")
    assert mod.World is modelcheck.World  # the port's own World
    runs = scheduler.explore_dfs(mod.build, modelcheck.check_invariants)
    bad = [r for r in runs if r.violation is not None]
    assert bad and "ledger-conserve" in bad[0].violation
    apath, aline = modelcheck._anchor_of(bad[0], mod.build)
    assert apath == mod.__file__
    assert aline == _marker_line(mod.__file__)


def test_fixture_bad_trace_caught_and_replays_byte_identically(tmp_path):
    mod = _load_fixture(tmp_path, "fixture_bad_trace")
    assert mod.World is modelcheck.World
    runs = scheduler.explore_dfs(mod.build, modelcheck.check_invariants)
    bad = [r for r in runs if r.violation is not None]
    assert bad and "epoch-monotone" in bad[0].violation
    apath, aline = modelcheck._anchor_of(bad[0], mod.build)
    assert apath == mod.__file__
    assert aline == _marker_line(mod.__file__)
    replayed = scheduler.replay(mod.build, modelcheck.check_invariants,
                                bad[0].trace)
    assert replayed.trace == bad[0].trace
    assert replayed.violation == bad[0].violation


def test_modelcheck_trace_artifact_roundtrip(tmp_path, monkeypatch):
    mod = _load_fixture(tmp_path, "fixture_bad_trace")
    scn = modelcheck.Scenario("fixture_bad_trace", mod.build)
    monkeypatch.setattr(modelcheck, "_CATALOG",
                        modelcheck._CATALOG + [scn])
    traces = tmp_path / "traces"
    findings, _stats = modelcheck.run_catalog(trace_dir=str(traces))
    assert findings and "fixture_bad_trace" in findings[-1].message
    artifact = traces / "fixture_bad_trace.trace.json"
    assert artifact.exists()
    run = modelcheck.replay_trace(str(artifact))
    assert run.violation is not None and "epoch-monotone" in run.violation


# --------------------------------------------- resource contracts (pass 6)

def test_fixture_release_on_one_path_only(tmp_path):
    path = _port_fixture_path(tmp_path, "fixture_release_one_path.py")
    with open(path) as f:
        findings, _used = resources.scan_leaks(f.read(), path)
    leaks = [f for f in findings if "not released on every path"
             in f.message]
    assert leaks, core.format_report(findings)
    assert leaks[0].line == _marker_line(path)
    assert len(leaks) == 1


def test_fixture_raw_epoch_equality(tmp_path):
    path = _port_fixture_path(tmp_path, "fixture_epoch_eq.py")
    with open(path) as f:
        findings, _used = resources.scan_epoch_compares(f.read(), path)
    hits = [f for f in findings if "raw ==/!=" in f.message]
    assert hits, core.format_report(findings)
    assert hits[0].line == _marker_line(path)
    assert hits[1].line == _marker_line(path, "seeded-taint")
    assert len(hits) == 2


def test_fixture_stale_pragma(tmp_path):
    path = _port_fixture_path(tmp_path, "fixture_stale_pragma.py")
    with open(path) as f:
        findings = concurrency.scan_source(f.read(), path)
    stale = [f for f in findings if "stale pragma" in f.message]
    assert stale, core.format_report(findings)
    assert stale[0].line == _marker_line(path)
    assert len(findings) == 1


def test_leak_lint_structural_coverage():
    clean_finally = (
        "class C:\n"
        "    def f(self, ledger, n):\n"
        "        ledger.charge(0, n)\n"
        "        try:\n"
        "            work()\n"
        "        finally:\n"
        "            ledger.release(0, n)\n")
    findings, _ = resources.scan_leaks(clean_finally, "<mem>")
    assert not findings, core.format_report(findings)

    leak_except_only = (
        "class C:\n"
        "    def f(self, ledger, n):\n"
        "        ledger.charge(0, n)\n"
        "        try:\n"
        "            return work()\n"
        "        except Exception:\n"
        "            ledger.release(0, n)\n"
        "            raise\n")
    findings, _ = resources.scan_leaks(leak_except_only, "<mem>")
    assert len(findings) == 1 and findings[0].line == 3

    clean_both_arms = (
        "class C:\n"
        "    def f(self, ledger, n, ok):\n"
        "        ledger.charge(0, n)\n"
        "        if ok:\n"
        "            ledger.release(0, n)\n"
        "            return True\n"
        "        ledger.release(0, n)\n"
        "        return False\n")
    findings, _ = resources.scan_leaks(clean_both_arms, "<mem>")
    assert not findings, core.format_report(findings)


def test_epoch_lint_monotone_and_sentinel_allowed():
    src = ("EPOCH_DEAD = -1\n"
           "def f(epoch, prev_epoch):\n"
           "    if epoch == EPOCH_DEAD:\n"
           "        return None\n"
           "    if epoch <= prev_epoch:\n"
           "        return False\n"
           "    return True\n")
    findings, _ = resources.scan_epoch_compares(src, "<mem>")
    assert not findings, core.format_report(findings)
    src_eq = ("class M:\n"
              "    def __eq__(self, other):\n"
              "        return self.epoch == other.epoch\n")
    findings, _ = resources.scan_epoch_compares(src_eq, "<mem>")
    assert not findings, core.format_report(findings)


# ------------------------------------------------------------ CLI + gated

def test_cli_exit_code_plumbing(monkeypatch, capsys):
    from sparkrdma_tpu_torch.analysis import __main__ as cli

    monkeypatch.setattr(cli, "run_all", lambda: [])
    assert cli.main([]) == 0
    assert "clean (0 findings)" in capsys.readouterr().out
    boom = core.Finding("wire", "x.py", 3, "boom")
    monkeypatch.setattr(cli, "run_all", lambda: [boom])
    assert cli.main([]) == 1
    assert "x.py:3: [wire] boom" in capsys.readouterr().out


def test_analysis_modules_import_no_torch():
    """The harness runs under an ASan preload, which must never share a
    process with ``torch`` (libasan and the CUDA driver do not mix): the
    analysis modules import neither ``torch`` nor ``jax``."""
    code = ("import sys\n"
            "import sparkrdma_tpu_torch.analysis.__main__\n"
            "from sparkrdma_tpu_torch.analysis import (native_harness, "
            "modelcheck, wire, lockgraph)\n"
            "print(sorted(m for m in ('torch', 'jax', 'sparkrdma_tpu') "
            "if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("RUN_SANITIZERS") != "1",
                    reason="RUN_SANITIZERS=1 builds + runs the "
                           "ASan/UBSan native harness")
def test_native_sanitizer_harness():
    asan_so = shim_build.sanitized_shim_path("asan")
    ubsan_so = shim_build.sanitized_shim_path("ubsan")
    libasan = subprocess.run(
        [os.environ.get("CXX", "g++"), "-print-file-name=libasan.so"],
        capture_output=True, text=True, check=True).stdout.strip()
    for so, extra_env in ((asan_so, {"LD_PRELOAD": libasan,
                                     "ASAN_OPTIONS": "detect_leaks=0"}),
                          (ubsan_so, {})):
        proc = subprocess.run(
            [sys.executable, "-m",
             "sparkrdma_tpu_torch.analysis.native_harness", str(so)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, **extra_env})
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "all exercises passed" in proc.stdout


# --------------------------------------------- parity with the JAX package

def _lints(conc, res, source, path):
    """Each lint's findings as (pass, the flagged line's text, message
    with the prefix rewritten): a named hunk shifts the lines after it,
    not what a finding points at."""
    lines = [""] + source.splitlines()

    def keys(findings):
        return [(f.pass_name, lines[f.line].strip(),
                 PREFIX.sub("sparkrdma_tpu_torch", f.message))
                for f in findings]

    return (keys(conc.scan_source(source, path)),
            keys(res.scan_leaks(source, path)[0]),
            keys(res.scan_epoch_compares(source, path)[0]))


_FIXTURE_SOURCES = sorted(f for f in os.listdir(FIXTURES)
                          if f.endswith(".py"))


@pytest.mark.parametrize("fname", _FIXTURE_SOURCES)
def test_lints_match_reference_on_fixtures(tmp_path, fname):
    """The concurrency lint and both resource lints give the reference's
    findings, modulo the prefix, on each fixture."""
    with open(os.path.join(FIXTURES, fname)) as f:
        ref = f.read()
    with open(_port_fixture_path(tmp_path, fname)) as f:
        port = f.read()
    assert (_lints(concurrency, resources, port, fname)
            == _lints(jconcurrency, jresources, ref, fname))


@pytest.mark.parametrize("path", port_host_plane.LOCKSTEP)
def test_lints_match_reference_on_lockstep_modules(path):
    """The same on every module the port copies, the port's copy against
    the reference's original (the named hunks add no finding)."""
    with open(os.path.join(ROOT, "sparkrdma_tpu_torch", path)) as f:
        port = f.read()
    with open(os.path.join(ROOT, "sparkrdma_tpu", path)) as f:
        ref = f.read()
    assert (_lints(concurrency, resources, port, path)
            == _lints(jconcurrency, jresources, ref, path))


def test_wire_doc_tables_equal():
    assert wire.render_msg_id_table() == jwire.render_msg_id_table()


def test_modelcheck_catalogs_match_reference(catalogs):
    """Both catalogs enumerate the same schedules per scenario at the
    same budgets, and both are clean."""
    (port_findings, port_stats), (jax_findings, jax_stats) = (
        catalogs["port"], catalogs["jax"])
    assert not port_findings and not jax_findings
    as_rows = [(s.name, s.dfs_schedules, s.walk_schedules,
                s.max_depth_seen, s.budget_hit) for s in port_stats]
    assert as_rows == [(s.name, s.dfs_schedules, s.walk_schedules,
                        s.max_depth_seen, s.budget_hit) for s in jax_stats]


def test_bad_trace_same_violating_schedule_as_reference(tmp_path):
    port = _load_fixture(tmp_path, "fixture_bad_trace")
    ref = _load_jax_fixture("fixture_bad_trace")
    found = {}
    for name, mod, sched, mc in (("port", port, scheduler, modelcheck),
                                 ("jax", ref, jscheduler, jmodelcheck)):
        runs = sched.explore_dfs(mod.build, mc.check_invariants)
        found[name] = [(list(r.trace), r.violation) for r in runs
                       if r.violation is not None]
    assert found["port"] and found["port"] == found["jax"]


def test_trace_registry_is_reference_plus_port_names():
    assert trace_names.SPANS == jtrace_names.SPANS | PORT_SPANS
    assert not jtrace_names.SPANS & PORT_SPANS
    assert trace_names.INSTANTS == jtrace_names.INSTANTS
    assert trace_names.COUNTERS == jtrace_names.COUNTERS


# ----------------------------------------------------- the trace-name repair

def test_port_emits_every_trace_name_as_a_literal():
    """Every span the port's drivers, mesh service and step paths open
    names itself as a literal at the ``trace_mod.span`` call, so the drift
    pass sees ``exchange.round`` and every port-only name, and none is
    unregistered."""
    emitted, _ = drift._emitted_trace_names(ROOT)
    assert emitted["span"] >= PORT_SPANS | {"exchange.round"}
    findings = drift.check_trace_names(ROOT)
    assert not findings, "\n" + core.format_report(findings)


def test_driver_spans_keep_names_nesting_and_profiler_spans():
    """The fused round driver's host spans: one ``exchange.round`` per
    round with its args, an ``exchange.stage`` inside each, an
    ``exchange.collect`` per round and one ``exchange.merge``; each one
    ``trace_mod.span``, which also opens a ``record_function`` range of
    the same name while ``torch.profiler`` records. The
    mesh service's ``_spanned`` opens one span per batch it produces, and
    one for the exhausted read."""
    mesh = VirtualMesh(8, "cpu")
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**32, size=(8 * 300, 4), dtype=np.uint32)
    dest = rng.integers(0, 8, size=len(rows)).astype(np.int32)
    tracer = Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _out, rounds = device_plane.run_fused_exchange(
            mesh, rows, dest, key_words=2, impl="ring", out_factor=4,
            rows_per_round=128, tracer=tracer)
    assert rounds == 3
    spans = {name: tracer.events(name) for name in (
        "exchange.round", "exchange.stage", "exchange.collect",
        "exchange.merge")}
    assert [len(v) for v in spans.values()] == [3, 3, 3, 1]
    for r, (rnd, st) in enumerate(zip(spans["exchange.round"],
                                      spans["exchange.stage"])):
        assert rnd["args"]["round"] == st["args"]["round"] == r
        assert set(rnd["args"]) == {"round", "rows", "slot_rows"}
        assert rnd["ts"] <= st["ts"]
        assert st["ts"] + st["dur"] <= rnd["ts"] + rnd["dur"]
    profiled = {e.key for e in prof.key_averages()}
    assert set(spans) <= profiled

    decode = Tracer()
    got = list(mesh_service._spanned(
        iter([1, 2]), lambda: decode.span("mesh.decode", "mesh")))
    assert got == [1, 2] and len(decode.events("mesh.decode")) == 3


# ------------------------------------------------------ the sanitized shims

def test_sanitized_shim_build_raises_with_the_compilers_message(
        tmp_path, monkeypatch):
    """A failed instrumented build raises with ``g++``'s error and leaves
    no library: a sanitizer run never falls back to an uninstrumented
    one."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(shim_build, "SHIM_CSRC", csrc)
    monkeypatch.setattr(shim_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        shim_build.sanitized_shim_path("ubsan")
    assert not list((tmp_path / "build").glob("*.so"))
    with pytest.raises(ValueError, match="unknown sanitizer"):
        shim_build.sanitized_shim_path("tsan")
