"""The port's copies of the JAX package's host plane stay in lockstep.

Every module in ``scripts/port_host_plane.py``'s ``LOCKSTEP`` list must
equal its original in ``sparkrdma_tpu/`` with the package prefix
rewritten (``sparkrdma_tpu`` -> ``sparkrdma_tpu_torch``) and the script's
named hunks applied; there are three: ``runtime/native.py``'s
``_LIB_PATH``, the port-only span names in ``utils/trace_names.py`` and
the port's own threaded modules in ``analysis/concurrency.py``.
Every other ``.py`` of the port must be in ``PORTED``, the modules
written for the port, so that no new file escapes both lists. Two ported
modules are copies with a few changed regions, and those are checked
too: ``shuffle/reader.py`` differs only in ``read_to_device``, and
``engine.py`` only where the device API differs. This file imports no
JAX."""

import ast
import difflib
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sparkrdma_tpu_torch"
REFERENCE = ROOT / "sparkrdma_tpu"

_spec = importlib.util.spec_from_file_location(
    "port_host_plane", ROOT / "scripts" / "port_host_plane.py")
port_host_plane = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(port_host_plane)
LOCKSTEP = port_host_plane.LOCKSTEP

# written for the port: torch versions of the JAX package's device
# modules, the port's own helpers, and two copies with changed regions
PORTED = (
    "__init__.py",
    "__main__.py",
    "bench.py",
    "engine.py",
    "models/__init__.py",
    "models/als.py",
    "models/join.py",
    "models/pagerank.py",
    "models/terasort.py",
    "models/tpcds.py",
    "models/tpcds_queries.py",
    "ops/__init__.py",
    "ops/_build.py",
    "ops/aggregate.py",
    "ops/dest_partition.py",
    "ops/hash_lookup.py",
    "ops/normal_equations.py",
    "ops/partition.py",
    "ops/ragged_exchange.py",
    "ops/ring_exchange.py",
    "ops/row_gather.py",
    "ops/run_merge.py",
    "ops/sort.py",
    "parallel/device_plane.py",
    "parallel/exchange.py",
    "parallel/mesh.py",
    "parallel/multihost.py",
    "parallel/topology.py",
    "runtime/shim_build.py",
    "shuffle/client_bench.py",
    "shuffle/device_bench.py",
    "shuffle/mesh_service.py",
    "shuffle/reader.py",
    "shuffle/topo_bench.py",
    "utils/__init__.py",
    "utils/trace.py",
    "utils/u32.py",
)


def _rewritten(path: str) -> str:
    return port_host_plane.PREFIX.sub(
        "sparkrdma_tpu_torch", (REFERENCE / path).read_text())


@pytest.mark.parametrize("path", LOCKSTEP)
def test_copy_equals_reference(path):
    got = (PORT / path).read_text()
    want = port_host_plane.expected(path)
    if got != want:
        diff = "".join(difflib.unified_diff(
            want.splitlines(True), got.splitlines(True),
            f"expected/{path}", f"port/{path}", n=1))
        pytest.fail(f"{path} drifted from the reference:\n{diff[:4000]}")


def test_the_one_named_hunk():
    """Three files carry hunks, one each, with its reason: the shim's
    path, the port-only span names, the port's threaded modules."""
    hunks = port_host_plane.HUNKS
    assert list(hunks) == ["runtime/native.py", "utils/trace_names.py",
                           "analysis/concurrency.py"]
    assert all(len(v) == 1 for v in hunks.values())
    ((old, new, reason),) = hunks["runtime/native.py"]
    assert old.startswith("_LIB_PATH =") and "build/" in new
    assert "libtpushuffle.so" in reason
    native = (PORT / "runtime" / "native.py").read_text()
    assert old not in native and new in native
    assert "sparkrdma_tpu/runtime" not in native


def _added_lines(path):
    """The lines the path's one hunk adds, stripped, comments dropped."""
    ((old, new, reason),) = port_host_plane.HUNKS[path]
    assert set(old.splitlines()) <= set(new.splitlines())
    added = [ln.strip() for ln in new.splitlines()
             if ln not in old.splitlines()]
    return [ln for ln in added if not ln.startswith("#")], reason


def test_trace_names_hunk_adds_only_port_span_names():
    """The registry's hunk only adds span names: the seven the port's host
    drivers and mesh service emit, then its step spans in order, each a
    literal the port opens; every other line is the reference's."""
    added, reason = _added_lines("utils/trace_names.py")
    assert added[:7] == ['"exchange.collect",', '"exchange.merge",',
                         '"exchange.stage",', '"mesh.decode",',
                         '"mesh.pack",', '"mesh.partition",',
                         '"mesh.unpack",']
    step = [ln[1:-2] for ln in added[7:]]
    assert all(re.fullmatch(r'"[a-z0-9_.]+",', ln) for ln in added[7:])
    assert step == sorted(set(step))
    assert {"mesh.take_rows", "exchange.group", "exchange.receive_fill",
            "q95.aggregate.sort", "exchange.transport"} <= set(step)
    assert "fused.exchange" not in step
    opened = set(re.findall(r'trace_mod\.span\(\s*"([a-z0-9_.]+)"',
                            "".join(p.read_text()
                                    for p in PORT.rglob("*.py"))))
    assert set(step) <= opened
    assert "reference lacks" in reason


def test_concurrency_hunk_only_extends_threaded_modules():
    """The lint's hunk keeps the reference's 24 modules and adds the
    port's own modules that lock or keep per-thread state."""
    added, reason = _added_lines("analysis/concurrency.py")
    assert added == ['"sparkrdma_tpu_torch/ops/_build.py",',
                     '"sparkrdma_tpu_torch/ops/ring_exchange.py",',
                     '"sparkrdma_tpu_torch/parallel/topology.py",']
    assert reason
    ast_mod = ast.parse((PORT / "analysis" / "concurrency.py").read_text())
    listed = next(ast.literal_eval(n.value) for n in ast_mod.body
                  if isinstance(n, ast.Assign)
                  and n.targets[0].id == "THREADED_MODULES")
    ref = ast.parse((REFERENCE / "analysis" / "concurrency.py").read_text())
    ref_listed = next(ast.literal_eval(n.value) for n in ref.body
                      if isinstance(n, ast.Assign)
                      and n.targets[0].id == "THREADED_MODULES")
    assert len(ref_listed) == 24
    assert listed[:24] == [port_host_plane.PREFIX.sub(
        "sparkrdma_tpu_torch", m) for m in ref_listed]
    assert all((ROOT / m).exists() for m in listed)


def test_every_port_module_is_listed():
    on_disk = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert not set(LOCKSTEP) & set(PORTED)
    assert len(set(LOCKSTEP)) == len(LOCKSTEP)
    assert on_disk - set(LOCKSTEP) - set(PORTED) == set(), \
        "a module is in neither LOCKSTEP nor PORTED"
    assert set(LOCKSTEP) | set(PORTED) <= on_disk
    for path in LOCKSTEP:
        assert (REFERENCE / path).exists(), path


def _defs(text: str) -> dict:
    """Source of every top-level function and class, and of every method
    as ``Class.method``."""
    tree = ast.parse(text)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out[f"{node.name}.{item.name}"] = \
                        ast.get_source_segment(text, item)
    return out


def test_reader_differs_only_in_read_to_device():
    want = _defs(_rewritten("shuffle/reader.py"))
    got = _defs((PORT / "shuffle" / "reader.py").read_text())
    changed = {name for name in want if got.get(name) != want[name]}
    assert changed == {"TpuShuffleReader", "TpuShuffleReader.read_to_device"}
    strip = re.compile(r"    def read_to_device\(.*?(?=\n    def |\Z)", re.S)
    assert (strip.sub("", got["TpuShuffleReader"])
            == strip.sub("", want["TpuShuffleReader"]))
    assert set(got) - set(want) == {"_split_rows", "_gather",
                                    "read_to_device", "_donated"}


# engine.py against the reference: every line the port adds or removes
# (stripped), with its reason
ENGINE_ADDED = (
    # blank line before the docstring paragraph
    r"",
    # the port's docstring paragraph
    r"Port of ``sparkrdma_tpu/engine.py``.*",
    r"``parallel\.mesh\.VirtualMesh``.*",
    r"stages ride the port's.*",
    r"there takes an axis name\..*",
    r"collective across executor processes\).*",
    r"``parallel/multihost\.py``; each executor process.*",
    r"``multihost\.init_multihost`` at startup\.",
    # the mesh is a VirtualMesh
    r"# ICI data plane: with a VirtualMesh here.*",
    # dist mode's rank and world size come from the port's multihost
    r"global_mesh, process_count, process_index,",
    r"run_multihost_mesh_reduce\)",
    r"return \(process_index\(\), process_count\(\), parts\)",
    # the port's device API: no axis names
    r"n_dev = self\.mesh\.num_shards",
    r"impl=plan\.impl,",
    r"mgrs, handle, self\.mesh,",
    r"topo = topology_mod\.detect_topology\(self\.mesh, conf\)",
    r"return select_dataplane\(self\.mesh, profile,",
)
ENGINE_REMOVED = (
    # the blank line after dist mode's jax import
    r"",
    # the mesh was a jax.sharding.Mesh
    r"# ICI data plane: with a jax\.sharding\.Mesh here, on-mesh stages'",
    # dist mode's rank and world size came from jax
    r"import jax",
    r"global_mesh, run_multihost_mesh_reduce\)",
    r"return \(jax\.process_index\(\), jax\.process_count\(\), parts\)",
    # the JAX device API's axis names
    r"n_dev = self\.mesh\.shape\[self\.mesh_axis\]",
    r"axis_name=self\.mesh_axis, impl=plan\.impl,",
    r"mgrs, handle, self\.mesh, axis_name=self\.mesh_axis,",
    r"topo = topology_mod\.detect_topology\(self\.mesh, self\.mesh_axis,",
    r"conf\)",
    r"return select_dataplane\(self\.mesh, self\.mesh_axis, profile,",
)
# the only functions whose bodies change (their class's source with them)
ENGINE_CHANGED = {"DAGEngine", "DAGEngine.__init__",
                  "_make_dist_collective",
                  "DAGEngine._compute_mesh_partitions",
                  "DAGEngine._select_plan"}


def test_engine_differs_only_where_the_device_api_does():
    """Every line the port adds or removes is on a list, with its reason,
    and only the listed functions change; distributed mode is the
    reference's, calling the port's multihost."""
    ref = _rewritten("engine.py")
    port = (PORT / "engine.py").read_text()
    want, got = _defs(ref), _defs(port)
    assert set(want) == set(got)
    changed = {name for name in got if got[name] != want[name]}
    assert changed == ENGINE_CHANGED
    diff = list(difflib.unified_diff(
        ref.splitlines(), port.splitlines(), lineterm="", n=0))
    added = [line[1:].strip() for line in diff
             if line.startswith("+") and not line.startswith("+++")]
    removed = [line[1:].strip() for line in diff
               if line.startswith("-") and not line.startswith("---")]
    for line in added:
        assert any(re.fullmatch(p, line) for p in ENGINE_ADDED), line
    for line in removed:
        assert any(re.fullmatch(p, line) for p in ENGINE_REMOVED), line
    assert "import jax" not in port
