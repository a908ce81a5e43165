"""The port's copies of the JAX package's host plane stay in lockstep.

Every module in ``scripts/port_host_plane.py``'s ``LOCKSTEP`` list must
equal its original in ``sparkrdma_tpu/`` with the package prefix
rewritten (``sparkrdma_tpu`` -> ``sparkrdma_tpu_torch``) and the script's
named hunks applied; there is one, ``runtime/native.py``'s ``_LIB_PATH``.
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
    "ops/partition.py",
    "ops/ring_exchange.py",
    "ops/sort.py",
    "parallel/device_plane.py",
    "parallel/exchange.py",
    "parallel/mesh.py",
    "parallel/topology.py",
    "runtime/shim_build.py",
    "shuffle/mesh_service.py",
    "shuffle/reader.py",
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
    """Exactly one hunk is allowed, with its reason: the shim's path."""
    hunks = port_host_plane.HUNKS
    assert list(hunks) == ["runtime/native.py"]
    ((old, new, reason),) = hunks["runtime/native.py"]
    assert old.startswith("_LIB_PATH =") and "build/" in new
    assert "libtpushuffle.so" in reason
    native = (PORT / "runtime" / "native.py").read_text()
    assert old not in native and new in native
    assert "sparkrdma_tpu/runtime" not in native


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


# engine.py against the reference: the dist-mode functions, cut whole, and
# every other line the port adds or removes (stripped), with its reason
ENGINE_DIST_ONLY = ("_make_dist_collective", "DAGEngine._dist_mesh_reduce",
                    "DAGEngine._dist_collect")
ENGINE_ADDED = (
    # blank lines around the docstring paragraph and the refusal
    r"",
    # the port's docstring paragraph
    r"Port of ``sparkrdma_tpu/engine.py``.*",
    r"``parallel\.mesh\.VirtualMesh``.*",
    r"stages ride the port's.*",
    r"there takes an axis name\..*",
    r"collective across executor processes\).*",
    r"which is not ported yet.*",
    # the mesh is a VirtualMesh
    r"# ICI data plane: with a VirtualMesh here.*",
    # dist mode refused until parallel/multihost.py is ported
    r"raise NotImplementedError\($",
    r'"distributed mesh mode \(dist_mesh_axis\) is not ported.*',
    r'"needs parallel/multihost\.py.*',
    # the port's device API: no axis names
    r"n_dev = self\.mesh\.num_shards",
    r"impl=plan\.impl,",
    r"mgrs, handle, self\.mesh,",
    r"topo = topology_mod\.detect_topology\(self\.mesh, conf\)",
    r"return select_dataplane\(self\.mesh, profile,",
)
ENGINE_REMOVED = (
    # blank lines the refusal replaces
    r"",
    # the mesh was a jax.sharding.Mesh
    r"# ICI data plane: with a jax\.sharding\.Mesh here, on-mesh stages'",
    # the ctor's dist-mode checks, replaced by the refusal
    r"if mesh is not None:",
    r'raise ValueError\("mesh and dist_mesh_axis are exclusive"\)',
    r"if not all\(self\._is_remote\(ex\) for ex in executors\):",
    r"raise ValueError\(",
    r'"dist_mesh_axis requires every executor to be a "',
    r'"RemoteExecutor \(one per jax\.distributed process\)"\)',
    # _run_stage_tasks' call into the dist-mode reduce
    r"if self\.dist_mesh_axis is not None:",
    r"for p in stage\.parents:",
    r"h = self\._handles\.get\(p\.stage_id\)",
    r"if h is not None:",
    r"self\._dist_mesh_reduce\(h\)",
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
                  "DAGEngine._run_stage_tasks",
                  "DAGEngine._compute_mesh_partitions",
                  "DAGEngine._select_plan"}


def _without(text: str, names) -> str:
    """``text`` with the named top-level functions and methods (their
    decorators included) cut out."""
    tree = ast.parse(text)
    cut = set()
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        items = [(node.name, node)]
        if isinstance(node, ast.ClassDef):
            items += [(f"{node.name}.{item.name}", item)
                      for item in node.body
                      if isinstance(item, ast.FunctionDef)]
        for name, item in items:
            if name in names:
                first = min([item.lineno]
                            + [d.lineno for d in item.decorator_list])
                cut.update(range(first, item.end_lineno + 1))
    return "\n".join(line for i, line in enumerate(text.splitlines(), 1)
                     if i not in cut)


def test_engine_differs_only_where_the_device_api_does():
    """The dist-mode functions are cut whole; every other line the port
    adds or removes is on a list, with its reason, and only the listed
    functions change."""
    ref = _rewritten("engine.py")
    port = (PORT / "engine.py").read_text()
    want, got = _defs(ref), _defs(port)
    assert set(want) - set(got) == set(ENGINE_DIST_ONLY)
    assert set(got) <= set(want)
    changed = {name for name in got if got[name] != want[name]}
    assert changed == ENGINE_CHANGED
    diff = list(difflib.unified_diff(
        _without(ref, ENGINE_DIST_ONLY).splitlines(), port.splitlines(),
        lineterm="", n=0))
    added = [line[1:].strip() for line in diff
             if line.startswith("+") and not line.startswith("+++")]
    removed = [line[1:].strip() for line in diff
               if line.startswith("-") and not line.startswith("---")]
    for line in added:
        assert any(re.fullmatch(p, line) for p in ENGINE_ADDED), line
    for line in removed:
        assert any(re.fullmatch(p, line) for p in ENGINE_REMOVED), line
    assert "import jax" not in port
