"""The port stands alone: no module of ``sparkrdma_tpu_torch`` and no line
of ``chip_smoke.py`` imports ``jax`` or anything of ``sparkrdma_tpu``.
Checked on the sources' import statements, on import statements written
inside strings (code a subprocess runs), and on a fresh interpreter's
loaded modules, so it needs no GPU. This file imports no JAX itself."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sparkrdma_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sparkrdma_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


# an import statement inside a string: code a subprocess runs
# (``python -c``), which the AST walk above does not see
STRING_IMPORT = re.compile(
    r"(?:^|[;\n])[ \t]*(?:import|from)[ \t]+(jax|jaxlib|sparkrdma_tpu)\b")


def _string_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for match in STRING_IMPORT.finditer(node.value):
                yield node.lineno, match.group(1)


def test_port_has_sources():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES[:-1]}
    for must in ("ops/ring_exchange.py", "parallel/exchange.py",
                 "parallel/device_plane.py", "parallel/multihost.py",
                 "models/terasort.py",
                 "models/als.py", "models/pagerank.py", "models/join.py",
                 "models/tpcds.py", "models/tpcds_queries.py",
                 "ops/sort.py", "ops/aggregate.py", "parallel/topology.py",
                 "utils/trace.py", "shuffle/mesh_service.py",
                 "shuffle/reader.py",
                 "shuffle/writer.py", "shuffle/fetcher.py",
                 "shuffle/planner.py", "shuffle/manager.py",
                 "utils/integrity.py", "engine.py", "rdd.py", "tasks.py",
                 "shared_vars.py", "config.py", "runtime/native.py",
                 "runtime/shim_build.py",
                 "runtime/pool.py", "runtime/staging.py",
                 "runtime/blockserver.py", "parallel/endpoints.py",
                 "parallel/transport.py", "parallel/membership.py",
                 "shuffle/spark_compat.py", "shuffle/resolver.py",
                 "shuffle/native_fetch.py", "shuffle/push_merge.py",
                 "shuffle/ha.py", "shuffle/cold_tier.py",
                 "shuffle/tenancy.py", "shuffle/shard_plane.py",
                 "shuffle/dist_cache.py", "utils/codecs.py"):
        assert must in names
    assert (PORT / "csrc" / "ring_exchange.cu").exists()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_no_jax_or_reference_package_import(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_no_jax_or_reference_import_inside_a_string(path):
    bad = list(_string_imports(path))
    assert not bad, f"{path.name} runs code importing {bad}"


def test_string_import_check_sees_a_subprocess_source():
    """The check flags the JAX package's block-server script, which a
    subprocess runs from a string, and passes the port's."""
    ref = ROOT / "sparkrdma_tpu" / "shuffle" / "client_bench.py"
    assert [root for _, root in _string_imports(ref)] == ["sparkrdma_tpu"]
    port = PORT / "shuffle" / "client_bench.py"
    assert list(_string_imports(port)) == []


def test_import_loads_no_jax_and_no_triton():
    """Importing every module loads no JAX and no Triton."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sparkrdma_tpu', 'triton')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_import_is_lazy():
    """``import sparkrdma_tpu_torch`` loads the configuration only: no
    socket code, no torch; the engine-facing names resolve on first use,
    as the JAX package's top-level exports do."""
    names = ("TpuShuffleManager", "SparkCompatShuffleManager", "DAGEngine",
             "MapStage", "ResultStage", "EngineContext", "RDD", "BatchRDD",
             "Broadcast", "Accumulator", "ShuffleDependency",
             "PartitionerSpec", "ShuffleHandle")
    code = ("import sys\n"
            "import sparkrdma_tpu_torch as p\n"
            "early = sorted(m for m in ('socket', 'torch', "
            "'sparkrdma_tpu_torch.parallel.transport', "
            "'sparkrdma_tpu_torch.runtime.native') if m in sys.modules)\n"
            f"got = {{n: getattr(p, n).__module__ for n in {names!r}}}\n"
            "print(early, got)\n"
            "sys.exit(1 if early else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "sparkrdma_tpu_torch.engine" in proc.stdout
    assert "sparkrdma_tpu_torch.rdd" in proc.stdout
    assert "sparkrdma_tpu." not in proc.stdout


def test_chip_smoke_worker_path_loads_no_jax_and_needs_a_card():
    """``chip_smoke.py --multihost-worker`` (the multihost phase's worker
    processes) loads no JAX and nothing of the JAX package, and without
    a card it raises before printing any result."""
    code = ("import runpy, sys\n"
            "sys.argv = ['chip_smoke.py', '--multihost-worker', '0', '1', "
            "'.']\n"
            "try:\n"
            "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__, e)\n"
            "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'sparkrdma_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    assert "MULTIHOST_WORKER" not in proc.stdout
    import torch

    if not torch.cuda.is_available():
        assert "RAISED RuntimeError no CUDA device" in proc.stdout, \
            proc.stdout
