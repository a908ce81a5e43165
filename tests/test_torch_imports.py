"""The port stands alone: no module of ``sparkrdma_tpu_torch`` and no line
of ``chip_smoke.py`` imports ``jax`` or anything of ``sparkrdma_tpu``.
Checked on the sources' import statements and on a fresh interpreter's
loaded modules, so it needs no GPU. This file imports no JAX itself."""

import ast
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


def test_port_has_sources():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES[:-1]}
    for must in ("ops/ring_exchange.py", "parallel/exchange.py",
                 "parallel/device_plane.py", "models/terasort.py",
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
