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
                 "parallel/device_plane.py", "models/terasort.py"):
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
