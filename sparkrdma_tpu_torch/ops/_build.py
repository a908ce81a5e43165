"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). Libraries go into ``build/`` at the root of the
checkout, named by a digest of the source and the flags, so an edited
source never loads a stale library. The source is the only input.
Building happens at first use, never at import. (The host runtime
shim builds apart, in ``runtime/shim_build.py``.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's kernels build from source")
    return str(path)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds",
    "log"}}`` (log = nvcc's output, ``-Xptxas -v`` register counts
    included; empty for a library that was already built). Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    results = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            results[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out\n{log}")
            continue
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def bind(name: str, signatures: Mapping[str, Tuple[Sequence, object]],
         check: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """``load(name)`` with each function named in ``signatures`` (``{name:
    (argtypes, restype)}``, a wrapper's copy of the source's ``extern "C"``
    declarations) given its types, once; ``check(lib)``, if given, runs
    then and raises where the library and its wrapper disagree."""
    lib = _bound.get(name)
    if lib is None:
        lib = load(name)
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = list(argtypes), restype
        if check is not None:
            check(lib)
        _bound[name] = lib
    return lib
