"""Build the port's host runtime shim.

``runtime/native.py`` loads ``libtpushuffle``, the checkout's
``csrc/*.cpp``, when it is imported, so ``host_shim_path`` runs then: it
compiles the sources with ``g++`` and ``csrc/Makefile``'s flags into
``build/`` at the root of the checkout (about 10 s, once), named by a
digest of the sources and the flags, so an edited source never loads a
stale library. Later imports find the library and build nothing.

``sanitized_shim_path`` builds the same sources instrumented with ASan
or UBSan, ``csrc/Makefile``'s ``asan`` and ``ubsan`` targets, into
``build/`` too, for ``analysis/native_harness.py``.
"""

from __future__ import annotations

import fcntl
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Sequence

_ROOT = Path(__file__).resolve().parents[2]
SHIM_CSRC = _ROOT / "csrc"
BUILD_DIR = _ROOT / "build"
BUILD_TIMEOUT_S = 600
# csrc/Makefile's flags, plus <string> included ahead of each source
# (arena.cpp uses std::string without including it, which newer libstdc++
# headers no longer do for it)
SHIM_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
              "-shared", "-include", "string")
# csrc/Makefile's SAN_FLAGS and each target's -fsanitize flags, with the
# same <string> include
SAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer", "-std=c++17", "-fPIC",
             "-Wall", "-Wextra", "-pthread", "-shared", "-include", "string")
SANITIZERS = {
    "asan": ("-fsanitize=address",),
    "ubsan": ("-fsanitize=undefined", "-fno-sanitize-recover=undefined"),
}

log = logging.getLogger(__name__)


def _target(stem: str, flags: Sequence[str]) -> Path:
    """``build/<stem>-<digest>.so``, the digest over the sources and
    ``flags``."""
    sources = sorted(SHIM_CSRC.glob("*.cpp"))
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in sources)
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def _build(stem: str, flags: Sequence[str]) -> Path:
    """Compile ``csrc/*.cpp`` with ``flags`` into ``_target(stem, flags)``
    unless it is there. Processes that start together build it once: the
    first takes a file lock, the rest wait on it and find the library.
    Raises with the compiler's output when the build fails."""
    target = _target(stem, flags)
    if target.exists():
        return target
    sources = sorted(SHIM_CSRC.glob("*.cpp"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            if not sources:
                raise FileNotFoundError(f"no C++ sources in {SHIM_CSRC}")
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *flags,
                   *map(str, sources), "-o", str(tmp)]
            # run in build/, where -include finds no stray "string"
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S, cwd=BUILD_DIR)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"exit {proc.returncode}\n"
                                   f"{proc.stdout}{proc.stderr}")
            # atomic: a concurrent loader sees all or none
            os.replace(tmp, target)
    return target


def host_shim_path() -> Path:
    """The host runtime shim built from ``csrc/*.cpp`` into ``build/``;
    built here when missing. A failed build is logged and the unbuilt
    path returned, so the loader falls back to pure Python as the JAX
    package does without its library."""
    try:
        return _build("libtpushuffle", SHIM_FLAGS)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("host shim build failed (%s); the runtime falls back "
                    "to pure Python", e)
    return _target("libtpushuffle", SHIM_FLAGS)


def sanitized_shim_path(kind: str) -> Path:
    """The shim instrumented with ``kind`` (``"asan"`` or ``"ubsan"``),
    built into ``build/`` when missing (about 15 s). Raises on a failed
    build, with the compiler's message: a sanitizer run without the
    instrumented library is no run, so nothing falls back."""
    if kind not in SANITIZERS:
        raise ValueError(f"unknown sanitizer {kind!r}; "
                         f"one of {sorted(SANITIZERS)}")
    return _build(f"libtpushuffle_{kind}", SAN_FLAGS + SANITIZERS[kind])
