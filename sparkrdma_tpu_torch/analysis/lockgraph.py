"""Pass 2a — runtime lock-order race detection.

An instrumented ``threading.Lock``/``RLock``/``Condition`` shim records
the cross-thread lock acquisition graph while real code runs: an edge
A -> B means some thread attempted to acquire a lock created at site B
while holding one created at site A. A cycle in that graph is a
lock-order inversion — two threads interleaving those paths can
deadlock, which no amount of passing tests rules out.

Locks are keyed by their CREATION SITE (``path:line``), i.e. per lock
*role*, not per instance — ``Connection._lock`` created at
endpoints.py:N is one node no matter how many connections exist. Edges
between two locks of the SAME site are recorded but excluded from cycle
detection (two instances of one class locked in sequence — pool
transfers, peer iteration — would otherwise self-report; see
docs/ANALYSIS.md).

Usage::

    graph = lockgraph.install()     # patches threading.Lock/RLock
    ... run the workload ...
    lockgraph.uninstall()
    assert not graph.cycles(), graph.format_cycles()

Wired into the test suite two ways: ``ANALYSIS_LOCKGRAPH=1`` installs
the shim for a whole pytest session (tests/conftest.py, failing the run
at teardown on any cycle), and ``CHAOS_LOCKGRAPH=1`` does the same for
the chaos matrix so fault-injection sweeps double as race detection.
Only locks created inside the ``sparkrdma_tpu_torch`` package are tracked;
everything else gets a raw lock with zero overhead.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS_FILE = os.path.abspath(__file__)


def _creation_site() -> Optional[str]:
    """``relpath:line`` of the first caller frame inside sparkrdma_tpu_torch
    (skipping this module and threading.py); None = foreign lock."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        afn = os.path.abspath(fn)
        if afn != _THIS_FILE and not fn.endswith("threading.py"):
            if afn.startswith(_PKG_DIR + os.sep):
                rp = os.path.relpath(afn, os.path.dirname(_PKG_DIR))
                return f"{rp}:{f.f_lineno}"
            return None
        f = f.f_back
    return None


class LockGraph:
    """The recorded acquisition graph + per-thread held stacks."""

    def __init__(self):
        self._guard = _REAL_LOCK()
        # (from_site, to_site) -> (thread_name, acquire_site) of first obs
        self._edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self._tls = threading.local()

    # -- recording hooks (called by the tracked wrappers) ---------------

    def _held(self) -> List[Tuple[str, int]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    @staticmethod
    def _acquire_site() -> str:
        f = sys._getframe(3)
        while f is not None:
            fn = f.f_code.co_filename
            afn = os.path.abspath(fn)
            # skip threading.py too: a Condition wait() re-acquire must
            # blame the user wait site, not Condition._acquire_restore
            if afn != _THIS_FILE and not fn.endswith("threading.py"):
                return (f"{os.path.relpath(afn, os.path.dirname(_PKG_DIR))}"
                        f":{f.f_lineno}")
            f = f.f_back
        return "?"

    def _note_acquire(self, site: str, lock_id: int) -> None:
        held = self._held()
        if any(i == lock_id for _, i in held):
            return  # reentrant RLock acquire: no new ordering
        for held_site, _ in held:
            if held_site == site:
                continue  # same-role pair: excluded from cycle detection
            key = (held_site, site)
            if key not in self._edges:
                with self._guard:
                    if key not in self._edges:
                        self._edges[key] = (threading.current_thread().name,
                                            self._acquire_site())

    def _push(self, site: str, lock_id: int) -> None:
        self._held().append((site, lock_id))

    def _pop(self, site: str, lock_id: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == (site, lock_id):
                del held[i]
                return

    def _pop_all(self, site: str, lock_id: int) -> None:
        self._tls.held = [e for e in self._held()
                          if e != (site, lock_id)]

    # -- analysis --------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], Tuple[str, str]]:
        with self._guard:
            return dict(self._edges)

    def cycles(self) -> List[List[str]]:
        """Every elementary cycle reachable in the site graph (bounded:
        one representative per back edge found by DFS)."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges():
            adj.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        color: Dict[str, int] = {}  # 0/absent=white, 1=on stack, 2=done
        stack: List[str] = []

        def dfs(node: str) -> None:
            color[node] = 1
            stack.append(node)
            for nxt in sorted(adj.get(node, ())):
                if color.get(nxt, 0) == 1:
                    cyc = stack[stack.index(nxt):] + [nxt]
                    # canonicalize rotation so each cycle reports once
                    body = tuple(cyc[:-1])
                    k = min(range(len(body)), key=lambda i: body[i:] + body[:i])
                    canon = body[k:] + body[:k]
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon) + [canon[0]])
                elif color.get(nxt, 0) == 0:
                    dfs(nxt)
            stack.pop()
            color[node] = 2

        for node in sorted(adj):
            if color.get(node, 0) == 0:
                dfs(node)
        return out

    def format_cycles(self) -> str:
        cycles = self.cycles()
        if not cycles:
            return "lockgraph: acyclic"
        edges = self.edges()
        lines = [f"lockgraph: {len(cycles)} lock-order cycle(s)"]
        for cyc in cycles:
            lines.append("  cycle: " + " -> ".join(cyc))
            for a, b in zip(cyc, cyc[1:]):
                thread, where = edges.get((a, b), ("?", "?"))
                lines.append(f"    {a} -> {b}  (thread {thread}, "
                             f"acquired at {where})")
        return "\n".join(lines)


class _TrackedLock:
    """Records ordering, delegates everything to a real lock."""

    _graph: LockGraph

    def __init__(self, inner, site: str, graph: LockGraph):
        self._inner = inner
        self._site = site
        self._graph = graph

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # note the edge BEFORE blocking: a real deadlock still records
        # the inversion that caused it
        self._graph._note_acquire(self._site, id(self))
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph._push(self._site, id(self))
        return got

    def release(self) -> None:
        self._inner.release()
        self._graph._pop(self._site, id(self))

    def __enter__(self) -> "_TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()


class _TrackedRLock(_TrackedLock):
    """RLock wrapper exposing the protocol ``threading.Condition`` uses
    (``_is_owned``/``_release_save``/``_acquire_restore``), so patched
    ``threading.Condition()`` — whose default lock is ``RLock()``
    resolved in threading's module globals, i.e. this factory while
    installed — keeps exact wait/notify semantics."""

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        self._graph._pop_all(self._site, id(self))
        return state

    def _acquire_restore(self, state) -> None:
        self._graph._note_acquire(self._site, id(self))
        self._inner._acquire_restore(state)
        self._graph._push(self._site, id(self))


_installed: Optional[Tuple[LockGraph, object, object]] = None


def install() -> LockGraph:
    """Patch ``threading.Lock``/``RLock`` with tracking factories and
    return the live graph. Locks created OUTSIDE sparkrdma_tpu_torch get the
    real thing. Idempotent per process: a second install returns the
    existing graph."""
    global _installed
    if _installed is not None:
        return _installed[0]
    graph = LockGraph()

    def make_lock():
        site = _creation_site()
        if site is None:
            return _REAL_LOCK()
        return _TrackedLock(_REAL_LOCK(), site, graph)

    def make_rlock():
        site = _creation_site()
        if site is None:
            return _REAL_RLOCK()
        return _TrackedRLock(_REAL_RLOCK(), site, graph)

    _installed = (graph, threading.Lock, threading.RLock)
    threading.Lock = make_lock  # type: ignore[misc]
    threading.RLock = make_rlock  # type: ignore[misc]
    return graph


def uninstall() -> Optional[LockGraph]:
    """Restore the real factories; returns the graph for inspection.
    Already-created tracked locks keep working (they only reference the
    graph, not the patch)."""
    global _installed
    if _installed is None:
        return None
    graph, real_lock, real_rlock = _installed
    threading.Lock = real_lock  # type: ignore[misc]
    threading.RLock = real_rlock  # type: ignore[misc]
    _installed = None
    return graph


def current() -> Optional[LockGraph]:
    return _installed[0] if _installed is not None else None
