"""Pass 2b — static concurrency lints over the threaded modules.

Two AST heuristics, each silenced per line by a reasoned pragma
(``core.collect_pragmas``):

* **unguarded-write** — inside a class that owns a lock
  (``self.<x> = threading.Lock()/RLock()/Condition()``), an attribute
  counts as SHARED once it is read or written under any
  ``with self.<lock>`` block; every OTHER write to it — outside
  ``__init__`` and outside a with-lock block — is a finding. The
  evidence rule keeps the pass quiet on single-threaded attributes
  while catching the classic "updated under the lock on the hot path,
  clobbered without it in close()" race.
  Pragma: ``# analysis: unguarded-ok(<why this write is safe>)``.

* **wait lints** — a ``Condition.wait`` call must sit inside a
  ``while`` predicate loop (spurious wakeups and stolen wakeups are
  real; an ``if`` re-checks nothing), and must carry a timeout unless
  pragma'd (a deadline turns a lost-notify bug into a bounded stall
  instead of a hang). Rules: ``wait-loop`` and ``wait-deadline``;
  pragma ``# analysis: wait-ok(<why>)`` silences either.

The module list is explicit (``THREADED_MODULES``) — these are the
files where more than one thread runs; applying the heuristics to
pure single-threaded modules would only breed pragmas.

Pragmas are audited for staleness: an ``unguarded-ok``/``wait-ok`` on
a line the lint no longer flags is itself a finding
(``core.audit_stale_pragmas``) — dead pragmas drift behind refactors
and then document hazards that no longer exist.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from sparkrdma_tpu_torch.analysis.core import (Finding, audit_stale_pragmas,
                                         collect_pragmas, rel, repo_root,
                                         suppressed)

PASS = "concurrency"

# Modules where multiple threads touch shared state (driver/executor
# endpoints, writers with spill workers, pools, fetch pipelines, ...).
THREADED_MODULES = [
    "sparkrdma_tpu_torch/parallel/endpoints.py",
    "sparkrdma_tpu_torch/parallel/membership.py",
    "sparkrdma_tpu_torch/parallel/transport.py",
    "sparkrdma_tpu_torch/parallel/faults.py",
    "sparkrdma_tpu_torch/parallel/exchange.py",
    "sparkrdma_tpu_torch/shuffle/writer.py",
    "sparkrdma_tpu_torch/shuffle/fetcher.py",
    "sparkrdma_tpu_torch/shuffle/resolver.py",
    "sparkrdma_tpu_torch/shuffle/manager.py",
    "sparkrdma_tpu_torch/shuffle/location_plane.py",
    "sparkrdma_tpu_torch/shuffle/dist_cache.py",
    "sparkrdma_tpu_torch/shuffle/planner.py",
    "sparkrdma_tpu_torch/shuffle/push_merge.py",
    "sparkrdma_tpu_torch/shuffle/cold_tier.py",
    "sparkrdma_tpu_torch/shuffle/pushed_store.py",
    "sparkrdma_tpu_torch/shuffle/shard_plane.py",
    "sparkrdma_tpu_torch/shuffle/tenancy.py",
    "sparkrdma_tpu_torch/runtime/pool.py",
    "sparkrdma_tpu_torch/runtime/staging.py",
    "sparkrdma_tpu_torch/runtime/blockserver.py",
    "sparkrdma_tpu_torch/shared_vars.py",
    "sparkrdma_tpu_torch/engine.py",
    "sparkrdma_tpu_torch/utils/stats.py",
    "sparkrdma_tpu_torch/utils/trace.py",
    # the port's own modules that lock or keep per-thread state
    "sparkrdma_tpu_torch/ops/_build.py",
    "sparkrdma_tpu_torch/ops/ring_exchange.py",
    "sparkrdma_tpu_torch/parallel/topology.py",
]

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}


def _is_lock_ctor(node: ast.AST) -> bool:
    """``threading.Lock()`` / ``threading.RLock()`` /
    ``threading.Condition(...)``."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _LOCK_FACTORIES
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "threading")


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _withitem_lock(item: ast.withitem, locks: Set[str]) -> bool:
    """Does one ``with`` item enter a known lock? Accepts
    ``self.<lock>`` and ``self.<lock>.something()`` shapes (e.g.
    ``self._cv`` or a wrapped acquire helper on the lock)."""
    expr = item.context_expr
    name = _self_attr(expr)
    if name is None and isinstance(expr, ast.Call):
        name = _self_attr(expr.func)
        if name is None and isinstance(expr.func, ast.Attribute):
            name = _self_attr(expr.func.value)
    return name in locks


class _ClassScan(ast.NodeVisitor):
    """One pass over a ClassDef: find lock attrs, then classify every
    ``self._*`` access as guarded (lexically under ``with self.<lock>``)
    or not, per method."""

    def __init__(self, locks: Set[str], conditions: Set[str]):
        self.locks = locks
        self.conditions = conditions
        self.guarded_reads: Set[str] = set()
        self.guarded_writes: Set[str] = set()
        # (attr, line, in_init) for every write outside a with-lock
        self.unguarded_writes: List[Tuple[str, int, bool]] = []
        # (cond_attr, line, in_while, has_timeout)
        self.waits: List[Tuple[str, int, bool, bool]] = []
        self._with_depth = 0
        self._while_depth = 0
        self._func_stack: List[str] = []

    # -- scope tracking
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        saved_with, saved_while = self._with_depth, self._while_depth
        # repo convention: a ``*_locked`` method's CONTRACT is that the
        # caller already holds the lock — its whole body is guarded
        self._with_depth = 1 if node.name.endswith("_locked") else 0
        self._while_depth = 0
        self.generic_visit(node)
        self._with_depth, self._while_depth = saved_with, saved_while
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        return  # nested classes are scanned by their own _ClassScan

    def visit_With(self, node: ast.With) -> None:
        is_lock = any(_withitem_lock(i, self.locks) for i in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if is_lock:
            self._with_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if is_lock:
            self._with_depth -= 1

    def visit_While(self, node: ast.While) -> None:
        self.visit(node.test)
        self._while_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self._while_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    # -- accesses
    def _record_write(self, target: ast.AST) -> None:
        attr = _self_attr(target)
        if attr is None or not attr.startswith("_") or attr in self.locks:
            return
        in_init = bool(self._func_stack) and self._func_stack[0] == "__init__"
        if self._with_depth > 0:
            self.guarded_writes.add(attr)
        else:
            self.unguarded_writes.append((attr, target.lineno, in_init))

    def _record_target(self, t: ast.AST) -> None:
        """Record only the attributes an assignment target actually
        MUTATES: ``self._x = ...`` and container writes like
        ``self._d[k] = ...`` — never the reads inside an index
        (``local[self._idx] = 2`` does not write ``_idx``)."""
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._record_target(e)
        elif isinstance(t, ast.Starred):
            self._record_target(t.value)
        elif isinstance(t, ast.Attribute):
            self._record_write(t)
        elif isinstance(t, ast.Subscript):
            if isinstance(t.value, ast.Attribute):
                self._record_write(t.value)
            self.visit(t.slice)  # index reads still count as evidence

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_target(t)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target)
            self.visit(node.value)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if (attr is not None and attr.startswith("_")
                and attr not in self.locks and self._with_depth > 0
                and isinstance(node.ctx, ast.Load)):
            self.guarded_reads.add(attr)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "wait"):
            recv = _self_attr(node.func.value)
            if recv in self.conditions:
                has_timeout = bool(node.args) or any(
                    kw.arg == "timeout" for kw in node.keywords)
                self.waits.append((recv, node.lineno,
                                   self._while_depth > 0, has_timeout))
        self.generic_visit(node)


def _class_locks(cls: ast.ClassDef) -> Tuple[Set[str], Set[str]]:
    """Attribute names assigned a lock / condition anywhere in the
    class (usually ``__init__``)."""
    locks: Set[str] = set()
    conditions: Set[str] = set()
    for node in ast.walk(cls):
        value = getattr(node, "value", None)
        if value is None or not _is_lock_ctor(value):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, (ast.AnnAssign,
                                                           ast.AugAssign))
                   else [])
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                locks.add(attr)
                if value.func.attr == "Condition":
                    conditions.add(attr)
    return locks, conditions


def scan_source(source: str, relpath: str) -> List[Finding]:
    """All concurrency lints over one module's source. Pragma
    suppressions are tracked: one that silences nothing is STALE and a
    finding itself (dead pragmas drift behind refactors and then
    document hazards that no longer exist)."""
    pragmas, findings = collect_pragmas(source, relpath)
    used: set = set()
    tree = ast.parse(source)
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        locks, conditions = _class_locks(cls)
        if not locks:
            continue
        scan = _ClassScan(locks, conditions)
        for stmt in cls.body:
            scan.visit(stmt)
        shared = scan.guarded_reads | scan.guarded_writes
        for attr, line, in_init in scan.unguarded_writes:
            if in_init or attr not in shared:
                continue
            if suppressed(pragmas, line, "unguarded"):
                used.add((line, "unguarded"))
                continue
            findings.append(Finding(
                PASS, relpath, line,
                f"{cls.name}.{attr} is guarded elsewhere but written "
                f"here outside any 'with <lock>' block "
                f"(# analysis: unguarded-ok(reason) if intentional)"))
        for cond, line, in_while, has_timeout in scan.waits:
            if in_while and has_timeout:
                continue  # compliant: a pragma here would be dead
            if suppressed(pragmas, line, "wait"):
                used.add((line, "wait"))
                continue
            if not in_while:
                findings.append(Finding(
                    PASS, relpath, line,
                    f"{cls.name}: {cond}.wait() outside a 'while' "
                    f"predicate loop — spurious/stolen wakeups break it"))
            else:
                findings.append(Finding(
                    PASS, relpath, line,
                    f"{cls.name}: {cond}.wait() without a deadline — a "
                    f"lost notify hangs forever "
                    f"(# analysis: wait-ok(reason) if the wake is "
                    f"guaranteed)"))
    findings += audit_stale_pragmas(source, relpath,
                                    {"unguarded", "wait"}, used)
    return findings


def run(root: Optional[str] = None,
        modules: Optional[Sequence[str]] = None) -> List[Finding]:
    root = root or repo_root()
    findings: List[Finding] = []
    for mod in (modules if modules is not None else THREADED_MODULES):
        path = os.path.join(root, mod)
        if not os.path.exists(path):
            findings.append(Finding(
                PASS, mod, 0,
                "listed in THREADED_MODULES but missing — update the "
                "list in analysis/concurrency.py"))
            continue
        with open(path) as f:
            findings += scan_source(f.read(), rel(root, path))
    return findings
