"""Pass 6 — resource-contract static lints.

Two AST passes pinning the contracts the PR 10-14 reviews kept
re-deriving by hand, each silenced per line by a reasoned pragma
(``core.collect_pragmas``):

* **leak** — charge/release pairing over the tenant-ledger consumers
  (``LEDGER_MODULES``). Every ``<ledger>.charge(...)`` acquisition must
  release on ALL paths out of its function (structural all-paths
  analysis: returns, raises, every if/try arm), or carry
  ``# analysis: leak-ok(<why>)``. The pragma'd sites are exactly the
  deliberate ownership transfers (a commit hands its bytes to
  ``_token_disk``; a pool lease hands them to the ``PoolBuffer``) — the
  pragma reason documents WHO releases instead, so the conservation
  story is written where the charge is.

* **epoch-eq** — epoch/fence comparison discipline over the
  epoch-bearing protocol modules (``EPOCH_MODULES``). Epoch-typed
  values (any name/attribute matching the ``EPOCH_NAME`` registry, plus
  local names assigned from one — a one-hop taint) may only be compared
  with MONOTONE guards (``<``/``<=``/``>``/``>=``): raw ``==``/``!=``
  is how stale observations sneak past versioning (an equality check
  can't tell "newer" from "older"). Allowed without pragma: comparison
  against a declared sentinel (``EPOCH_DEAD``, ``UNPUBLISHED``, a
  literal constant) and anything inside ``__eq__``. The legitimate
  exact-match sites — cache-validity checks where equality IS the
  serve rule — carry ``# analysis: epoch-eq-ok(<why>)``.

Both passes audit their own pragmas: a ``leak-ok``/``epoch-eq-ok`` on a
line the lint would no longer flag is itself a finding (a stale pragma
is a false documentation claim — the refactor that made it dead should
have removed it).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from sparkrdma_tpu_torch.analysis.core import (Finding, audit_stale_pragmas,
                                         collect_pragmas, rel, repo_root,
                                         suppressed)

PASS = "resources"

# Modules whose functions acquire against a TenantLedger (or will: the
# blockserver bindings are listed so a future Python-side pin/charge
# lands inside the lint's fence on day one).
LEDGER_MODULES = [
    "sparkrdma_tpu_torch/shuffle/tenancy.py",
    "sparkrdma_tpu_torch/shuffle/resolver.py",
    "sparkrdma_tpu_torch/shuffle/push_merge.py",
    "sparkrdma_tpu_torch/shuffle/cold_tier.py",
    "sparkrdma_tpu_torch/runtime/pool.py",
    "sparkrdma_tpu_torch/runtime/blockserver.py",
]

# Epoch-bearing protocol modules: where location/plan/membership epochs
# and commit fences are produced, compared, and cached.
EPOCH_MODULES = [
    "sparkrdma_tpu_torch/shuffle/location_plane.py",
    "sparkrdma_tpu_torch/shuffle/dist_cache.py",
    "sparkrdma_tpu_torch/shuffle/planner.py",
    "sparkrdma_tpu_torch/shuffle/push_merge.py",
    "sparkrdma_tpu_torch/shuffle/resolver.py",
    "sparkrdma_tpu_torch/shuffle/recovery.py",
    "sparkrdma_tpu_torch/shuffle/fetcher.py",
    "sparkrdma_tpu_torch/shuffle/manager.py",
    "sparkrdma_tpu_torch/shuffle/map_output.py",
    "sparkrdma_tpu_torch/parallel/membership.py",
    "sparkrdma_tpu_torch/parallel/endpoints.py",
]

# The epoch-field registry: an identifier is epoch-typed when it
# matches. Fences join epochs here — the commit CAS is the same
# monotone-guard contract.
EPOCH_NAME = re.compile(r"epoch|fence", re.IGNORECASE)

# Comparing an epoch against a declared sentinel is the documented
# terminal-state check, not an ordering claim.
SENTINEL_NAMES = {"EPOCH_DEAD", "UNPUBLISHED"}

_ACQUIRE = {"charge"}
_RELEASE = {"release"}
_LEDGER_RECV = re.compile(r"(ledger|leases)s?$", re.IGNORECASE)


# ------------------------------------------------------------ leak lint

def _recv_key(func: ast.AST) -> Optional[str]:
    """The receiver identifier of ``<recv>.method(...)`` — the terminal
    attribute naming the ledger (``self.resolver.disk_ledger.charge``
    keys as ``disk_ledger``)."""
    if not isinstance(func, ast.Attribute):
        return None
    value = func.value
    if isinstance(value, ast.Attribute):
        return value.attr
    if isinstance(value, ast.Name):
        return value.id
    return None


def _charge_calls(node: ast.AST) -> List[Tuple[ast.Call, str]]:
    out = []
    for n in ast.walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in _ACQUIRE):
            key = _recv_key(n.func)
            if key is not None and _LEDGER_RECV.search(key):
                out.append((n, key))
    return out


def _contains_release(node: ast.AST, key: str) -> bool:
    for n in ast.walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in _RELEASE
                and _recv_key(n.func) == key):
            return True
    return False


def _guarantees(stmts: Sequence[ast.stmt], cont, key: str) -> bool:
    """Structural all-paths analysis: True iff every execution path
    through ``stmts`` followed by ``cont()`` performs a release of
    ``key``. Loops are conservative (a body may run zero times, so a
    release inside one guarantees nothing); a release in the same
    statement as a ``return``/``raise`` counts for that path."""
    if not stmts:
        return cont()
    s, rest = stmts[0], list(stmts[1:])

    def k() -> bool:
        return _guarantees(rest, cont, key)

    if isinstance(s, (ast.Return, ast.Raise)):
        return _contains_release(s, key)
    if isinstance(s, (ast.Break, ast.Continue)):
        return False  # leaves the block; too control-dependent to track
    if isinstance(s, ast.If):
        return (_guarantees(s.body, k, key)
                and _guarantees(s.orelse, k, key))
    if isinstance(s, (ast.With, ast.AsyncWith)):
        return _guarantees(s.body, k, key)
    if isinstance(s, ast.Try):
        def after_try() -> bool:
            if s.finalbody:
                return _guarantees(s.finalbody, k, key)
            return k()
        if s.finalbody and _guarantees(s.finalbody, lambda: False, key):
            return True  # finally releases: covers every path through
        body_ok = _guarantees(list(s.body) + list(s.orelse), after_try,
                              key)
        handlers_ok = all(_guarantees(h.body, after_try, key)
                          for h in s.handlers)
        return body_ok and handlers_ok
    if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
        return _guarantees(s.orelse, k, key)
    if _contains_release(s, key):
        return True
    return k()


def _stmt_chain(func: ast.FunctionDef, target: ast.stmt
                ) -> Optional[List[Tuple[List[ast.stmt], int]]]:
    """The (block, index) chain from the function body down to the
    statement holding the charge, outermost first."""

    def search(stmts: List[ast.stmt]) -> Optional[List]:
        for i, s in enumerate(stmts):
            if s is target:
                return [(stmts, i)]
            for block in _child_blocks(s):
                found = search(block)
                if found is not None:
                    return [(stmts, i)] + found
        return None

    return search(list(func.body))


def _child_blocks(s: ast.stmt) -> List[List[ast.stmt]]:
    blocks = []
    for attr in ("body", "orelse", "finalbody"):
        b = getattr(s, attr, None)
        if b:
            blocks.append(list(b))
    for h in getattr(s, "handlers", []) or []:
        blocks.append(list(h.body))
    return blocks


def _released_on_all_paths(func: ast.FunctionDef, charge_stmt: ast.stmt,
                           key: str) -> bool:
    chain = _stmt_chain(func, charge_stmt)
    if chain is None:
        return False

    def cont_after(level: int):
        """Thunk: does the code that runs AFTER the block at ``level``
        completes normally guarantee a release?"""
        if level == 0:
            return lambda: False  # fell off the function end
        stmts, idx = chain[level - 1]
        parent = stmts[idx]
        rest = list(stmts[idx + 1:])
        outer = cont_after(level - 1)

        def k() -> bool:
            return _guarantees(rest, outer, key)

        if isinstance(parent, ast.Try) and parent.finalbody:
            # leaving any non-finally part of a try runs the finally
            return lambda: _guarantees(parent.finalbody, k, key)
        return k

    stmts, idx = chain[-1]
    return _guarantees(list(stmts[idx + 1:]), cont_after(len(chain) - 1),
                       key)


def scan_leaks(source: str, relpath: str
               ) -> Tuple[List[Finding], Set[Tuple[int, str]]]:
    """Charge/release pairing over one module. Returns (findings,
    used-pragma set) — the caller audits stale pragmas."""
    pragmas, findings = collect_pragmas(source, relpath)
    used: Set[Tuple[int, str]] = set()
    tree = ast.parse(source)
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for func in funcs:
        # charges inside nested defs are analyzed as their own funcs
        own_stmts = set()
        for stmt in ast.walk(func):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt is not func:
                own_stmts.update(ast.walk(stmt))
        for node, key in _charge_calls(func):
            if node in own_stmts:
                continue
            charge_stmt = _enclosing_stmt(func, node)
            if charge_stmt is None:
                continue
            line = node.lineno
            if _released_on_all_paths(func, charge_stmt, key):
                continue
            if suppressed(pragmas, line, "leak"):
                used.add((line, "leak"))
                continue
            findings.append(Finding(
                PASS, relpath, line,
                f"{func.name}: {key}.charge(...) is not released on "
                f"every path out of the function — release it, or "
                f"document the ownership transfer with "
                f"# analysis: leak-ok(<who releases instead>)"))
    return findings, used


def _enclosing_stmt(func: ast.AST, node: ast.AST) -> Optional[ast.stmt]:
    """The smallest statement in ``func`` containing ``node``."""
    best: Optional[ast.stmt] = None
    for stmt in ast.walk(func):
        if isinstance(stmt, ast.stmt) and stmt is not func:
            for sub in ast.walk(stmt):
                if sub is node:
                    if best is None or _span(stmt) <= _span(best):
                        best = stmt
                    break
    return best


def _span(stmt: ast.stmt) -> int:
    return (getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno) \
        - stmt.lineno


# -------------------------------------------------------- epoch-eq lint

def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_sentinelish(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand,
                                                    ast.Constant):
        return True
    name = _terminal_name(node)
    return name in SENTINEL_NAMES


class _EpochCompareScan(ast.NodeVisitor):
    """Flag raw ==/!= where either side is epoch-typed (registry name
    or one-hop tainted local) and the other side is not a sentinel."""

    def __init__(self):
        self.hits: List[Tuple[int, str]] = []
        self._tainted: List[Set[str]] = [set()]
        self._in_eq = 0

    def _epochish(self, node: ast.AST) -> Optional[str]:
        name = _terminal_name(node)
        if name is None:
            return None
        if EPOCH_NAME.search(name) and name not in SENTINEL_NAMES:
            return name
        if isinstance(node, ast.Name) and name in self._tainted[-1]:
            return name
        return None

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._tainted.append(set())
        self._in_eq += node.name == "__eq__"
        self.generic_visit(node)
        self._in_eq -= node.name == "__eq__"
        self._tainted.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        # one-hop taint: `known = self._epochs.get(sid)` makes `known`
        # epoch-typed for the rest of this function
        value_names = [n for sub in ast.walk(node.value)
                       if (n := _terminal_name(sub)) is not None]
        if any(EPOCH_NAME.search(n) for n in value_names):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._tainted[-1].add(t.id)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        if self._in_eq == 0:
            operands = [node.left] + list(node.comparators)
            for op, lhs, rhs in zip(node.ops, operands, operands[1:]):
                if not isinstance(op, (ast.Eq, ast.NotEq)):
                    continue
                side = self._epochish(lhs) or self._epochish(rhs)
                if side is None:
                    continue
                if _is_sentinelish(lhs) or _is_sentinelish(rhs):
                    continue
                self.hits.append((node.lineno, side))
        self.generic_visit(node)


def scan_epoch_compares(source: str, relpath: str
                        ) -> Tuple[List[Finding], Set[Tuple[int, str]]]:
    pragmas, findings = collect_pragmas(source, relpath)
    used: Set[Tuple[int, str]] = set()
    scan = _EpochCompareScan()
    scan.visit(ast.parse(source))
    for line, name in scan.hits:
        if suppressed(pragmas, line, "epoch-eq"):
            used.add((line, "epoch-eq"))
            continue
        findings.append(Finding(
            PASS, relpath, line,
            f"raw ==/!= on epoch-typed value '{name}' — versioned "
            f"state compares with monotone guards (<, <=, >, >=) or a "
            f"declared sentinel; if exact-match IS the rule here, say "
            f"why: # analysis: epoch-eq-ok(<why>)"))
    return findings, used


# ------------------------------------------------------------ entry point

def run(root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    findings: List[Finding] = []
    for mod in LEDGER_MODULES:
        path = os.path.join(root, mod)
        if not os.path.exists(path):
            findings.append(Finding(
                PASS, mod, 0, "listed in LEDGER_MODULES but missing — "
                "update the list in analysis/resources.py"))
            continue
        with open(path) as f:
            source = f.read()
        relpath = rel(root, path)
        fs, used = scan_leaks(source, relpath)
        findings += fs
        findings += audit_stale_pragmas(source, relpath, {"leak"}, used)
    for mod in EPOCH_MODULES:
        path = os.path.join(root, mod)
        if not os.path.exists(path):
            findings.append(Finding(
                PASS, mod, 0, "listed in EPOCH_MODULES but missing — "
                "update the list in analysis/resources.py"))
            continue
        with open(path) as f:
            source = f.read()
        relpath = rel(root, path)
        fs, used = scan_epoch_compares(source, relpath)
        findings += fs
        findings += audit_stale_pragmas(source, relpath, {"epoch-eq"},
                                        used)
    return findings
