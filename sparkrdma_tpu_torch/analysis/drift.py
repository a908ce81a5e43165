"""Pass 3 — drift lints: docs, trace names, metrics fields.

Three cheap equivalence checks between things that drift silently:

* **config↔docs** — every ``spark.shuffle.tpu.*`` key declared in
  ``config.py`` has a row in the docs/CONFIG.md reference table, and
  every table row names a live key. (The doc opens with "Full key set"
  — the lint makes that sentence true forever.)
* **trace names** — every span/instant/counter literal emitted anywhere
  in the package resolves against ``utils/trace_names.py``, and every
  registry entry is still emitted somewhere. A typo'd name
  (``plan.coalese``) fails the build instead of forking a series.
* **metrics fields** — every metrics field tests read (``.metrics.x``,
  ``metrics["x"]``, and single-assignment aliases of ``.metrics``) is
  declared by the stats classes (utils/stats.py, fetcher.ReadMetrics)
  or the manager's metrics dict — a renamed counter can't leave a test
  asserting on an attribute that no longer updates.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from sparkrdma_tpu_torch.analysis.core import Finding, rel, repo_root

PASS = "drift"


# ------------------------------------------------------------ config/docs

_DOC_ROW_RE = re.compile(r"^\|\s*`([a-z0-9_]+)`\s*\|")


def _config_key_lines(config_path: str) -> Dict[str, int]:
    """key name -> line of its ``_Key(...)`` declaration."""
    with open(config_path) as f:
        tree = ast.parse(f.read())
    out: Dict[str, int] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_Key" and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            out[node.args[0].value] = node.lineno
    return out


def check_config_docs(key_lines: Dict[str, int], config_relpath: str,
                      doc_text: str, doc_relpath: str) -> List[Finding]:
    findings: List[Finding] = []
    doc_rows: Dict[str, int] = {}
    for i, line in enumerate(doc_text.splitlines(), start=1):
        m = _DOC_ROW_RE.match(line)
        if m and m.group(1) not in doc_rows:
            doc_rows[m.group(1)] = i
    for key, line in sorted(key_lines.items(), key=lambda kv: kv[1]):
        if key not in doc_rows:
            findings.append(Finding(
                PASS, config_relpath, line,
                f"config key '{key}' has no row in the docs/CONFIG.md "
                f"reference table"))
    for key, line in sorted(doc_rows.items(), key=lambda kv: kv[1]):
        if key not in key_lines:
            findings.append(Finding(
                PASS, doc_relpath, line,
                f"docs/CONFIG.md documents '{key}' but config.py "
                f"declares no such key"))
    return findings


# ------------------------------------------------------------ trace names

_TRACE_METHODS = {"span": "span", "complete_span": "span",
                  "instant": "instant", "counter": "counter"}


def _tracer_receiver(node: ast.AST) -> bool:
    """Does the call receiver look like a tracer (``tracer.span``,
    ``self._tracer.instant``, ...)? The terminal identifier must
    contain "trace" — anything else with a ``.span()`` method (e.g. a
    regex match) is not this lint's business. A tracer bound to an
    unrelated name would slip the emission scan, but the registry's
    reverse check (every registered name must be emitted somewhere)
    still catches the resulting hole."""
    if isinstance(node, ast.Attribute):
        return "trace" in node.attr.lower()
    if isinstance(node, ast.Name):
        return "trace" in node.id.lower()
    return False


def _emitted_trace_names(root: str
                         ) -> Tuple[Dict[str, Set[str]], List[Finding]]:
    """kind -> names emitted as string literals, package-wide; a
    non-literal first argument is a finding (the registry can't vouch
    for a name built at runtime)."""
    emitted: Dict[str, Set[str]] = {"span": set(), "instant": set(),
                                    "counter": set()}
    findings: List[Finding] = []
    pkg = os.path.join(root, "sparkrdma_tpu_torch")
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "analysis")]
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _TRACE_METHODS
                        and _tracer_receiver(node.func.value)):
                    continue
                kind = _TRACE_METHODS[node.func.attr]
                if (node.args and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    emitted[kind].add(node.args[0].value)
                elif node.args:
                    findings.append(Finding(
                        PASS, rel(root, path), node.lineno,
                        f"non-literal trace name passed to "
                        f".{node.func.attr}() — trace names must be "
                        f"registry literals (utils/trace_names.py)"))
    return emitted, findings


def check_trace_names(root: str) -> List[Finding]:
    from sparkrdma_tpu_torch.utils import trace_names as reg

    emitted, findings = _emitted_trace_names(root)
    registry = {"span": reg.SPANS, "instant": reg.INSTANTS,
                "counter": reg.COUNTERS}
    reg_relpath = "sparkrdma_tpu_torch/utils/trace_names.py"
    for kind in sorted(registry):
        for name in sorted(emitted[kind] - registry[kind]):
            findings.append(Finding(
                PASS, reg_relpath, 0,
                f"{kind} '{name}' is emitted but not registered in "
                f"trace_names.py (typo fork?)"))
        for name in sorted(registry[kind] - emitted[kind]):
            findings.append(Finding(
                PASS, reg_relpath, 0,
                f"{kind} '{name}' is registered but no longer emitted "
                f"anywhere — drop it or restore the emission"))
    return findings


# ---------------------------------------------------------- metrics fields

def _class_fields(tree: ast.Module, classes: Optional[Set[str]] = None
                  ) -> Set[str]:
    """Public field + method names declared by (selected) classes:
    ``self.x = ...`` in methods, class-level annotated fields
    (dataclasses), methods and properties."""
    out: Set[str] = set()
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        if classes is not None and cls.name not in classes:
            continue
        for node in ast.walk(cls):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.add(t.attr)
                    elif isinstance(t, ast.Name):
                        out.add(t.id)
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name):
                    out.add(node.target.id)
                elif (isinstance(node.target, ast.Attribute)
                      and isinstance(node.target.value, ast.Name)
                      and node.target.value.id == "self"):
                    out.add(node.target.attr)
    return {n for n in out if not n.startswith("_")}


def _manager_dict_keys(tree: ast.Module) -> Set[str]:
    """String keys of the writer-handle ``metrics`` property dict
    (manager.py): dict-literal keys plus ``out[...] =`` subscripts
    inside any function named ``metrics``."""
    keys: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "metrics":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict):
                    keys |= {k.value for k in sub.keys
                             if isinstance(k, ast.Constant)
                             and isinstance(k.value, str)}
                elif (isinstance(sub, ast.Subscript)
                      and isinstance(sub.ctx, ast.Store)
                      and isinstance(sub.slice, ast.Constant)
                      and isinstance(sub.slice.value, str)):
                    keys.add(sub.slice.value)
    return keys


def declared_metrics_fields(root: str) -> Set[str]:
    declared: Set[str] = set()
    for relpath, classes in (
            ("sparkrdma_tpu_torch/utils/stats.py", None),
            ("sparkrdma_tpu_torch/shuffle/fetcher.py", {"ReadMetrics"})):
        with open(os.path.join(root, relpath)) as f:
            declared |= _class_fields(ast.parse(f.read()), classes)
    with open(os.path.join(root, "sparkrdma_tpu_torch/shuffle/manager.py")) as f:
        declared |= _manager_dict_keys(ast.parse(f.read()))
    return declared


class _MetricsReads(ast.NodeVisitor):
    """Per-module scan: direct ``<expr>.metrics.<field>`` /
    ``<expr>.metrics["key"]`` reads plus reads through one-hop aliases
    (``m = reader.metrics`` then ``m.retries``)."""

    def __init__(self):
        self.reads: List[Tuple[str, int]] = []  # (field-or-key, line)
        self._aliases: Set[str] = set()

    @staticmethod
    def _is_metrics_expr(node: ast.AST) -> bool:
        return isinstance(node, ast.Attribute) and node.attr == "metrics"

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._is_metrics_expr(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._aliases.add(t.id)
        self.generic_visit(node)

    def _is_metrics_receiver(self, node: ast.AST) -> bool:
        return (self._is_metrics_expr(node)
                or (isinstance(node, ast.Name)
                    and node.id in self._aliases))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.ctx, ast.Load)
                and self._is_metrics_receiver(node.value)):
            self.reads.append((node.attr, node.lineno))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if (self._is_metrics_receiver(node.value)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            self.reads.append((node.slice.value, node.lineno))
        self.generic_visit(node)


def check_metrics_fields(root: str) -> List[Finding]:
    declared = declared_metrics_fields(root)
    findings: List[Finding] = []
    tests = os.path.join(root, "tests")
    for fname in sorted(os.listdir(tests)):
        if not (fname.startswith("test_") and fname.endswith(".py")):
            continue
        path = os.path.join(tests, fname)
        with open(path) as f:
            tree = ast.parse(f.read())
        scan = _MetricsReads()
        scan.visit(tree)
        for field, line in scan.reads:
            if field.startswith("_") or field in declared:
                continue
            findings.append(Finding(
                PASS, rel(root, path), line,
                f"test reads metrics field '{field}' that no stats "
                f"class declares (renamed? typo?)"))
    return findings


def run(root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    config_rel = "sparkrdma_tpu_torch/config.py"
    doc_rel = "docs/CONFIG.md"
    with open(os.path.join(root, doc_rel)) as f:
        doc_text = f.read()
    findings = check_config_docs(
        _config_key_lines(os.path.join(root, config_rel)), config_rel,
        doc_text, doc_rel)
    findings += check_trace_names(root)
    findings += check_metrics_fields(root)
    return findings
