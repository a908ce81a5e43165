"""Shared plumbing for the analyzer passes: findings, pragmas, tree walk.

A ``Finding`` is one violated invariant, anchored at ``path:line`` so an
engineer (or the fixture tests) can jump straight to it. Heuristic
passes are silenced per line by pragma comments::

    self._hot = value  # analysis: unguarded-ok(owner thread only)
    cv.wait()          # analysis: wait-ok(stop() notifies under lock)

The pragma REQUIRES a parenthesized reason — a bare silence is itself a
finding, so every suppression documents why the heuristic is wrong
there.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple


@dataclass(frozen=True)
class Finding:
    pass_name: str  # "wire" | "concurrency" | "drift" | "lockgraph" | ...
    path: str       # repo-relative where possible
    line: int       # 1-based; 0 = whole file / not line-anchored
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"


def repo_root() -> str:
    """The checkout root (parent of the ``sparkrdma_tpu_torch`` package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def rel(root: str, path: str) -> str:
    try:
        return os.path.relpath(path, root)
    except ValueError:
        return path


def python_files(root: str, subdirs: Iterable[str]) -> List[str]:
    out = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            out += [os.path.join(dirpath, f) for f in sorted(filenames)
                    if f.endswith(".py")]
    return out


# pragma grammar: "# analysis: <rule>-ok(<reason>)"; reason mandatory.
_PRAGMA_RE = re.compile(r"#\s*analysis:\s*([a-z-]+)-ok\(([^)]*)\)")
_BARE_PRAGMA_RE = re.compile(r"#\s*analysis:\s*([a-z-]+)-ok(?!\()")


def collect_pragmas(source: str, path: str
                    ) -> Tuple[Dict[int, List[str]], List[Finding]]:
    """Map line -> suppressed rule names; bare (reason-less) pragmas are
    findings themselves. A pragma on its own line suppresses the NEXT
    line too, so long statements can keep the code column readable."""
    by_line: Dict[int, List[str]] = {}
    findings: List[Finding] = []
    for i, text in enumerate(source.splitlines(), start=1):
        for m in _PRAGMA_RE.finditer(text):
            rule, reason = m.group(1), m.group(2).strip()
            if not reason:
                findings.append(Finding(
                    "pragma", path, i,
                    f"pragma '{rule}-ok' needs a reason"))
                continue
            by_line.setdefault(i, []).append(rule)
            if text.lstrip().startswith("#"):  # pragma-only line
                by_line.setdefault(i + 1, []).append(rule)
        if _BARE_PRAGMA_RE.search(text) and not _PRAGMA_RE.search(text):
            findings.append(Finding(
                "pragma", path, i,
                "pragma must carry a parenthesized reason: "
                "# analysis: <rule>-ok(<why>)"))
    return by_line, findings


def suppressed(pragmas: Dict[int, List[str]], line: int, rule: str) -> bool:
    return rule in pragmas.get(line, ())


_PRAGMA_SITE_RE = re.compile(r"#\s*analysis:\s*([a-z-]+)-ok\(")


def audit_stale_pragmas(source: str, path: str, rules,
                        used) -> List[Finding]:
    """A pragma for one of ``rules`` that suppressed nothing is itself
    a finding: the refactor that made the lint stop firing should have
    deleted the pragma with it (a stale pragma documents a hazard that
    no longer exists — worse than no comment). ``used`` is the set of
    ``(line, rule)`` suppressions the pass actually consumed; an
    own-line pragma counts as used if either line it covers did."""
    findings: List[Finding] = []
    for i, text in enumerate(source.splitlines(), start=1):
        for m in _PRAGMA_SITE_RE.finditer(text):
            rule = m.group(1)
            if rule not in rules:
                continue
            own_line = text.lstrip().startswith("#")
            lines = (i, i + 1) if own_line else (i,)
            if not any((ln, rule) in used for ln in lines):
                findings.append(Finding(
                    "pragma", path, i,
                    f"stale pragma '{rule}-ok': the lint no longer "
                    f"flags this line — delete the pragma (it claims "
                    f"a hazard that is gone)"))
    return findings


def format_report(findings: List[Finding]) -> str:
    if not findings:
        return "analysis: clean (0 findings)"
    lines = [str(f) for f in findings]
    lines.append(f"analysis: {len(findings)} finding(s)")
    return "\n".join(lines)
