"""Repo-native static-analysis and invariant-checking suite.

Seven PRs of growth turned correctness into a web of *conventions* no
test checked directly: pack/unpack symmetry of 26 wire message classes,
mixed-version truncation tolerance, Python↔C++ mirrored constants, three
interacting version streams, and ~60 lock/condition sites. Per "RPC
Considered Harmful" (PAPERS.md), the one-sided design deletes the
server-side handler that would have validated each request — the
invariants move into client-side protocol discipline, which this package
machine-checks as part of tier-1:

* ``wire``        — wire-protocol checker: registry id uniqueness +
                    density, fuzzed payload round-trip parity, legacy
                    truncation decode tolerance, csrc constant lockstep,
                    generated-vs-committed message-ID doc table.
* ``concurrency`` — AST lints over the threaded modules: writes to
                    shared ``self._*`` state outside any ``with <lock>``
                    block, and ``Condition.wait`` outside a predicate
                    loop / without a deadline.
* ``lockgraph``   — an instrumented Lock/RLock/Condition shim recording
                    the cross-thread acquisition graph at runtime;
                    lock-order cycles fail the run.
* ``drift``       — config↔docs key parity, trace span/instant/counter
                    names vs the generated registry
                    (utils/trace_names.py), metrics fields read by tests
                    vs fields the stats classes declare.
* ``resources``   — resource-contract lints: ledger charge/release
                    pairing (all-paths release or a reasoned
                    ``leak-ok`` ownership-transfer pragma) and the
                    epoch/fence comparison discipline (monotone guards
                    only; exact-match sites carry ``epoch-eq-ok``).
                    Both audit their own pragmas for staleness.
* ``modelcheck``  — distributed-invariant model checker: the protocol
                    race scenarios (publish vs tombstone vs bump, fence
                    loser-commits-late, finalize-beats-first-push,
                    drain vs kill, TTL vs late fetch) run over the real
                    protocol classes under systematically enumerated
                    delivery orders (``scheduler.py``: DFS + partial-
                    order reduction, seeded walks, exact ``--replay``),
                    with safety invariants checked after every step.
* ``native_harness`` — ASan/UBSan exercises for csrc (gated; see
                    ``make -C csrc asan ubsan`` + scripts/run_analysis.sh).

Run everything (the fast tier-1 subset) with::

    python -m sparkrdma_tpu_torch.analysis
    python -m sparkrdma_tpu_torch.analysis --model-check   # + the scheduler sweep

Findings print as ``path:line: [pass] message`` and exit non-zero.
Heuristic passes honor suppression pragmas — see docs/ANALYSIS.md.
"""

from sparkrdma_tpu_torch.analysis.core import Finding, repo_root  # noqa: F401


def run_all(root=None):
    """Run the static passes (wire, concurrency lints, drift, resource
    contracts) over the live tree; returns the combined finding list."""
    from sparkrdma_tpu_torch.analysis import concurrency, drift, resources, wire

    root = root or repo_root()
    findings = []
    findings += wire.run(root)
    findings += concurrency.run(root)
    findings += drift.run(root)
    findings += resources.run(root)
    return findings
