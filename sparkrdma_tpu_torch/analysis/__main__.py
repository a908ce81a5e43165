"""CLI: ``python -m sparkrdma_tpu_torch.analysis [options]``.

Runs the static passes (wire, concurrency, drift, resources) over the
live tree, prints findings as ``path:line: [pass] message``, exits 1 on
any. Options:

``--write-docs``
    Regenerate the message-ID table in docs/CONFIG.md from the registry
    instead (the fix for a doc-table drift finding).
``--model-check``
    Also run the distributed-invariant model checker
    (``analysis/modelcheck.py``): the scenario catalog under enumerated
    schedules, budgets from ``MODELCHECK_SCHEDULES`` /
    ``MODELCHECK_DEPTH`` / ``MODELCHECK_WALKS``. A violating schedule
    dumps a trace artifact (``--trace-dir``, default
    ``.analysis_traces/``) for replay.
``--replay <trace.json>``
    Re-run one dumped trace byte-identically and report whether the
    violation reproduces (exit 1 if it does, 2 if the trace diverges).
``--trace-dir <dir>``
    Where ``--model-check`` dumps violating traces.
"""

from __future__ import annotations

import sys

from sparkrdma_tpu_torch.analysis import run_all
from sparkrdma_tpu_torch.analysis.core import format_report


def main(argv) -> int:
    if "--write-docs" in argv:
        from sparkrdma_tpu_torch.analysis import wire

        print(f"regenerated message-ID table in {wire.write_doc_table()}")
        return 0
    if "--replay" in argv:
        import json

        from sparkrdma_tpu_torch.analysis import modelcheck
        from sparkrdma_tpu_torch.analysis.scheduler import ScheduleExhausted

        # exit-code contract: 1 means ONLY "violation reproduced" —
        # an unreadable/unknown trace must exit 2 like a divergence,
        # or automation keying on 1 reports a phantom protocol bug
        rest = argv[argv.index("--replay") + 1:]
        if not rest:
            print("--replay needs a trace file")
            return 2
        try:
            run = modelcheck.replay_trace(rest[0])
        except (ScheduleExhausted, AssertionError, OSError, ValueError,
                KeyError, json.JSONDecodeError) as e:
            print(f"replay FAILED: {type(e).__name__}: {e}")
            return 2
        print(f"replayed {len(run.trace)} step(s): "
              + " -> ".join(run.trace))
        if run.violation is not None:
            print(f"violation REPRODUCED: {run.violation}")
            return 1
        print("no violation (the live tree has outgrown this trace)")
        return 0

    findings = run_all()
    if "--model-check" in argv:
        from sparkrdma_tpu_torch.analysis import modelcheck

        trace_dir = ".analysis_traces"
        if "--trace-dir" in argv:
            rest = argv[argv.index("--trace-dir") + 1:]
            if not rest:
                print("--trace-dir needs a directory")
                return 2
            trace_dir = rest[0]
        mc_findings, stats = modelcheck.run_catalog(trace_dir=trace_dir)
        findings += mc_findings
        total = sum(s.dfs_schedules for s in stats)
        walks = sum(s.walk_schedules for s in stats)
        detail = ", ".join(
            f"{s.name}:{s.dfs_schedules}{'+' if s.budget_hit else ''}"
            for s in stats)
        print(f"modelcheck: {total} schedule(s) enumerated + {walks} "
              f"random walk(s) [{detail}]")
    print(format_report(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
