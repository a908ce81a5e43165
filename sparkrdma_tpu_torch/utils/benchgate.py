"""Deflaking harness for the wall-clock microbench gates.

Every PR's acceptance microbench asserts a speedup floor (usually
>= 1.5x) measured on whatever host runs tier-1.  The measured ratios
carry wide margins by construction, but they are still wall-clock: a
contended CI host can depress one side of an A/B enough to drop a
genuinely-green change below its gate (PR 13's full run saw
``topo_microbench`` at 1.4x under load while byte-identity passed).

:func:`gated_best_of` turns a single-shot gate into best-of-reps with
ONE ``host_load_avg``-aware retry:

* the green path costs exactly one run — an attempt that clears the
  gate returns immediately;
* a miss re-runs up to ``reps`` total attempts and keeps the BEST
  ratio (noise only ever subtracts from a ratio whose floor has real
  margin, so max-of-attempts is the denoised estimate);
* if every rep misses AND the 1-minute load average says the host is
  contended (``load/cores >= load_per_core``), one extra attempt is
  granted — contention is exactly the case where another sample is
  informative;
* CORRECTNESS is never retried: an attempt whose ``identical`` key is
  falsy returns immediately so the caller's byte-identity assertion
  fires on that exact run.  Only the timing gate is deflaked.

The returned result dict is the best attempt's, annotated with a
``benchgate`` provenance record (attempts, ratios seen, per-attempt
load averages, whether the contention retry fired) so a still-red gate
shows its whole history in the assertion message.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

__all__ = ["gated_best_of", "host_contended"]

# 1-min load per core at which a miss earns the extra attempt; above
# this, tier-1 is sharing the host and wall-clock ratios are suspect
DEFAULT_LOAD_PER_CORE = 0.75


def _load_per_core() -> float:
    try:
        return os.getloadavg()[0] / max(1, os.cpu_count() or 1)
    except OSError:  # pragma: no cover — platforms without getloadavg
        return 0.0


def host_contended(load_per_core: float = DEFAULT_LOAD_PER_CORE) -> bool:
    """True when the 1-minute load average exceeds ``load_per_core``
    per CPU — the regime where a single wall-clock sample is noise."""
    return _load_per_core() >= load_per_core


def gated_best_of(run: Callable[[], Dict], *, key: str = "speedup",
                  gate: float = 1.5, reps: int = 2,
                  load_per_core: float = DEFAULT_LOAD_PER_CORE,
                  identical_key: Optional[str] = "identical") -> Dict:
    """Run ``run()`` until an attempt's ``key`` clears ``gate`` (early
    exit) or the attempt budget is spent; return the best attempt.

    Budget: ``reps`` attempts, plus ONE extra if every rep missed and
    :func:`host_contended` says the host is loaded.  An attempt with a
    falsy ``identical_key`` (when the key is present) short-circuits —
    wrong bytes are a bug, not noise.  The winning dict gains a
    ``benchgate`` record of every attempt for assertion messages.
    """
    attempts: List[Dict] = []
    best: Optional[Dict] = None
    budget = max(1, reps)
    contended_retry = False
    i = 0
    while i < budget:
        i += 1
        res = run()
        ratio = res.get(key)
        attempts.append({key: ratio,
                         "host_load_avg": round(_load_per_core(), 2)})
        if identical_key is not None and identical_key in res \
                and not res[identical_key]:
            best = res  # correctness failure: surface THIS run, now
            break
        if best is None or (ratio is not None
                            and (best.get(key) is None
                                 or ratio > best[key])):
            best = res
        if ratio is not None and ratio >= gate:
            break  # green path: one run, exactly as before
        if i == budget and not contended_retry \
                and host_contended(load_per_core):
            contended_retry = True
            budget += 1
    assert best is not None
    best = dict(best)
    best["benchgate"] = {"key": key, "gate": gate, "attempts": attempts,
                         "contended_retry": contended_retry}
    return best
