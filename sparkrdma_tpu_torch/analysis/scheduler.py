"""Deterministic virtual-time scheduler for the distributed-invariant
model checker (``analysis/modelcheck.py``).

The protocol races PRs 10-14 kept catching only in review — zombie
publishes, drain-vs-retire, directory pruning before epoch bumps,
ledger double-release — are SCHEDULE bugs: every component is correct
in isolation and the violation lives in one delivery order the chaos
sweeps happened not to sample. This module replaces sampling with
enumeration: a scenario posts its concurrent steps (message deliveries,
timer fires, thread bodies) into a :class:`VirtualScheduler`, and the
explorer runs the scenario once per *schedule* — one total order of
steps consistent with the per-channel FIFO constraint — checking the
machine-checked invariants after every fired step.

Three disciplines keep the exploration honest and cheap:

* **Per-channel FIFO.** Steps carry a ``chan`` key modeling the
  ordering domain real transport gives us: messages on ONE connection
  (driver→executor push channel, one request/response stream) deliver
  in order, so only each channel's HEAD is eligible. Races that the
  transport cannot produce (two pushes on one connection swapping) are
  never explored; races it can (a response stream vs the push stream)
  always are. ``chan=None`` makes a step its own channel (fully
  concurrent).

* **Partial-order reduction.** Steps declare the state components they
  ``touch``; two eligible steps with disjoint, non-empty touch sets
  commute (delivering an epoch bump to observer A and to observer B
  cannot interact), and only the canonical order is explored. The
  declaration is the scenario author's promise, and it must cover the
  step's FOLLOW-UP posts too: a driver-local step that fans out
  deliveries to observers touches those observers — firing it earlier
  changes which deliveries can interleave, so declaring it
  driver-only would silently prune real schedules. Declare
  conservatively (empty set = never reduced) when unsure.

* **Determinism.** No wall clock, no thread scheduler, no unseeded
  randomness: the same scenario and the same choice sequence produce
  byte-identical traces, which is what makes ``--replay`` exact.

Exploration modes: bounded DFS (:func:`explore_dfs`) enumerates every
reduced schedule up to a budget; :func:`random_walks` samples seeded
uniform walks past the DFS horizon; :func:`replay` re-runs one recorded
trace and asserts the reproduction is byte-identical.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class Step:
    """One schedulable action. ``fn(sched)`` runs when the step fires
    and may post follow-up steps (a delivered request posts its
    response). ``anchor`` is an optional ``(path, line)`` for findings;
    fixture scenarios use it to pin violations at their seeded line."""

    label: str
    fn: Callable[["VirtualScheduler"], None]
    chan: Optional[str] = None
    touches: frozenset = frozenset()
    anchor: Optional[Tuple[str, int]] = None


class ScheduleExhausted(Exception):
    """Replay asked for a step the scenario never posted."""


class VirtualScheduler:
    """The pending-step set plus virtual time.

    ``now`` is a step counter, not seconds: timers model as ordinary
    steps (a TTL sweep is "some step that may fire at any point after
    it is posted"), which is exactly the adversarial-timing stance a
    model checker wants — any delivery order the FIFO constraints
    allow, including every timer-vs-message race.
    """

    def __init__(self):
        self._pending: List[Step] = []
        self._seq = 0  # insertion order: the deterministic tiebreak
        self._order: List[Tuple[int, Step]] = []
        self.now = 0
        self.trace: List[str] = []
        self.fired: List[Step] = []

    def post(self, label: str, fn: Callable[["VirtualScheduler"], None],
             chan: Optional[str] = None,
             touches: Sequence[str] = (),
             anchor: Optional[Tuple[str, int]] = None) -> Step:
        step = Step(label, fn, chan, frozenset(touches), anchor)
        self._order.append((self._seq, step))
        self._seq += 1
        self._pending.append(step)
        return step

    # -- eligibility ------------------------------------------------------

    def eligible(self) -> List[Step]:
        """Channel heads, in posting order (the deterministic base
        order every explorer branches over)."""
        heads: List[Step] = []
        seen_chans: set = set()
        for step in self._pending:
            if step.chan is None:
                heads.append(step)
            elif step.chan not in seen_chans:
                seen_chans.add(step.chan)
                heads.append(step)
        return heads

    def explorable(self) -> List[Step]:
        """Eligible steps after partial-order reduction: skip a step
        that commutes with EVERY earlier eligible step — all its
        interleavings with them reach the same states, so the canonical
        (posting) order stands for the class. A step with an empty
        touch set commutes with nothing and is always explored."""
        heads = self.eligible()
        out: List[Step] = []
        for j, step in enumerate(heads):
            if j and step.touches and all(
                    h.touches and h.touches.isdisjoint(step.touches)
                    for h in heads[:j]):
                continue
            out.append(step)
        return out

    def fire(self, step: Step) -> None:
        self._pending.remove(step)
        self.now += 1
        self.trace.append(step.label)
        self.fired.append(step)
        step.fn(self)

    def done(self) -> bool:
        return not self._pending


@dataclass
class Run:
    """One completed schedule: its trace and the violation (if any)."""

    trace: Tuple[str, ...]
    violation: Optional[str] = None
    culprit: Optional[Step] = None


def _run_one(build: Callable[[VirtualScheduler], object],
             check: Callable[[object, VirtualScheduler], Optional[str]],
             choose: Callable[[VirtualScheduler, List[Step]], Step],
             max_depth: int) -> Tuple[Run, List[int]]:
    """Drive one schedule to completion. Returns the run plus the
    branching profile (len(explorable) at each choice point) the DFS
    uses to enumerate siblings."""
    sched = VirtualScheduler()
    state = build(sched)
    widths: List[int] = []
    while not sched.done() and len(sched.trace) < max_depth:
        options = sched.explorable()
        widths.append(len(options))
        step = choose(sched, options)
        sched.fire(step)
        problem = check(state, sched)
        if problem is not None:
            return Run(tuple(sched.trace), problem, step), widths
    return Run(tuple(sched.trace)), widths


def explore_dfs(build: Callable[[VirtualScheduler], object],
                check: Callable[[object, VirtualScheduler],
                                Optional[str]],
                max_schedules: int = 512,
                max_depth: int = 64,
                stop_on_violation: bool = True) -> List[Run]:
    """Enumerate reduced schedules depth-first.

    ``build(sched)`` posts the scenario's initial steps and returns its
    state object; it runs once per schedule, so scenarios rebuild fresh
    state every time (no cross-schedule bleed). ``check(state, sched)``
    runs after EVERY fired step and returns a violation description or
    None.

    The enumeration is iterative over choice prefixes: replay a prefix
    of branch indices, extend with index 0 to completion, then advance
    the deepest prefix position that still has unexplored siblings.
    Budget-bounded by ``max_schedules`` (a hit is reported by the
    caller via len(runs) == max_schedules, never silent).
    """
    runs: List[Run] = []
    prefix: List[int] = []
    while len(runs) < max_schedules:
        depth = 0

        def choose(sched: VirtualScheduler, options: List[Step]) -> Step:
            nonlocal depth
            i = prefix[depth] if depth < len(prefix) else 0
            depth += 1
            return options[min(i, len(options) - 1)]

        run, widths = _run_one(build, check, choose, max_depth)
        runs.append(run)
        if run.violation is not None and stop_on_violation:
            return runs
        # advance to the next unexplored sibling, deepest-first
        full = list(prefix) + [0] * (len(widths) - len(prefix))
        while full and full[-1] + 1 >= widths[len(full) - 1]:
            full.pop()
        if not full:
            return runs
        full[-1] += 1
        prefix = full
    return runs


def random_walks(build: Callable[[VirtualScheduler], object],
                 check: Callable[[object, VirtualScheduler],
                                 Optional[str]],
                 walks: int = 64, seed: int = 0,
                 max_depth: int = 256) -> List[Run]:
    """Seeded uniform sampling over ELIGIBLE (not reduced) steps — the
    long-tail mode for scenarios whose full DFS exceeds the budget.
    Each walk's trace replays exactly via :func:`replay` because the
    only randomness is the seeded choice sequence."""
    runs: List[Run] = []
    for w in range(walks):
        rng = random.Random(seed * 1_000_003 + w)

        def choose(sched: VirtualScheduler, options: List[Step]) -> Step:
            del options  # random mode branches over raw eligibility
            heads = sched.eligible()
            return heads[rng.randrange(len(heads))]

        run, _ = _run_one(build, check, choose, max_depth)
        runs.append(run)
        if run.violation is not None:
            return runs
    return runs


def replay(build: Callable[[VirtualScheduler], object],
           check: Callable[[object, VirtualScheduler], Optional[str]],
           trace: Sequence[str]) -> Run:
    """Re-run one recorded trace label-by-label; raises
    :class:`ScheduleExhausted` if the scenario diverges (the trace
    names a step that is not currently eligible). The returned run's
    trace is asserted byte-identical to the input by the caller —
    that is the ``--replay`` contract."""
    sched = VirtualScheduler()
    state = build(sched)
    for label in trace:
        match = next((s for s in sched.eligible() if s.label == label),
                     None)
        if match is None:
            raise ScheduleExhausted(
                f"replay: step {label!r} not eligible at depth "
                f"{len(sched.trace)} (eligible: "
                f"{[s.label for s in sched.eligible()]})")
        sched.fire(match)
        problem = check(state, sched)
        if problem is not None:
            return Run(tuple(sched.trace), problem, match)
    return Run(tuple(sched.trace))
