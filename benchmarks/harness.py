"""What every cell shares: finding a cell's files by name, the closed-loop
window, percentiles, the set-up clock, the trace reader and the result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its job kind (``jobs/<job>.py``, with the
plain reference in ``reference/<job>.py``). Each per-layer metric is
``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or None.
Nothing here imports the program: the job modules reach the port's entries,
and only inside the calls that build them.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sparkrdma_tpu")
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet, at 700 W
TOP = 10
# End-to-end metrics that a cell's ``metric_prefix`` renames, with every
# per-layer metric: a cell whose host sets the pace (its runs spread with
# the host's load) reports them under names of their own, so that their
# wider bounds do not loosen the device-bound cells'. Memory and set-up
# keep one name. A cell's ``leave_out`` lists end-to-end metrics that no
# bound can hold there; their values go to the run's earlier line.
NOISE_SPLIT = ("throughput_gb_per_s", "job_p95_ms")


# --- the cell's files -------------------------------------------------------

def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_workload(name: str) -> dict:
    return _json("workloads", name)


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_job(job: str):
    return importlib.import_module(f"benchmarks.jobs.{job}")


def load_readers(directory: Path = BENCH / "metrics") -> Dict[str, object]:
    """``{metric name: module}`` for every ``<metric>.py`` there."""
    readers = {}
    for path in sorted(directory.glob("*.py")):
        if path.stem.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"benchmarks.metrics.{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers[path.stem] = module
    return readers


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in FORBIDDEN)


# --- the window -------------------------------------------------------------

@dataclasses.dataclass
class Job:
    index: int
    submitted: float      # host clock at the start of the submission
    enqueue_s: float      # host time of the step call, no sync
    handle: object = None
    done: float = 0.0     # host clock once its result is on the host
    record: Optional[dict] = None

    @property
    def latency_s(self) -> float:
        return self.done - self.submitted


def closed_loop(submit: Callable[[int], object],
                finish: Callable[[int, object], dict], *, seconds: float,
                in_flight: int, max_jobs: Optional[int] = None,
                first_index: int = 0,
                clock: Callable[[], float] = time.perf_counter
                ) -> tuple[List[Job], float]:
    """Clients that each submit their next job once their last result is
    back, ``in_flight`` jobs at a time: the host submits job k+1, then
    waits for job k. Submits until ``seconds`` have passed (or
    ``max_jobs``), then drains. Returns the jobs and the window's seconds,
    from the first submission to the last result."""
    jobs: List[Job] = []
    pending: deque = deque()
    start = clock()
    deadline = start + seconds
    while True:
        while (len(pending) < in_flight and clock() < deadline
               and (max_jobs is None or len(jobs) < max_jobs)):
            t = clock()
            handle = submit(first_index + len(jobs))
            job = Job(first_index + len(jobs), t, clock() - t, handle)
            jobs.append(job)
            pending.append(job)
        if not pending:
            break
        job = pending.popleft()
        job.record = finish(job.index, job.handle)
        job.done = clock()
        job.handle = None
    return jobs, (jobs[-1].done - start) if jobs else 0.0


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    pos = (len(ordered) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def end_to_end(jobs: List[Job], window_s: float, input_bytes: int,
               setup_s: float, peak_bytes: int) -> Dict[str, dict]:
    """The cell's end-to-end metrics: every job of the window counts."""
    latencies = [job.latency_s for job in jobs]
    return {
        "throughput_gb_per_s": {
            "value": len(jobs) * input_bytes / window_s / 1e9,
            "unit": "GB/s"},
        "job_p95_ms": {"value": percentile(latencies, 95) * 1e3,
                       "unit": "ms"},
        "peak_device_gib": {"value": peak_bytes / 2**30, "unit": "GiB"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


# --- the trace --------------------------------------------------------------

@dataclasses.dataclass
class Event:
    """One profiler event: ``kind`` is ``host`` (an op or a span on the
    host), ``device`` (a kernel, copy or fill) or ``range`` (a span's
    extent on the device, from its first launch's start to its last's
    end)."""
    name: str
    start_us: float
    end_us: float
    kind: str
    annotation: bool = False


def events_of(prof) -> List[Event]:
    """The profiler's events as ``Event``s."""
    from torch.autograd import DeviceType

    out = []
    for evt in prof.events():
        if evt.is_async:
            continue
        on_device = evt.device_type != DeviceType.CPU
        annotation = bool(evt.is_user_annotation)
        kind = ("range" if annotation else "device") if on_device else "host"
        out.append(Event(evt.name, evt.time_range.start, evt.time_range.end,
                         kind, annotation))
    return out


def union(intervals: List[tuple]) -> List[tuple]:
    """Merged, sorted intervals."""
    merged: List[list] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def _clip(intervals, lo: float, hi: float) -> List[tuple]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def _host_at(events: List[Event], t: float) -> str:
    """What the host was doing at ``t``: its open spans, then the
    innermost op."""
    around = sorted((e for e in events
                     if e.kind == "host" and e.start_us <= t < e.end_us),
                    key=lambda e: e.start_us)
    spans = [e.name for e in around if e.annotation]
    ops = [e.name for e in around if not e.annotation]
    return " > ".join(spans + ops[-1:])[:160] or "host idle"


def _busy_within(busy: List[tuple], lo: float, hi: float) -> float:
    """Length of the merged ``busy`` intervals inside ``[lo, hi]``."""
    i = bisect.bisect_left(busy, (lo,))
    if i:
        i -= 1
    total = 0.0
    while i < len(busy) and busy[i][0] < hi:
        total += max(0.0, min(busy[i][1], hi) - max(busy[i][0], lo))
        i += 1
    return total


@dataclasses.dataclass
class TraceSummary:
    jobs: int
    window_s: float
    busy_s: float
    span_us: Dict[str, float]
    device_ops: List[list]
    idle_gaps: List[list]


def summarize(events: List[Event], window: tuple, jobs: int) -> TraceSummary:
    """Busy time as the union of device intervals inside ``window`` (µs);
    a span's device time as the busy time inside each of its device
    ranges; the device ops that took most time and the longest idle
    gaps, named by what the host was doing."""
    lo, hi = window
    busy = union(_clip([(e.start_us, e.end_us) for e in events
                        if e.kind == "device"], lo, hi))
    busy_us = sum(e - s for s, e in busy)
    spans: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for e in events:
        if e.kind == "device":
            ops[e.name] = ops.get(e.name, 0.0) + e.end_us - e.start_us
        elif e.kind == "range":
            spans[e.name] = spans.get(e.name, 0.0) + _busy_within(
                busy, e.start_us, e.end_us)
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        jobs=jobs, window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
        span_us=spans,
        device_ops=[[name[:160], us / 1e6] for name, us in top_ops],
        idle_gaps=[[_host_at(events, start), us / 1e6]
                   for us, start in gaps])


class Context:
    """What a per-layer metric's reader may read."""

    def __init__(self, trace: TraceSummary, enqueue_s: List[float],
                 exchange_bytes: int):
        self.trace = trace
        self.enqueue_ms = [s * 1e3 for s in enqueue_s]
        self.exchange_bytes = exchange_bytes
        self.hbm_bytes_per_s = HBM_BYTES_PER_S

    @property
    def device_traced(self) -> bool:
        return self.trace.busy_s > 0

    def span_ms(self, *names: str) -> Optional[float]:
        """Device ms a job of the spans named, or None where none ran."""
        found = [self.trace.span_us[n] for n in names
                 if n in self.trace.span_us]
        if not found or not self.device_traced:
            return None
        return sum(found) / 1e3 / self.trace.jobs


def solo_jobs(submit, finish, count: int, first_index: int,
              device: torch.device) -> List[Job]:
    """Jobs submitted one at a time onto an idle device, so that the host
    clock around the step call reads the host's work and no wait for room
    in a launch queue that the job before filled (a job that launches more
    than the queue holds still waits for the card to drain its own)."""
    jobs = []
    for index in range(first_index, first_index + count):
        _sync(device)
        jobs.extend(closed_loop(submit, finish, seconds=float("inf"),
                                in_flight=1, max_jobs=1,
                                first_index=index)[0])
    return jobs


def trace_window(cell, work: dict, device: torch.device,
                 first_index: int) -> tuple[TraceSummary, List[Job]]:
    """A few steady jobs of the same closed loop under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    submit, finish = _loop_calls(cell, device, traced=True)
    with profile(activities=activities) as prof:
        with record_function("bench.window"):
            jobs, _ = closed_loop(submit, finish, seconds=float("inf"),
                                  in_flight=work["in_flight"],
                                  max_jobs=work["trace_jobs"],
                                  first_index=first_index)
    events = events_of(prof)
    window = next((e.start_us, e.end_us) for e in events
                  if e.name == "bench.window" and e.kind == "host")
    return summarize(events, window, len(jobs)), jobs


# --- a run ------------------------------------------------------------------

def _loop_calls(cell, device: torch.device, traced: bool = False):
    """``submit`` and ``finish`` around the cell. A job's small results
    are copied to the host behind its work, without waiting; it is done
    when the device has passed the event recorded behind those copies,
    so reading job k never waits for job k+1."""
    from torch.profiler import record_function

    def submit(index: int):
        if traced:
            with record_function("bench.submit"):
                result = cell.submit()
        else:
            result = cell.submit()
        host = cell.fetch(result)
        marker = None
        if device.type == "cuda":
            marker = torch.cuda.Event()
            marker.record()
        return result, host, marker

    def finish(index: int, handle) -> dict:
        result, host, marker = handle
        if marker is not None:
            marker.synchronize()
        return cell.finish(index, result, host)

    return submit, finish


def _counters(before: Optional[dict] = None) -> dict:
    """The ragged kernel's launches and launch shapes, as the port counts
    them, less ``before``."""
    ragged = sys.modules.get("sparkrdma_tpu_torch.ops.ragged_exchange")
    if ragged is None:
        return {}
    now = {"launches": ragged.LAUNCHES,
           "shapes": {str(list(k)): v for k, v in ragged.SHAPES.items()}}
    if before:
        now["launches"] -= before.get("launches", 0)
        now["shapes"] = {k: v - before["shapes"].get(k, 0)
                         for k, v in now["shapes"].items()
                         if v > before["shapes"].get(k, 0)}
    return now


def _host_readings(jobs: List[Job]) -> dict:
    """How steady the host was: jobs finished in each 5 s of the window,
    and the step call's median and 95th percentile in the loop."""
    if not jobs:
        return {}
    start = jobs[0].submitted
    slices: Dict[int, int] = {}
    for job in jobs:
        k = int((job.done - start) // 5)
        slices[k] = slices.get(k, 0) + 1
    enqueue = [j.enqueue_s * 1e3 for j in jobs]
    return {"jobs_per_5s": [slices.get(k, 0) for k in range(max(slices) + 1)],
            "enqueue_ms_p50_p95": [percentile(enqueue, 50),
                                   percentile(enqueue, 95)]}


def _power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"unread: {err}"
    return done.stdout.strip() or done.stderr.strip()


def _per_layer(cell, work: dict, device: torch.device, submit, finish,
               first_index: int, exchange_bytes: int, prefix: str, log):
    """The traced run's part after the window: a few jobs one at a time
    for the host's clock, a few under the profiler, and every per-layer
    metric that finds something to read."""
    solo = solo_jobs(submit, finish, work["trace_jobs"], first_index, device)
    before = _counters()
    summary, traced = trace_window(cell, work, device,
                                   first_index + len(solo))
    log(json.dumps({"counters": _counters(before), "traced_jobs":
                    len(traced), "span_us": summary.span_us,
                    "card": _power_limit()}))
    ctx = Context(summary, [j.enqueue_s for j in solo], exchange_bytes)
    metrics = {}
    for metric, reader in load_readers().items():
        value = reader.read(ctx)
        if value is not None:
            metrics[prefix + metric] = {"value": value, "unit": reader.UNIT}
    return summary, solo + traced, metrics


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             started: float, device: Optional[torch.device] = None,
             work: Optional[dict] = None, cfg: Optional[dict] = None,
             control: bool = False, log=print) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``device`` defaults to the card; ``work`` and ``cfg`` default to the
    cell's files (tests pass small ones); ``control`` puts the job's plain
    control in the program's place."""
    device = torch.device(device or "cuda")
    work = work or load_workload(name)
    cfg = cfg or load_config(work["config"])
    job = load_job(work["job"])
    imported = time.perf_counter()
    cell = job.Cell(cfg, work, seed, device, control=control)
    _sync(device)
    made = time.perf_counter()
    submit, finish = _loop_calls(cell, device)
    warm, _ = closed_loop(submit, finish, seconds=float("inf"),
                          in_flight=work["in_flight"],
                          max_jobs=work["warmup_jobs"],
                          first_index=-work["warmup_jobs"])
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warmed = time.perf_counter()
    setup_s = warmed - started
    jobs, window_s = closed_loop(submit, finish, seconds=seconds,
                                 in_flight=work["in_flight"])
    _sync(device)
    peak = 0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) - cell.kept_bytes()
    metrics = end_to_end(jobs, window_s, job.input_bytes(cfg), setup_s, peak)
    prefix = work.get("metric_prefix", "")
    left_out = {k: metrics.pop(k)["value"] for k in work.get("leave_out", ())}
    metrics = {(prefix + k if k in NOISE_SPLIT else k): v
               for k, v in metrics.items()}
    traced_jobs: List[Job] = []
    summary = None
    if trace:
        summary, traced_jobs, metrics = _per_layer(
            cell, work, device, submit, finish, len(jobs),
            job.exchange_bytes(cfg), prefix, log)
    records = [j.record for j in jobs + traced_jobs]
    cell.release()
    del submit, finish
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = time.perf_counter()
    compared = cell.check(records)
    checked = time.perf_counter() - checked
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in
              compared.items() if lim is not None}
    readings = {k: v for k, (v, lim) in compared.items() if lim is None}
    log(json.dumps({"workload": name, "seed": seed, "transport":
                    cell.transport, "jobs": len(jobs), "window_s": window_s,
                    "warmup_jobs": len(warm), "setup": {
                        "to_harness_s": imported - started,
                        "inputs_s": made - imported,
                        "warmup_s": warmed - made},
                    "check_s": checked, "host": _host_readings(jobs),
                    "left_out": left_out, "readings": readings}))
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(jobs) + len(traced_jobs),
        "failed": sum(r["overflowed"] for r in records),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
            "count": work.get("chips", 1),
            "memory_peak_bytes": peak,
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result
