"""The benchmark's two-executor TeraSort cell (``terasort-large.two-process``:
``benchmarks/jobs/terasort_2exec.py``) and the port's cross-process
tracing, on the CPU over gloo.

One module fixture starts every process at once: four runs of the cell
at a small size (``rows_per_device`` 1500, 2 executors × 4 shards), each
the harness's process as executor 0 with executor 1 its child — the
program traced, a planted fault where executor 1's rows never reach
executor 0's receive, the control, and executor 1 killed mid-run — and
one pair of processes on a two-process mesh that runs the ``native``
exchange with and without a profiler, then leaves the mesh and builds
it again.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELL = "terasort-large.two-process"
WATCHDOG_S = 30
ROWS = 1500
ROW_BYTES = 100

_RUN = '''
import json, os, signal, sys
import torch
sys.path.insert(0, {root!r})
from benchmarks import harness
from benchmarks.jobs import terasort as one_process
from benchmarks.jobs import terasort_2exec as job
from benchmarks.reference import terasort_2exec as reference
from sparkrdma_tpu_torch.parallel import exchange
from sparkrdma_tpu_torch.utils import trace

scenario, out_path = sys.argv[1], sys.argv[2]
work = dict(harness.load_workload({cell!r}), sample_from_first=3,
            warmup_jobs=1, trace_jobs=2, watchdog_s={watchdog})
cfg = dict(harness.load_config(work["config"]), rows_per_device={rows})
seen = {{}}
release = job.Cell.release

def keep_release(self):
    seen["kept"] = {{k: [t.clone() for t in v]
                    for k, v in self.ex.kept.items()}}
    release(self)

job.Cell.release = keep_release
if scenario == "fault":
    real = exchange.ragged_exchange_global

    def lost(mesh, data, send_counts, *args, **kwargs):
        received, recv, offsets, over = real(mesh, data, send_counts,
                                             *args, **kwargs)
        if mesh.rank == 0:
            # rows from executor 1's sources never land: the receive
            # keeps what it held there
            start = offsets[:, mesh.local_shards].tolist()
            for e, total in enumerate(recv.sum(dim=1).tolist()):
                received[e, start[e]:total] = 0
        return received, recv, offsets, over

    exchange.ragged_exchange_global = lost
if scenario == "dead":
    submit = job.Cell.submit

    def killing_submit(self):
        if self.next_index == -1:   # the last warm-up job, always run
            os.kill(self.child.pid, signal.SIGKILL)
        return submit(self)

    job.Cell.submit = killing_submit
names = []
events_of = harness.events_of

def kept_events(prof):
    events = events_of(prof)
    names.extend(e.name for e in events if e.kind == "host")
    return events

harness.events_of = kept_events
result = harness.run_cell({cell!r}, 7, 0.2, scenario == "program",
                          started=0.0, device="cpu", work=work, cfg=cfg,
                          control=scenario == "control", log=lambda line: None)
out = {{"result": result, "counts": trace.counts(),
        "arena_copy_spans": names.count("exchange.arena_copy"),
        "transport_spans": names.count("exchange.transport")}}
if scenario == "program":
    whole = job._whole(cfg)
    rows = one_process.make_inputs(whole, 7, "cpu")["rows"]
    step, _ = one_process._port_step(whole, "cpu")
    from torch.profiler import ProfilerActivity, profile
    assert not trace.counting()   # the next counted call starts afresh
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, counts, _ = step(rows)
    out["one_process_counts"] = trace.counts()
    out["one_process_spans"] = sorted({{e.key for e in prof.key_averages()}})
    # executor 0's shards against the one-process job; executor 1's part
    # of the reference against it too
    totals = counts.sum(dim=1).tolist()
    out["kept"] = sorted(seen["kept"])
    out["executor_0_equal"] = all(
        torch.equal(kept[0][e, :totals[e]], got[e, :totals[e]])
        and torch.equal(kept[1].long(), counts[:4].long())
        for kept in seen["kept"].values() for e in range(4))
    part, part_counts, part_totals = reference.executor_part(rows, 4, 4)
    start, equal = 0, torch.equal(part_counts, counts[4:].long())
    for e, total in enumerate(part_totals.tolist()):
        equal &= torch.equal(part[start:start + total], got[4 + e, :total])
        start += total
    out["executor_1_reference_equal"] = bool(equal)
with open(out_path, "w") as f:
    json.dump(out, f)
'''

_PAIR = '''
import json, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from torch.profiler import ProfilerActivity, profile
from benchmarks.jobs import terasort as one_process
from sparkrdma_tpu_torch.models import terasort
from sparkrdma_tpu_torch.parallel import exchange, multihost
from sparkrdma_tpu_torch.utils import trace

rank, ports, out_path = int(sys.argv[1]), sys.argv[2].split(","), sys.argv[3]
multihost.init_multihost(f"127.0.0.1:{{ports[0]}}", 2, rank,
                         local_device_count=4, platform="cpu", timeout=60)
mesh = multihost.global_mesh()
cfg = {{"shards": 8, "rows_per_device": {rows}, "payload_words": 24}}
rows = one_process.make_inputs(cfg, 5, "cpu")["rows"][4 * rank:4 * rank + 4]
step = terasort.make_terasort_step(
    mesh, terasort.TeraSortConfig(rows_per_device={rows}), impl="native")
out = {{}}
_, recv, _ = step(rows)
out["unprofiled"] = trace.counts()
with profile(activities=[ProfilerActivity.CPU]) as prof:
    step(rows)
    _, recv, _ = step(rows)
out["profiled"] = trace.counts()
out["received_rows"] = int(recv.sum())
out["spans"] = sorted({{e.key for e in prof.key_averages()}})
step(rows)
out["after"] = trace.counts()
multihost.shutdown_multihost()
# the module builds a mesh again after it left one
multihost.init_multihost(f"127.0.0.1:{{ports[1]}}", 2, rank,
                         local_device_count=2, platform="cpu", timeout=60)
out["again"] = exchange.allgather_host(
    multihost.global_mesh(), np.array([rank, 10 + rank])).tolist()
multihost.shutdown_multihost()
with open(out_path, "w") as f:
    json.dump(out, f)
'''


def _free_ports(count: int) -> list:
    socks = [socket.socket() for _ in range(count)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario's output (``json``), its exit code, its seconds and
    the end of its errors."""
    out_dir = tmp_path_factory.mktemp("two_executor")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"   # ten small processes: one thread each
    run = _RUN.format(root=str(ROOT), cell=CELL, watchdog=WATCHDOG_S,
                      rows=ROWS)
    pair = _PAIR.format(root=str(ROOT), rows=ROWS)
    ports = ",".join(map(str, _free_ports(2)))
    started = time.monotonic()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", run, name, str(out_dir / f"{name}.json")],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env,
        cwd=str(ROOT))
        for name in ("program", "fault", "control", "dead")}
    procs.update({f"pair{r}": subprocess.Popen(
        [sys.executable, "-c", pair, str(r), ports,
         str(out_dir / f"pair{r}.json")],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env,
        cwd=str(ROOT)) for r in range(2)})
    out = {}
    try:
        for name, proc in procs.items():
            _, err = proc.communicate(
                timeout=max(1.0, started + 150 - time.monotonic()))
            path = out_dir / f"{name}.json"
            out[name] = {
                "rc": proc.returncode,
                "seconds": time.monotonic() - started,
                "err": err.decode(errors="replace")[-3000:],
                "out": json.loads(path.read_text()) if path.exists()
                else None}
    finally:
        for proc in procs.values():
            proc.kill()
    return out


def _ran(runs, name) -> dict:
    run = runs[name]
    assert run["rc"] == 0 and run["out"] is not None, run["err"]
    return run["out"]


def test_both_executors_match_the_reference_and_one_process(runs):
    out = _ran(runs, "program")
    result = out["result"]
    assert result["correct"], result["checks"]
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        "sampled_jobs_missing": 0, "rows_wrong": 0, "counts_wrong": 0,
        "jobs_overflowed": 0}
    assert len(out["kept"]) == 2
    assert out["executor_0_equal"] and out["executor_1_reference_equal"]


def test_a_traced_run_counts_the_fences_of_executor_0(runs):
    out = _ran(runs, "program")
    metrics = out["result"]["metrics"]
    assert metrics["launch_bound.exchange.fence_ms"]["value"] > 0
    assert out["counts"]["exchange.fence_ns"] > 0
    # the transport on the CPU is auto's gather: no receive arena
    assert out["transport_spans"] == 2 and out["arena_copy_spans"] == 0
    assert "launch_bound.exchange.arena_copy_ms" not in metrics


def test_rows_that_never_reach_executor_0_fail_the_check(runs):
    result = _ran(runs, "fault")["result"]
    assert not result["correct"]
    assert result["checks"]["rows_wrong"]["value"] > 0
    assert result["checks"]["counts_wrong"]["value"] == 0


def test_the_control_fails_the_check(runs):
    result = _ran(runs, "control")["result"]
    assert not result["correct"]
    assert result["checks"]["rows_wrong"]["value"] > 0


def test_a_dead_executor_1_ends_executor_0(runs):
    dead = runs["dead"]
    assert dead["rc"] != 0 and dead["out"] is None
    assert dead["seconds"] < WATCHDOG_S + 60, dead["err"]


@pytest.mark.parametrize("rank", [0, 1])
def test_the_cross_process_counters_count_only_under_a_profiler(runs, rank):
    out = _ran(runs, f"pair{rank}")
    names = ("exchange.fence_ns", "exchange.arena_copy_bytes")
    assert not set(names) & set(out["unprofiled"])
    profiled = out["profiled"]
    assert profiled["exchange.fence_ns"] > 0
    # two profiled jobs: each received row read once and written once
    assert profiled["exchange.arena_copy_bytes"] == (
        2 * out["received_rows"] * ROW_BYTES * 2)
    assert "exchange.arena_copy" in out["spans"]
    assert out["after"] == profiled          # unprofiled: nothing added


def test_a_one_process_step_counts_no_cross_process_fence(runs):
    out = _ran(runs, "program")
    assert "exchange.bytes" in out["one_process_counts"]
    assert not {"exchange.fence_ns", "exchange.arena_copy_bytes"} & set(
        out["one_process_counts"])
    assert "exchange.arena_copy" not in out["one_process_spans"]


@pytest.mark.parametrize("rank", [0, 1])
def test_the_mesh_builds_again_after_shutdown(runs, rank):
    assert _ran(runs, f"pair{rank}")["again"] == [[0, 10], [1, 11]]
