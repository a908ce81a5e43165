"""TeraSort jobs on HiBench's executor layout: ``executors`` (2) processes
of ``shards_per_executor`` shards each, driven in lockstep over the
port's cross-process mesh.

Executor 0 is the harness's process. Its ``Cell`` starts executor 1 as a
child (``python -m benchmarks.jobs.terasort_2exec <spec>``), and both
join one ``GlobalMesh`` (``multihost.init_multihost``) on 127.0.0.1, on
the same card. Each draws the whole input exactly as ``jobs/terasort.py``
does from the seed, keeps its own shards and frees the rest. Each
submission broadcasts the job's index over the mesh's control group and
runs the port's ``make_terasort_step`` over the mesh (``auto``: on the
card the ragged kernel's range launch into each process's arena through
CUDA IPC); executor 1 runs the same step on every index it hears and
stops at ``STOP``.

``release()`` stops executor 1 and tears the mesh down. The check covers
both executors: each compares its own shards with the reference, and
executor 1 sends its numbers to executor 0 over the pair's TCP store,
with its peak and both arenas' bytes as readings. A watchdog in each
process ends the run (exit 1) when the other process is gone or no job
completed for the workload's ``watchdog_s`` (120 s unless given), and
the mesh's collectives wait no longer than that on a dead peer.
"""

from __future__ import annotations

import atexit
import datetime
import inspect
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path

import torch
import torch.distributed as dist

from benchmarks.jobs import terasort
from benchmarks.reference import terasort_2exec as reference

ROOT = Path(__file__).resolve().parents[2]
WATCHDOG_S = 120.0
STOP = -2**62  # warm-up jobs have negative indices
CHECK_KEY = "check.1"
LIMITED = ("sampled_jobs_missing", "rows_wrong", "counts_wrong",
           "jobs_overflowed")


def _shards(cfg: dict) -> int:
    return cfg["executors"] * cfg["shards_per_executor"]


def _whole(cfg: dict) -> dict:
    """The configuration as the one-process job reads it."""
    return dict(cfg, shards=_shards(cfg))


def input_bytes(cfg: dict) -> int:
    """Every executor's rows handed to the port, as int32 words."""
    return terasort.input_bytes(_whole(cfg))


def exchange_bytes(cfg: dict) -> int:
    """Executor 0's own exchange, the process the profiler sees: each of
    its rows read once and written once."""
    return 2 * input_bytes(cfg) // cfg["executors"]


def _free_ports(count: int) -> list:
    socks = [socket.socket() for _ in range(count)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _Watchdog:
    """Ends the process with exit 1, after ``on_fire``, once ``peer_alive``
    turns false or ``beat`` was not called for ``seconds``."""

    def __init__(self, seconds: float, peer_alive, on_fire=lambda: None):
        self.seconds, self.peer_alive, self.on_fire = (
            seconds, peer_alive, on_fire)
        self.armed = True
        self.beat()
        threading.Thread(target=self._watch, daemon=True,
                         name="terasort_2exec-watchdog").start()

    def beat(self) -> None:
        self.last = time.monotonic()

    def _watch(self) -> None:
        while True:
            time.sleep(min(0.2, self.seconds / 20))
            if not self.armed:
                return
            if not self.peer_alive():
                why = "the other executor exited"
            elif time.monotonic() - self.last > self.seconds:
                why = f"no job completed in {self.seconds:g} s"
            else:
                continue
            print(f"terasort_2exec watchdog (pid {os.getpid()}): {why}",
                  file=sys.stderr, flush=True)
            self.on_fire()
            os._exit(1)


def _control_step(cfg: dict, first: int, local: int):
    """The reference in the program's place, sorting on 16 key bits: from
    the whole input, this executor's receivers."""
    def step(rows):
        _, n, w = rows.shape
        out = torch.zeros((local, n * cfg["out_factor"], w),
                          dtype=rows.dtype, device=rows.device)
        flat, counts, totals = reference.executor_part(rows, first, local,
                                                       key_bits=16)
        start = 0
        for e, total in enumerate(totals.tolist()):
            out[e, :total] = flat[start:start + total]
            start += total
        return (out, counts.to(torch.int32),
                torch.zeros(local, dtype=torch.bool, device=rows.device))
    return step


class _Executor:
    """One executor's part: its mesh, shards, step and kept results."""

    def __init__(self, cfg: dict, work: dict, seed: int, device,
                 control: bool, rank: int, address: str, timeout: float):
        from sparkrdma_tpu_torch.parallel import multihost

        self.cfg, self.seed, self.rank = cfg, seed, rank
        self.local = cfg["shards_per_executor"]
        self.first = rank * self.local
        init = multihost.init_multihost
        bound = ({"timeout": timeout}
                 if "timeout" in inspect.signature(init).parameters else {})
        init(address, cfg["executors"], rank, local_device_count=self.local,
             platform=torch.device(device).type, **bound)
        self.mesh = multihost.global_mesh()
        self.device = self.mesh.device
        rows = terasort.make_inputs(_whole(cfg), seed, self.device)["rows"]
        if control:
            self.rows = rows
            self.step = _control_step(cfg, self.first, self.local)
            self.transport = "control"
        else:
            self.rows = rows[self.first:self.first + self.local].clone()
            del rows
            self.step, self.transport = self._port_step()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.sampled = set(random.Random(seed).sample(
            range(work["sample_from_first"]), work["sampled_jobs"]))
        self.kept = {}

    def _port_step(self):
        from sparkrdma_tpu_torch.models import terasort as port
        from sparkrdma_tpu_torch.parallel.exchange import resolve_transport

        step = port.make_terasort_step(
            self.mesh, port.TeraSortConfig(
                rows_per_device=self.cfg["rows_per_device"],
                payload_words=self.cfg["payload_words"],
                out_factor=self.cfg["out_factor"]), impl="auto")
        return step, resolve_transport(self.mesh, "auto")

    def tell(self, index: int = STOP) -> int:
        """Executor 0's ``index``, sent by executor 0 and received by the
        others (whose ``index`` is ignored)."""
        value = torch.tensor([index], dtype=torch.int64)
        dist.broadcast(value, src=0, group=self.mesh.group)
        return int(value[0])

    def keep(self, index: int, result, counts, overflowed) -> dict:
        if index in self.sampled:
            self.kept[index] = result[:2]
        return {"counts": counts.numpy().copy(),
                "overflowed": bool(overflowed.any())}

    def kept_bytes(self) -> int:
        return sum(out.nbytes + counts.nbytes
                   for out, counts in self.kept.values())

    def arena_bytes(self) -> int:
        arena = self.mesh.arena
        return arena.nbytes if arena is not None else 0

    def release(self) -> None:
        """Drop the step and leave the mesh, its arena with it."""
        from sparkrdma_tpu_torch.parallel import multihost

        self.step = None
        self.rows = None
        self.mesh = None
        multihost.shutdown_multihost()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, records: list) -> dict:
        """This executor's numbers: its shards of the sampled jobs against
        the reference's stable sort, its rows of every job's count
        matrix."""
        rows = terasort.make_inputs(_whole(self.cfg), self.seed,
                                    self.device)["rows"]
        want, want_counts, totals = reference.executor_part(
            rows, self.first, self.local)
        del rows
        want_counts = want_counts.cpu()
        rows_wrong = 0
        for out, _ in self.kept.values():
            start = 0
            for e, total in enumerate(totals.tolist()):
                got = out[e, :total]
                rows_wrong += total - got.shape[0]
                rows_wrong += int((got != want[start:start + got.shape[0]])
                                  .any(dim=1).sum())
                start += total
        return {
            "sampled_jobs_missing": len(self.sampled) - len(self.kept),
            "rows_wrong": rows_wrong,
            "counts_wrong": sum(int((torch.from_numpy(r["counts"]).to(
                torch.int64) != want_counts).sum()) for r in records),
            "jobs_overflowed": sum(r["overflowed"] for r in records),
        }


def _fetch(result) -> tuple:
    """Copies of the job's counts and overflow flags on their way to the
    host, not waited for."""
    _, counts, overflowed = result
    return (counts.to("cpu", non_blocking=True),
            overflowed.to("cpu", non_blocking=True))


class Cell:
    """Executor 0: starts executor 1, drives both, checks both."""

    def __init__(self, cfg: dict, work: dict, seed: int, device,
                 control: bool = False):
        mesh_port, store_port = _free_ports(2)
        self.watchdog_s = float(work.get("watchdog_s", WATCHDOG_S))
        self.store = dist.TCPStore(
            "127.0.0.1", store_port, None, True,
            datetime.timedelta(seconds=self.watchdog_s),
            wait_for_workers=False)
        spec = {"cfg": cfg, "work": work, "seed": seed,
                "device": torch.device(device).type, "control": control,
                "mesh_port": mesh_port, "store_port": store_port,
                "parent": os.getpid(), "watchdog_s": self.watchdog_s}
        self.child = subprocess.Popen(
            [sys.executable, "-m", "benchmarks.jobs.terasort_2exec",
             json.dumps(spec)], cwd=str(ROOT))
        atexit.register(self._end_child)
        self.watchdog = _Watchdog(self.watchdog_s,
                                  lambda: self.child.poll() is None,
                                  self._end_child)
        self.ex = _Executor(cfg, work, seed, device, control, 0,
                            f"127.0.0.1:{mesh_port}", self.watchdog_s)
        self.transport = self.ex.transport
        self.next_index = -work["warmup_jobs"]
        self.arena_bytes = 0
        self.watchdog.beat()

    def _end_child(self) -> None:
        if self.child.poll() is None:
            self.child.kill()
            self.child.wait()

    def submit(self):
        index = self.ex.tell(self.next_index)
        self.next_index += 1
        return self.ex.step(self.ex.rows)

    fetch = staticmethod(_fetch)

    def finish(self, index: int, result, host) -> dict:
        """The job's host result, once its work and copies are done,
        copied out of the pinned buffers so that they are reused."""
        self.watchdog.beat()
        return self.ex.keep(index, result, *host)

    def kept_bytes(self) -> int:
        return self.ex.kept_bytes()

    def release(self) -> None:
        """Stop executor 1 and leave the mesh before the reference runs."""
        self.ex.tell(STOP)
        self.arena_bytes = self.ex.arena_bytes()
        self.ex.release()
        self.watchdog.armed = False

    def _hear(self) -> dict:
        """Executor 1's numbers, once it sent them; raises if it exits
        first or takes longer than the watchdog's time."""
        deadline = time.monotonic() + self.watchdog_s
        while not self.store.check([CHECK_KEY]):
            code = self.child.poll()
            if code is not None and not self.store.check([CHECK_KEY]):
                raise RuntimeError(f"executor 1 exited with {code} before "
                                   "sending its check")
            if time.monotonic() > deadline:
                self._end_child()
                raise RuntimeError(f"executor 1 sent no check in "
                                   f"{self.watchdog_s:g} s")
            time.sleep(0.05)
        theirs = json.loads(self.store.get(CHECK_KEY))
        code = self.child.wait(timeout=self.watchdog_s)
        if code != 0:
            raise RuntimeError(f"executor 1 exited with {code}")
        return theirs

    def check(self, records: list) -> dict:
        """Numbers compared, each ``(value, limit)``, summed over both
        executors; readings (limit None): executor 1's peak and each
        executor's arena."""
        mine = self.ex.compare(records)
        theirs = self._hear()
        out = {k: (mine[k] + theirs[k], 0) for k in LIMITED}
        out["executor_1_peak_gib"] = (theirs["peak_bytes"] / 2**30, None)
        out["arena_gib_executor_0"] = (self.arena_bytes / 2**30, None)
        out["arena_gib_executor_1"] = (theirs["arena_bytes"] / 2**30, None)
        return out


def _follow(spec: dict) -> dict:
    """Executor 1: run the step on every index executor 0 sends, in the
    same closed loop, until it sends ``STOP``; then its check's numbers."""
    work = spec["work"]
    watchdog = _Watchdog(spec["watchdog_s"],
                         lambda: os.getppid() == spec["parent"])
    ex = _Executor(spec["cfg"], work, spec["seed"], spec["device"],
                   spec["control"], 1, f"127.0.0.1:{spec['mesh_port']}",
                   spec["watchdog_s"])
    cuda = ex.device.type == "cuda"
    pending: deque = deque()
    records = []
    windowed = False

    def finish(job) -> None:
        index, result, host, marker = job
        if marker is not None:
            marker.synchronize()
        record = ex.keep(index, result, *host)
        if index >= 0:
            records.append(record)
        watchdog.beat()

    while True:
        index = ex.tell()
        if index == STOP:
            break
        watchdog.beat()
        if index == 0 and cuda:
            # the window opens: its peak, as executor 0's, after warm-up
            while pending:
                finish(pending.popleft())
            torch.cuda.synchronize(ex.device)
            torch.cuda.reset_peak_memory_stats(ex.device)
            windowed = True
        result = ex.step(ex.rows)
        marker = None
        if cuda:
            marker = torch.cuda.Event()
            marker.record()
        pending.append((index, result, _fetch(result), marker))
        while len(pending) >= work["in_flight"]:
            finish(pending.popleft())
    while pending:
        finish(pending.popleft())
    peak = (torch.cuda.max_memory_allocated(ex.device) - ex.kept_bytes()
            if windowed else 0)
    arena = ex.arena_bytes()
    ex.release()
    numbers = ex.compare(records)
    watchdog.armed = False
    return dict(numbers, peak_bytes=peak, arena_bytes=arena)


def main(argv) -> int:
    spec = json.loads(argv[0])
    torch.set_num_threads(2)  # the host only launches: few threads
    store = dist.TCPStore("127.0.0.1", spec["store_port"], None, False,
                          datetime.timedelta(seconds=spec["watchdog_s"]),
                          wait_for_workers=False)
    store.set(CHECK_KEY, json.dumps(_follow(spec)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
