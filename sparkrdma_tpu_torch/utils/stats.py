"""Shuffle observability: fetch-latency histograms + host-memory stats.

Re-design of ``scala/RdmaShuffleReaderStats.scala``:

* per-remote-executor fetch-latency histograms with fixed-width buckets
  (``fetch_time_bucket_size_ms`` × ``fetch_time_num_buckets``) plus one
  global histogram, printed at manager stop
  (RdmaShuffleReaderStats.scala:32-81, enabled by
  ``collect_shuffle_reader_stats``, scala/RdmaShuffleConf.scala:121-123);
* the reference's ``OdpStats`` diffs NIC page-fault counters from sysfs
  before/after (RdmaShuffleReaderStats.scala:83-99). The TPU analogue of
  "did my memory registration thrash" is host-process paging while staging:
  ``MemStats`` diffs major/minor page faults + peak RSS from procfs.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from sparkrdma_tpu_torch.config import TpuShuffleConf


class FetchHistogram:
    """Fixed-width latency buckets; the last bucket is open-ended."""

    def __init__(self, bucket_ms: int, num_buckets: int):
        self.bucket_ms = bucket_ms
        self.buckets = [0] * (num_buckets + 1)
        self.count = 0
        self.total_ms = 0.0

    def add(self, latency_s: float) -> None:
        ms = latency_s * 1e3
        idx = min(int(ms // self.bucket_ms), len(self.buckets) - 1)
        self.buckets[idx] += 1
        self.count += 1
        self.total_ms += ms

    def summary(self) -> dict:
        edges = ([f"<{(i + 1) * self.bucket_ms}ms" for i in
                  range(len(self.buckets) - 1)]
                 + [f">={(len(self.buckets) - 1) * self.bucket_ms}ms"])
        return {
            "count": self.count,
            "mean_ms": round(self.total_ms / self.count, 3) if self.count else 0.0,
            "buckets": dict(zip(edges, self.buckets)),
        }


class _Pow2Histogram:
    """Shared power-of-two bucketing: bucket i counts samples in
    [2^i, 2^(i+1)); zero lands in bucket 0; past the top bucket clamps."""

    NUM_BUCKETS = 16

    def __init__(self):
        self.buckets = [0] * self.NUM_BUCKETS
        self.count = 0
        self._total = 0

    def add(self, value: int) -> None:
        value = max(0, int(value))
        idx = min(max(value, 1).bit_length() - 1, self.NUM_BUCKETS - 1)
        self.buckets[idx] += 1
        self.count += 1
        self._total += value

    def _bucket_summary(self) -> dict:
        edges = [f"[{1 << i},{(1 << (i + 1)) - 1}]"
                 for i in range(self.NUM_BUCKETS)]
        return {e: b for e, b in zip(edges, self.buckets) if b}


class DepthHistogram(_Pow2Histogram):
    """Power-of-two outstanding-depth buckets. Depth 0 (idle issue)
    lands in bucket 0 with depth 1 — what matters is how full the
    read-ahead window ran, and the window is never larger than a few
    thousand."""

    NUM_BUCKETS = 16  # covers depth up to 2^15; deeper clamps

    def __init__(self):
        super().__init__()
        self.max_depth = 0

    def add(self, depth: int) -> None:
        super().add(depth)
        self.max_depth = max(self.max_depth, max(0, int(depth)))

    def summary(self) -> dict:
        return {
            "count": self.count,
            "max": self.max_depth,
            "mean": round(self._total / self.count, 2) if self.count else 0.0,
            "buckets": self._bucket_summary(),
        }


class BytesHistogram(_Pow2Histogram):
    """Power-of-two request-size buckets (bytes). Companion to
    ``ReadMetrics.requests_per_reduce`` for the coalesced dataplane: the
    RPC-count reduction must show up as FEWER, LARGER requests — mean
    bytes/request rising — not just a smaller counter."""

    NUM_BUCKETS = 32  # up to 2 GiB/request; larger clamps

    @property
    def total_bytes(self) -> int:
        return self._total

    def summary(self) -> dict:
        return {
            "count": self.count,
            "total_bytes": self._total,
            "mean_bytes": (round(self._total / self.count, 1)
                           if self.count else 0.0),
            "buckets": self._bucket_summary(),
        }


class FetchPipelineStats:
    """Per-peer read-ahead telemetry for the pipelined fetch dataplane:
    how deep the outstanding window actually ran at each issue
    (``DepthHistogram``), and how long each grouped fetch sat queued
    between becoming ready and hitting the wire (window slot +
    in-flight-budget wait; millisecond-bucket ``FetchHistogram``).

    The reference has no equivalent — its queue depth is fixed by the
    sendQueueDepth/cores split (RdmaShuffleFetcherIterator.scala:82-83)
    and unobservable; here both are measured so a mis-tuned
    ``read_ahead_depth`` shows up in the snapshot, not in a guess."""

    def __init__(self, queue_wait_bucket_ms: int = 1,
                 queue_wait_num_buckets: int = 20):
        self._bucket_ms = queue_wait_bucket_ms
        self._num_buckets = queue_wait_num_buckets
        self._depth: Dict[int, DepthHistogram] = {}
        self._queue_wait: Dict[int, FetchHistogram] = {}
        self._lock = threading.Lock()

    def record_issue(self, exec_index: int, outstanding_depth: int,
                     queue_wait_s: float) -> None:
        with self._lock:
            depth = self._depth.get(exec_index)
            if depth is None:
                depth = self._depth[exec_index] = DepthHistogram()
                self._queue_wait[exec_index] = FetchHistogram(
                    self._bucket_ms, self._num_buckets)
            depth.add(outstanding_depth)
            self._queue_wait[exec_index].add(queue_wait_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "per_peer": {
                    str(i): {"depth": self._depth[i].summary(),
                             "queue_wait": self._queue_wait[i].summary()}
                    for i in sorted(self._depth)
                },
            }


class FailureCounters:
    """Failure-path counters for the hardened fetch dataplane: retries
    issued, checksum mismatches, peers declared suspect, terminal fetch
    failures. The reference has no failure observability at all (its only
    signal is the FetchFailedException itself); here every rung of the
    escalation ladder is counted so an ops dashboard can tell "healthy
    retries absorbing blips" from "about to escalate to stage retry"."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def incr(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            return self._counts[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._counts.items()))


class WriteMetrics:
    """Write-side mirror of ``ReadMetrics``: per-writer telemetry for the
    streaming map-side dataplane (shuffle/writer.py). Phase times
    (scatter/spill/merge, ns), spill count/bytes, and the peak of the two
    memory gauges the bounded-memory design promises: ``peak_buffered``
    (accumulating runs awaiting a spill decision — bounded by
    ``spill_threshold_bytes`` + one batch) and ``peak_outstanding``
    (accumulation PLUS spills in flight on the background thread — bounded
    by (1 + write_spill_threads) x that). Updated from the writer's task
    thread and its spill threads — mutate via the record_* methods."""

    def __init__(self):
        self._lock = threading.Lock()
        self.scatter_ns = 0
        self.spill_ns = 0
        self.merge_ns = 0
        self.spills = 0
        self.spilled_bytes = 0
        self.spill_wait_ns = 0  # write_batch blocked on spill backpressure
        self.peak_buffered_bytes = 0
        self.peak_outstanding_bytes = 0
        self.native_scatter = False
        # failure path: transient spill retries absorbed, spill dirs that
        # failed under this writer, ENOSPC-driven threshold shrinks, and
        # best-effort cleanup unlinks that themselves failed (swallowed,
        # but COUNTED — chaos runs assert nothing leaked silently)
        self.spill_retries = 0
        self.spill_dir_failures = 0
        self.spill_shrinks = 0
        self.cleanup_errors = 0
        # push-merge tiered spill: spills that overflowed to a merge
        # peer after every local directory was exhausted (the attempt
        # survived ENOSPC instead of failing)
        self.remote_spills = 0

    def record_scatter(self, ns: int) -> None:
        with self._lock:
            self.scatter_ns += ns

    def record_spill(self, ns: int, nbytes: int) -> None:
        with self._lock:
            self.spill_ns += ns
            self.spills += 1
            self.spilled_bytes += nbytes

    def record_merge(self, ns: int) -> None:
        with self._lock:
            self.merge_ns += ns

    def record_spill_wait(self, ns: int) -> None:
        with self._lock:
            self.spill_wait_ns += ns

    def record_buffered(self, buffered: int, outstanding: int) -> None:
        with self._lock:
            self.peak_buffered_bytes = max(self.peak_buffered_bytes, buffered)
            self.peak_outstanding_bytes = max(self.peak_outstanding_bytes,
                                              outstanding)

    def record_spill_retry(self) -> None:
        with self._lock:
            self.spill_retries += 1

    def record_spill_dir_failure(self) -> None:
        with self._lock:
            self.spill_dir_failures += 1

    def record_spill_shrink(self) -> None:
        with self._lock:
            self.spill_shrinks += 1

    def record_cleanup_error(self) -> None:
        with self._lock:
            self.cleanup_errors += 1

    def record_remote_spill(self) -> None:
        with self._lock:
            self.remote_spills += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "scatter_ns": self.scatter_ns,
                "spill_ns": self.spill_ns,
                "merge_ns": self.merge_ns,
                "spill_wait_ns": self.spill_wait_ns,
                "spills": self.spills,
                "spilled_bytes": self.spilled_bytes,
                "peak_buffered_bytes": self.peak_buffered_bytes,
                "peak_outstanding_bytes": self.peak_outstanding_bytes,
                "native_scatter": self.native_scatter,
                "spill_retries": self.spill_retries,
                "spill_dir_failures": self.spill_dir_failures,
                "spill_shrinks": self.spill_shrinks,
                "cleanup_errors": self.cleanup_errors,
                "remote_spills": self.remote_spills,
            }


class ShuffleReaderStats:
    """Per-remote + global histograms (RdmaShuffleReaderStats.scala:32-81)."""

    def __init__(self, conf: Optional[TpuShuffleConf] = None):
        conf = conf or TpuShuffleConf()
        self._bucket_ms = conf.fetch_time_bucket_size_ms
        self._num_buckets = conf.fetch_time_num_buckets
        self._per_remote: Dict[int, FetchHistogram] = {}
        self._global = FetchHistogram(self._bucket_ms, self._num_buckets)
        self._lock = threading.Lock()
        # pipelined-fetch telemetry rides the same stats object so one
        # snapshot shows latency AND pipeline behavior per remote
        self.pipeline = FetchPipelineStats()
        # failure-path counters ride along too: one snapshot answers both
        # "how fast" and "how rough"
        self.failures = FailureCounters()
        # bytes-per-data-request distribution: the coalesced dataplane's
        # whole point is fewer, larger requests — visible here as mass
        # shifting into the high buckets
        self.request_bytes = BytesHistogram()
        # skew observability (adaptive reduce planner): total input bytes
        # per REDUCER task, pow2-bucketed, plus the max for the
        # reduce_balance gauge (max/mean — 1.0 is perfectly balanced,
        # a zipfian stage under the static plan reads >> 1, and the
        # planner's whole job is pulling it back toward 1)
        self.bytes_per_reducer = BytesHistogram()
        self._reducer_max_bytes = 0

    def update(self, exec_index: int, latency_s: float,
               nbytes: int = -1) -> None:
        with self._lock:
            hist = self._per_remote.get(exec_index)
            if hist is None:
                hist = FetchHistogram(self._bucket_ms, self._num_buckets)
                self._per_remote[exec_index] = hist
            hist.add(latency_s)
            self._global.add(latency_s)
            if nbytes >= 0:
                self.request_bytes.add(nbytes)

    def record_reducer_bytes(self, nbytes: int) -> None:
        """One reducer task's total input bytes (recorded once per fetch
        lifetime, at fetcher close)."""
        with self._lock:
            self.bytes_per_reducer.add(nbytes)
            self._reducer_max_bytes = max(self._reducer_max_bytes,
                                          max(0, int(nbytes)))

    def reduce_balance(self) -> float:
        """max/mean bytes across recorded reducer tasks (the skew
        gauge); 0.0 before any reducer finished."""
        with self._lock:
            hist = self.bytes_per_reducer
            if not hist.count:
                return 0.0
            mean = hist.total_bytes / hist.count
            return float(self._reducer_max_bytes / mean) if mean else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "global": self._global.summary(),
                "per_remote": {str(k): v.summary()
                               for k, v in sorted(self._per_remote.items())},
            }
            if self.request_bytes.count:
                snap["request_bytes"] = self.request_bytes.summary()
            if self.bytes_per_reducer.count:
                snap["bytes_per_reducer"] = self.bytes_per_reducer.summary()
                mean = (self.bytes_per_reducer.total_bytes
                        / self.bytes_per_reducer.count)
                snap["reduce_balance"] = (
                    round(self._reducer_max_bytes / mean, 3) if mean
                    else 0.0)
        pipeline = self.pipeline.snapshot()
        if pipeline["per_peer"]:
            snap["pipeline"] = pipeline
        failures = self.failures.snapshot()
        if failures:
            snap["failures"] = failures
        return snap

    def log_summary(self, logger) -> None:
        """Printed at stop (RdmaShuffleReaderStats.scala:55-81)."""
        snap = self.snapshot()
        if snap["global"]["count"] == 0 and "failures" not in snap:
            return
        logger.info("shuffle fetch latency (global): %s", snap["global"])
        for remote, summary in snap["per_remote"].items():
            logger.info("shuffle fetch latency (executor %s): %s",
                        remote, summary)
        if "failures" in snap:
            logger.info("shuffle fetch failure path: %s", snap["failures"])


class MemStats:
    """Host paging counters diffed over a window (OdpStats analogue,
    RdmaShuffleReaderStats.scala:83-99)."""

    def __init__(self):
        self._start = self._read()

    @staticmethod
    def _read() -> dict:
        try:
            with open("/proc/self/stat") as f:
                fields = f.read().split()
            minflt, majflt = int(fields[9]), int(fields[11])
        except (OSError, IndexError, ValueError):
            minflt = majflt = 0
        peak_kb = 0
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmHWM:"):
                        peak_kb = int(line.split()[1])
                        break
        except (OSError, IndexError, ValueError):
            pass
        if peak_kb == 0:
            # sandboxed /proc (gVisor-style) omits VmHWM; getrusage's
            # ru_maxrss is already KiB on Linux
            try:
                import resource
                peak_kb = resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss
            except (ImportError, OSError, ValueError):
                pass
        return {"minor_faults": minflt, "major_faults": majflt,
                "peak_rss_kb": peak_kb}

    def diff(self) -> dict:
        now = self._read()
        return {k: now[k] - self._start[k] if k != "peak_rss_kb" else now[k]
                for k in now}


def process_stats() -> dict:
    """One-shot convenience: pid + paging + rss snapshot."""
    return {"pid": os.getpid(), **MemStats._read()}
