"""Benchmark: TeraSort shuffle throughput of the port on one card.

    python -m sparkrdma_tpu_torch.bench

Port of the top-level ``bench.py``, function for function under the same
names, against this package's modules. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": ...}

Metric: steady-state shuffle GB/s per card through the fused partition +
ragged-exchange + local-sort step (``models/terasort.py::
make_terasort_step`` over ``VirtualMesh(8)`` on ``cuda``; its transport
is the ring kernel, ``csrc/ring_exchange.cu``) on ~1 GiB of classic
100-byte TeraSort rows (BASELINE.json config #1 scale). ``vs_baseline``
is the speedup over the identical pipeline in numpy on the host CPU
(``numpy_terasort``; README.md:11-17, BASELINE.md).

Where it differs from ``bench.py``, and why:

- The per-chip divisor is the number of cards the mesh lives on (one),
  not its 8 virtual shards: ``bench.py`` divides by
  ``len(jax.devices())``, one per chip. ``detail`` records ``devices``
  and ``shards``.
- One sort: the JAX package's three local-sort strategies (``gather``,
  ``multisort``, ``colsort``) are one implementation here
  (``ops/sort.py::sort_rows``), so the watchdog runs one TeraSort phase,
  labelled ``gather`` (``SORT_MODE``) in the record's keys that mirror
  ``bench.py``'s per-strategy ones. Its strategy knob and
  ``BENCH_TIMEOUT_MULTISORT_S`` have no counterpart.
- No fallback that hides the card: when the probe finds no card, or a
  phase crashes or times out, the watchdog prints the zero-value error
  record and exits 1. A CPU run happens only when the caller asks for it
  (``BENCH_FORCE_CPU=1``) and is marked ``platform: "cpu"``. There is no
  replay of an old record and no recovery watcher.
- No compile cache: the ring kernel is built into ``build/`` at first
  use, as on every path of the port; the numpy baseline's cache file
  lives there too.

Knobs (``bench.py``'s): ``BENCH_SIZE_MB`` (1024), ``BENCH_REPS`` (5),
``BENCH_IMPL`` (``auto``: the ring on ``cuda``),
``BENCH_LIGHT``, ``BENCH_SECONDARY``, ``BENCH_SKIP_SECONDARY``,
``BENCH_FORCE_CPU``, ``BENCH_PROBE_TIMEOUT_S`` (60), ``BENCH_TIMEOUT_S``
(540 a phase), ``BENCH_TIMEOUT_SECONDARY_S``, ``BENCH_SLICE_TOPOLOGY``,
``BENCH_ICI_GBPS``, ``BENCH_DCN_GBPS``; ``BENCH_INNER=1`` runs one phase
in this process.
"""

import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "terasort_shuffle_throughput_per_chip"
SHARDS = 8  # the virtual mesh every path of the port uses on one card
# the label of the one sort in the record's per-strategy keys, which
# mirror bench.py's
SORT_MODE = "gather"


def _probe_device(timeout_s: int = 60) -> tuple[str | None, str]:
    """Fast liveness probe of the card in a subprocess: one tiny op on
    ``cuda`` and a host read of its result.

    Returns (platform, "") if live, else (None, failure_reason); a crash
    is reported apart from a hang, so a code problem is never taken for
    a missing card.
    """
    code = ("import torch; x = torch.zeros(8, device='cuda') + 1; "
            "assert x.sum().item() == 8; "
            "print('PLATFORM=' + x.device.type)")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None, (f"device probe: a tiny cuda op hung >{timeout_s}s")
    for ln in proc.stdout.decode(errors="replace").splitlines():
        if ln.startswith("PLATFORM="):
            return ln.split("=", 1)[1], ""
    return None, ("device probe: crashed (exit=%d): %s"
                  % (proc.returncode,
                     proc.stderr.decode(errors="replace")[-300:]))


def _run_phase(env: dict, label: str, env_overrides: dict,
               timeout_s: int) -> tuple[Optional[dict], str]:
    """One budgeted inner-bench subprocess; returns (result, failure).

    Each phase has its own budget, so one slow stage never costs another
    stage its record.
    """
    env = dict(env, BENCH_INNER="1", **env_overrides)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "sparkrdma_tpu_torch.bench"], env=env,
            capture_output=True, timeout=timeout_s, cwd=_REPO)
    except subprocess.TimeoutExpired as e:
        # the inner run logs timestamped milestones to stderr; the tail
        # names the phase that was still running when the budget expired
        tail = (e.stderr or b"").decode(errors="replace")[-300:]
        return None, f"{label}: timeout after {timeout_s}s; last: {tail}"
    line = next((ln for ln in proc.stdout.decode().splitlines()
                 if ln.startswith("{")), None)
    if proc.returncode == 0 and line:
        return json.loads(line), ""
    return None, (f"{label}: exit={proc.returncode}: "
                  + proc.stderr.decode(errors="replace")[-400:])


def _run_inner(env: dict, timeout_s: int) -> tuple[Optional[dict], str]:
    """The TeraSort run, light: the baseline + secondary workloads run in
    their own phase (see _run_secondary)."""
    return _run_phase(env, SORT_MODE, {"BENCH_LIGHT": "1"}, timeout_s)


def _run_secondary(env: dict, timeout_s: int) -> tuple[Optional[dict], str]:
    """Baseline + secondary workloads in their own budgeted subprocess."""
    return _run_phase(env, "secondary", {"BENCH_SECONDARY": "1"}, timeout_s)


def _run_with_watchdog() -> int:
    """Run the bench in budgeted subprocesses with hard timeouts.

    Probe the card first (<= ``BENCH_PROBE_TIMEOUT_S``) unless the caller
    forced the CPU, then run TeraSort in its own subprocess, then
    the baseline and secondary workloads in another. Any failure prints
    the zero-value error record and returns 1: there is no fallback.
    """
    env = dict(os.environ)
    probe_s = int(env.get("BENCH_PROBE_TIMEOUT_S", "60"))
    mode_timeout_s = int(env.get("BENCH_TIMEOUT_S", "540"))
    if env.get("BENCH_FORCE_CPU") != "1":
        platform, probe_failure = _probe_device(probe_s)
        if platform is None:
            return _emit_error(probe_failure + "; full bench skipped")
    # TeraSort runs "light" (its timing only); the baseline and
    # secondary workloads get their own subprocess + budget below
    result, failure = _run_inner(env, mode_timeout_s)
    if result is None:
        return _emit_error(failure)
    detail = result["detail"]
    sec_timeout_s = int(env.get("BENCH_TIMEOUT_SECONDARY_S",
                                str(mode_timeout_s)))
    sec, sec_failure = _run_secondary(env, sec_timeout_s)
    if sec is None:
        return _emit_error(sec_failure)
    for key, val in sec["detail"].items():
        if detail.get(key) is None:  # missing or a light run's null
            detail[key] = val
    if not result.get("vs_baseline") and detail.get("cpu_baseline_s"):
        result["vs_baseline"] = round(
            detail["cpu_baseline_s"] / detail["tpu_step_s"], 3)
    detail["sort_mode"] = SORT_MODE
    detail["sort_mode_gbps"] = {SORT_MODE: result["value"]}
    detail["sort_mode_latency_s"] = {
        SORT_MODE: detail["tpu_step_latency_s"]}
    print(json.dumps(result))
    return 0


def _emit_error(failure: str) -> int:
    """The zero-value error record ``bench.py`` prints when nothing was
    measured; returns the exit code 1."""
    print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "GB/s/chip",
                      "vs_baseline": 0.0,
                      "detail": {"error": failure[-600:]}}))
    return 1


def _bench_secondary(detail: dict, prefix: str, rate_key: str, build,
                     reps: int) -> None:
    """Time one secondary workload's step; record items/s or the error.

    ``build() -> (step, inputs, item_count)`` where ``step(*inputs)`` ends
    with an overflow flag. Two warm-up steps, each read on the host, then
    ``reps`` timed steps, each waited for.
    """
    import torch

    try:
        step, inputs, count = build()
        for _ in range(2):
            out = step(*inputs)
            out[-1].cpu()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(*inputs)
            if out[0].is_cuda:
                torch.cuda.synchronize(out[0].device)
        dt = (time.perf_counter() - t0) / reps
        if out[-1].any().item():
            detail[prefix + "_error"] = "receive overflow (raise out_factor)"
        else:
            detail[rate_key] = round(count / dt, 0)
    except Exception as e:  # noqa: BLE001
        detail[prefix + "_error"] = f"{type(e).__name__}: {e}"[:120]


def _resolved_impl(mesh, impl: str) -> str:
    """The exchange transport that actually ran (resolve "auto")."""
    try:
        from sparkrdma_tpu_torch.parallel.exchange import resolve_impl

        return resolve_impl(mesh, impl)
    except Exception as e:  # noqa: BLE001 — provenance must not break bench
        return f"{impl} (resolve failed: {type(e).__name__})"


def _progress(msg: str) -> None:
    """Stall forensics: timestamped stderr milestones (stderr is surfaced
    by the watchdog on timeout, so a hung phase names itself)."""
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _power_limit_w(device) -> Optional[float]:
    """The card's power limit in watts (``nvidia-smi``); None off the
    card or when ``nvidia-smi`` gives no number."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(device.index or 0)],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# bump when numpy_terasort or the baseline pipeline changes: a stale
# cached number must not survive a pipeline change
_BASELINE_CACHE_VERSION = 1


def _cpu_baseline(cache_dir: str, size_mb: int, n: int, rows=None,
                  out_factor: int = 1) -> tuple[float, bool]:
    """Measure (or recall) the numpy-baseline seconds for this size.

    The baseline is deterministic for (size, shards, pipeline version,
    host): same seed, same code. So the measured seconds are cached
    across runs in ``cache_dir``. The key carries the host name (a shared
    cache dir must not let host A's CPU speed stand in for host B's) and
    a pipeline version (bumped on baseline-code changes). Returns
    (seconds, cache_hit).
    """
    import platform as _platform

    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig, generate_rows, numpy_terasort)

    path = os.path.join(cache_dir, "cpu_baseline.json")
    key = (f"{size_mb}mb-n{n}-v{_BASELINE_CACHE_VERSION}"
           f"-{_platform.node() or 'unknown'}")
    try:
        with open(path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        cache = {}
    if key in cache:
        return cache[key], True
    if rows is None:
        row_bytes = 100
        cfg = TeraSortConfig(rows_per_device=(size_mb << 20) // row_bytes // n,
                             payload_words=24, out_factor=out_factor)
        rows = generate_rows(cfg, n, seed=0)
        _progress("baseline rows generated")
    t0 = time.perf_counter()
    numpy_terasort(rows, max(n, 8))
    dt = time.perf_counter() - t0
    cache[key] = round(dt, 4)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(cache, f)
    except OSError:
        pass
    return dt, False


def bench_pagerank(mesh, n: int, on_device: bool):
    """PageRank's step and inputs (BASELINE.md config #3) for
    ``_bench_secondary``."""
    from sparkrdma_tpu_torch.models.pagerank import (
        PageRankConfig, make_pagerank_step, random_graph)
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, shards_from_numpy

    pcfg = PageRankConfig(num_vertices=(1 << 16) if on_device else 1024,
                          edges_per_device=(1 << 20) // n if on_device else 4096,
                          out_factor=max(2, n))
    edges, ranks, deg = random_graph(pcfg, n, seed=0)
    inputs = (rows_from_numpy(edges, mesh), shards_from_numpy(ranks, mesh),
              shards_from_numpy(deg, mesh))
    return make_pagerank_step(mesh, pcfg), inputs, len(edges)


def bench_join(mesh, n: int, on_device: bool):
    """The shuffle join's step and inputs (config #4)."""
    from sparkrdma_tpu_torch.models.join import (
        JoinConfig, generate_tables, make_join_step)
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

    jrows = (1 << 20) if on_device else 4096
    jcfg = JoinConfig(rows_per_device_left=jrows, rows_per_device_right=jrows,
                      key_space=jrows, out_factor=2)
    left, right = generate_tables(jcfg, n, seed=0)
    inputs = (rows_from_numpy(left, mesh), rows_from_numpy(right, mesh))
    return make_join_step(mesh, jcfg), inputs, len(left) + len(right)


def bench_tpcds(mesh, n: int, on_device: bool):
    """The TPC-DS star's step and inputs (config #4)."""
    from sparkrdma_tpu_torch.models.tpcds import (
        TpcdsConfig, generate_star, make_tpcds_step, pad_to_devices)
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

    frows = (1 << 20) if on_device else 2048
    tcfg = TpcdsConfig(fact_rows_per_device=frows,
                       dim1_size=frows // 4, dim2_size=frows // 4,
                       num_groups=1024, out_factor=4)
    fact, dim1, dim2 = generate_star(tcfg, n, seed=0)
    inputs = (rows_from_numpy(fact, mesh),
              rows_from_numpy(pad_to_devices(dim1, n), mesh),
              rows_from_numpy(pad_to_devices(dim2, n), mesh))
    return make_tpcds_step(mesh, tcfg), inputs, len(fact)


def _secondary_workloads(detail: dict, mesh, n: int, on_device: bool) -> None:
    """Time the PageRank / join / TPC-DS steps (BASELINE.md configs #3/#4),
    ALS and the host benches; best-effort: they enrich ``detail`` but
    never break the headline."""
    _bench_secondary(detail, "pagerank", "pagerank_edges_per_s",
                     lambda: bench_pagerank(mesh, n, on_device), reps=5)
    _progress("pagerank done")
    _bench_secondary(detail, "join", "join_rows_per_s",
                     lambda: bench_join(mesh, n, on_device), reps=3)
    _progress("join done")
    _bench_secondary(detail, "tpcds", "tpcds_fact_rows_per_s",
                     lambda: bench_tpcds(mesh, n, on_device), reps=3)
    _progress("tpcds done")
    _bench_als(detail, mesh, n, on_device)
    _progress("als done")
    _bench_fetch_pipeline(detail)
    _progress("fetch pipeline done")
    _bench_write_path(detail)
    _progress("write path done")
    _bench_iterative(detail)
    _progress("iterative warm done")
    _bench_merged_read(detail)
    _progress("merged read done")
    _bench_skew(detail)
    _progress("skew plan done")
    _bench_fused_exchange(detail, mesh)
    _progress("fused exchange done")
    _bench_topo_exchange(detail, mesh)
    _progress("hierarchical exchange done")
    _bench_serve_path(detail)
    _progress("serve path done")
    _bench_client_fetch(detail, mesh.device)
    _progress("client fetch done")
    _bench_tenant_isolation(detail)
    _progress("tenant isolation done")
    _bench_elastic(detail)
    _progress("elastic drain done")
    _bench_pushplan(detail)
    _progress("planned push done")
    _bench_ha_failover(detail)
    _progress("driver failover done")
    _bench_cold_restore(detail)
    _progress("cold restore done")
    _bench_ctrl_plane(detail)
    _progress("control-plane scale-out done")


def _bench_als(detail: dict, mesh, n: int, on_device: bool) -> None:
    """ALS skewed half-step (BASELINE config #5, the skew stress): the
    zipf-hammered item side routed through the bounded-round chunked
    exchange, timed as ratings routed per second. Host-driven (grouping
    and solves are driven from the host like the rehearsal), so it can't
    ride ``_bench_secondary``'s one-step contract."""
    try:
        from sparkrdma_tpu_torch.models.als import (
            ALSConfig, als_half_step, generate_ratings)

        per_dev = (1 << 16) if on_device else 2048
        acfg = ALSConfig(num_users=64 * n, num_items=max(16, per_dev // 64),
                         rank=8, zipf_a=1.3)
        ratings = generate_ratings(acfg, n, per_dev, seed=0)
        rng = np.random.default_rng(0)
        user_factors = (rng.standard_normal((acfg.num_users, acfg.rank))
                        .astype(np.float32) / np.sqrt(acfg.rank))
        # quota sized so zipf skew forces multiple bounded rounds (the
        # point of config #5) without degenerating to per-row rounds
        quota = max(64, per_dev // 8)
        als_half_step(mesh, acfg, ratings, user_factors, quota)  # warm-up
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            _, rounds = als_half_step(mesh, acfg, ratings, user_factors,
                                      quota)
        dt = (time.perf_counter() - t0) / reps
        detail["als_ratings_per_s"] = round(len(ratings) / dt, 0)
        detail["als_rounds"] = rounds
    except Exception as e:  # noqa: BLE001
        detail["als_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_fetch_pipeline(detail: dict) -> None:
    """The fetch-dataplane pipelining win, measured without hardware: a
    loopback two-executor cluster with a fixed service delay standing in
    for wire latency, one reducer draining the same shuffle at
    read-ahead depth 1 (the pre-pipelining serialized fetch) vs deep
    (see shuffle/fetch_bench.py). Pure host path — runs identically on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.fetch_bench import run_fetch_microbench
        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of

        with tempfile.TemporaryDirectory(prefix="fetchbench_") as td:
            res = gated_best_of(
                lambda: run_fetch_microbench(td, depths=(1, 8),
                                             delay_s=0.004,
                                             num_partitions=32, reps=2))
        if not res["identical"]:
            detail["fetch_pipeline_error"] = \
                "depth runs fetched different bytes"
            return
        detail["fetch_pipeline_speedup"] = res["speedup"]
        detail["fetch_pipeline_wall_s"] = {
            f"depth{d}": t for d, t in res["wall_s"].items()}
    except Exception as e:  # noqa: BLE001
        detail["fetch_pipeline_error"] = f"{type(e).__name__}: {e}"[:120]
    # the coalesced dataplane's RPC-count reduction on a many-small-maps
    # shuffle (64 maps x 8 partitions at equal bytes, request frames
    # counted per dataplane) — the metric the per-peer batching exists for
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.fetch_bench import run_coalesce_microbench

        with tempfile.TemporaryDirectory(prefix="coalescebench_") as td:
            cres = run_coalesce_microbench(td)
        if not cres["identical"]:
            detail["fetch_rpc_error"] = "dataplanes fetched different bytes"
            return
        detail["fetch_rpc_reduction"] = cres["rpc_reduction"]
        detail["fetch_rpc_requests"] = cres["requests"]
    except Exception as e:  # noqa: BLE001
        detail["fetch_rpc_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_merged_read(detail: dict) -> None:
    """The push-merge dataplane's win, measured without hardware: a
    many-small-maps shuffle drained by a late-joining reducer at equal
    bytes, once over the scattered per-map fan-in (M x P served ranges)
    and once merged-segment-first (P sequential wide reads, ~1 request
    per partition), with a per-range seek-cost shim standing in for the
    random IOPS a real disk charges scattered reads
    (shuffle/merge_bench.py). Pure host path — identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.merge_bench import run_merge_microbench
        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of

        with tempfile.TemporaryDirectory(prefix="mergebench_") as td:
            res = gated_best_of(lambda: run_merge_microbench(td))
        if not res["identical"]:
            detail["merged_read_error"] = \
                "merged and scattered reads fetched different bytes"
            return
        if not res["coverage_complete"]:
            detail["merged_read_error"] = "merged coverage never completed"
            return
        detail["merged_read_speedup"] = res["speedup"]
        detail["merged_read_wall_s"] = res["wall_s"]
        detail["merged_read_requests"] = res["requests"]
        detail["merged_read_blocks_served"] = res["blocks_served"]
    except Exception as e:  # noqa: BLE001
        detail["merged_read_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_iterative(detail: dict) -> None:
    """The warm metadata plane's win, measured without hardware: a
    PageRank-style 10-superstep loop re-reading one unchanged shuffle
    over loopback with a fixed metadata service delay standing in for
    control-plane RTT — cold (every superstep re-syncs the driver table
    + per-peer locations) vs warm (epoch-validated local cache, ZERO
    metadata RPCs on supersteps >= 1); see shuffle/iter_bench.py. Pure
    host path — identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.iter_bench import run_iterative_microbench
        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of

        with tempfile.TemporaryDirectory(prefix="iterbench_") as td:
            res = gated_best_of(
                lambda: run_iterative_microbench(td, supersteps=10))
        if not res["identical"]:
            detail["iterative_warm_error"] = \
                "cold and warm supersteps fetched different bytes"
            return
        if res["metadata_rpcs_per_superstep"]["warm"] != 0:
            detail["iterative_warm_error"] = (
                "warm supersteps issued metadata RPCs: "
                f"{res['metadata_rpcs_per_superstep']}")
            return
        detail["iterative_warm_speedup"] = res["speedup"]
        detail["iterative_metadata_rpcs"] = res["metadata_rpcs_per_superstep"]
        detail["iterative_wall_s"] = res["wall_s_per_superstep"]
    except Exception as e:  # noqa: BLE001
        detail["iterative_warm_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_skew(detail: dict) -> None:
    """The adaptive reduce planner's win on skewed workloads, measured
    without hardware: a zipfian-key terasort (and a hot-key join) reduced
    under the static plan vs the driver's adaptive plan — coalesce tiny
    partitions, split the hot one by map-range, byte-identical output —
    in the SAME process on the same worker pool, so the ratio cancels
    host noise like dense_exchange_guard; see shuffle/plan_bench.py.
    Pure host path — identical on card and CPU records."""
    import tempfile

    from sparkrdma_tpu_torch.shuffle.plan_bench import run_skew_microbench

    # per-workload records (same harness; a regression names its
    # workload): terasort carries the headline skew_speedup plus the
    # plan/balance detail, the hot-join shape rides as skew_join_*
    for workload, prefix in (("terasort", "skew"), ("join", "skew_join")):
        try:
            with tempfile.TemporaryDirectory(prefix=f"{prefix}bench_") as td:
                res = run_skew_microbench(td, workload=workload)
            if not res["identical"]:
                detail[f"{prefix}_error"] = (f"{workload}: static and "
                                             "adaptive plans reduced "
                                             "different bytes")
                continue
            detail[f"{prefix}_speedup"] = res["skew_speedup"]
            if workload == "terasort":
                detail["skew_wall_s"] = res["wall_s"]
                detail["skew_plan"] = res["plan"]
                detail["skew_reduce_balance"] = res["reduce_balance"]
        except Exception as e:  # noqa: BLE001
            detail[f"{prefix}_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_fused_exchange(detail: dict, mesh) -> None:
    """The fused device dataplane's win over the host-staged reduce, on
    ``mesh`` (the bench's): the same shuffle reduced once through
    per-partition remote fetches (delay shim standing in for wire RTT,
    the fetch_bench precedent) and once through the fused
    partition+exchange+local-sort collective — same process, so the
    ratio cancels host noise like dense_exchange_guard; byte-identical
    output is the gate. See shuffle/device_bench.py."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.device_bench import run_device_microbench
        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of

        with tempfile.TemporaryDirectory(prefix="devbench_") as td:
            res = gated_best_of(lambda: run_device_microbench(td, mesh=mesh))
        if not res["identical"]:
            detail["fused_exchange_error"] = \
                "host and fused dataplanes reduced different bytes"
            return
        detail["fused_exchange_speedup"] = res["speedup"]
        detail["fused_exchange_wall_s"] = res["wall_s"]
    except Exception as e:  # noqa: BLE001
        detail["fused_exchange_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_serve_path(detail: dict) -> None:
    """The zero-copy serve path's win, measured the way the ROADMAP asks:
    serve-side CPU per GB served (getrusage of the serving process, the
    client isolated in a subprocess) alongside throughput, A/B'd against
    the old copy-and-recompute path on the same file at equal bytes —
    byte-identical responses gated, CRC reuse measured in the checksum
    submode (shuffle/serve_bench.py). CPU ratios count cycles, not wall
    time, so this secondary is host-contention-robust. Pure host path —
    identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.serve_bench import run_serve_microbench

        cpu, thr = {}, {}
        for checksum, tag in ((False, "plain"), (True, "crc")):
            with tempfile.TemporaryDirectory(prefix="servebench_") as td:
                res = run_serve_microbench(td, checksum=checksum)
            if not res["identical"]:
                detail["serve_path_error"] = \
                    f"{tag}: modes served different bytes"
                return
            if not res["trailer_ok"]:
                detail["serve_path_error"] = f"{tag}: CRC trailer mismatch"
                return
            cpu[tag] = res["cpu_s_per_gb"]
            thr[tag] = res["throughput_gb_s"]
            if checksum:
                detail["serve_crc_reused"] = res["crc_reused"]
        detail["serve_cpu_per_gb"] = cpu
        detail["serve_throughput"] = thr
        detail["serve_cpu_speedup"] = (
            round(cpu["plain"]["memcpy"] / cpu["plain"]["zero_copy"], 2)
            if cpu["plain"]["zero_copy"] else 0.0)
        detail["serve_cpu_speedup_crc"] = (
            round(cpu["crc"]["memcpy"] / cpu["crc"]["zero_copy"], 2)
            if cpu["crc"]["zero_copy"] else 0.0)
    except Exception as e:  # noqa: BLE001
        detail["serve_path_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_client_fetch(detail: dict, device) -> None:
    """The native client fetch engine's win — the receive-side mirror of
    the serve secondary: client-side CPU per GB fetched (getrusage of
    the fetching process, the server isolated in a subprocess) plus the
    wire-to-device latency of one request's payload, A/B'd against the
    pure-Python receive path on the same block schedule at equal bytes
    with per-request digests gating byte-identity
    (shuffle/client_bench.py); the probe uploads to ``device`` (the
    bench's). Skips cleanly where the .so isn't built."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.client_bench import run_client_microbench

        cpu, w2d = {}, {}
        for checksum, tag in ((False, "plain"), (True, "crc")):
            with tempfile.TemporaryDirectory(prefix="clientbench_") as td:
                res = run_client_microbench(td, file_mb=32, total_mb=128,
                                            checksum=checksum, device=device)
            if not res["identical"]:
                detail["client_fetch_error"] = \
                    f"{tag}: engines fetched different bytes"
                return
            cpu[tag] = res["cpu_s_per_gb"]
            w2d[tag] = res["wire_to_device_ms"]
            if checksum:
                detail["client_doorbell"] = res["doorbell"]
        detail["client_cpu_per_gb"] = cpu
        detail["client_wire_to_device_ms"] = w2d
        detail["client_cpu_speedup"] = (
            round(cpu["plain"]["python"] / cpu["plain"]["native"], 2)
            if cpu["plain"]["native"] else 0.0)
        detail["client_cpu_speedup_crc"] = (
            round(cpu["crc"]["python"] / cpu["crc"]["native"], 2)
            if cpu["crc"]["native"] else 0.0)
    except Exception as e:  # noqa: BLE001
        detail["client_fetch_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_topo_exchange(detail: dict, mesh) -> None:
    """The two-level (hierarchical) dataplane's win over the flat plan,
    measured without multi-slice hardware: the same slice-affine shuffle
    exchanged once flat (every byte priced at the modeled DCN rate — a
    cross-slice all-to-all is lock-stepped on its slowest links) and
    once hierarchically (per-slice ICI bulk, DCN only for the residue,
    link-cost-aware partition layout) on a 2-slice virtual cluster with
    a 10:1 ICI:DCN cost shim — same process, ratio cancels host noise;
    byte-identical per-partition output is the gate, and the
    hierarchical side must move STRICTLY fewer cross-slice bytes. See
    shuffle/topo_bench.py. Runs on ``mesh`` (the bench's)."""
    try:
        from sparkrdma_tpu_torch.shuffle.topo_bench import run_topo_microbench

        # the same env knobs _round_provenance records steer the run
        # (BENCH_IMPL precedent): slice count from
        # BENCH_SLICE_TOPOLOGY ("N" form), cost ratio from the
        # coefficient pair — so recorded topology matches what ran
        kw = {}
        spec = os.environ.get("BENCH_SLICE_TOPOLOGY", "").strip()
        if spec.isdigit() and int(spec) >= 1:
            kw["num_slices"] = int(spec)
        try:
            kw["cost_ratio"] = (float(os.environ["BENCH_ICI_GBPS"])
                                / float(os.environ["BENCH_DCN_GBPS"]))
        except (KeyError, ValueError, ZeroDivisionError):
            pass
        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of
        res = gated_best_of(lambda: run_topo_microbench(mesh=mesh, **kw))
        if res["slices"] < 2:
            detail["hierarchical_exchange_error"] = res.get(
                "note", "single-slice host: no seam to exchange across")
            return
        if not res["identical"]:
            detail["hierarchical_exchange_error"] = \
                "flat and hierarchical plans exchanged different bytes"
            return
        cross = res["cross_slice_bytes"]
        if cross["hier"] >= cross["flat"]:
            detail["hierarchical_exchange_error"] = (
                f"cross-slice bytes not reduced: hier {cross['hier']} >= "
                f"flat {cross['flat']}")
            return
        detail["hierarchical_exchange_speedup"] = res["speedup"]
        detail["hierarchical_exchange_wall_s"] = res["wall_s"]
        detail["cross_slice_bytes"] = cross
    except Exception as e:  # noqa: BLE001
        detail["hierarchical_exchange_error"] = \
            f"{type(e).__name__}: {e}"[:120]


def _bench_ctrl_plane(detail: dict) -> None:
    """Partitioned metadata ownership's win, measured without hardware:
    the same deterministic publish scripts (fence-1 publishes + zombie
    fence-0 re-publishes + fence-2 supersedes + merged-directory blobs)
    run through ONE driver lock vs through 4 real per-shard write
    owners with batched driver convergence, same process
    (shuffle/ctrl_bench.py). Gates: the resulting driver state is
    byte-identical — table bytes, fence floors, merged directory, and
    WHICH writes got fenced — and ``ctrl_plane_scaleout`` >= 1.5x at 4
    owners (tier-1 asserts the same bound). ``ctrl_registrations_per_s``
    is the part that deliberately stays driver-serialized (shard-map
    assignment + epoch composition). Pure host path — identical on card and CPU records."""
    try:
        from sparkrdma_tpu_torch.shuffle.ctrl_bench import run_ctrl_microbench

        res = run_ctrl_microbench(shards=4)
        if not res["identical"]:
            detail["ctrl_plane_error"] = \
                "sharded driver state diverged from the 1-owner baseline"
            return
        detail["ctrl_plane_scaleout"] = res["speedup"]
        detail["ctrl_publishes_per_s_driver"] = res["publishes_per_s_driver"]
        detail["ctrl_publishes_per_s_sharded"] = res["publishes_per_s_sharded"]
        detail["ctrl_registrations_per_s"] = res["registrations_per_s"]
    except Exception as e:  # noqa: BLE001
        detail["ctrl_plane_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_elastic(detail: dict) -> None:
    """Elastic membership's win, measured without hardware: the SAME
    executor leaves the fleet by planned DRAIN (push-merge replication
    verified, location entries re-point under a bumped epoch — zero
    re-executions) vs by unplanned KILL on a replication-less fleet
    (FetchFailed -> recovery recomputes every map it owned), same
    seeded data, byte-identical gate (shuffle/elastic_bench.py).
    ``drain_zero_reexec`` is the acceptance gate (must be 0);
    ``drain_vs_kill_reexec`` and the makespan delta record what one
    autoscaler shrink decision costs. Pure host path — identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.elastic_bench import (
            run_elastic_microbench)

        with tempfile.TemporaryDirectory(prefix="elasticbench_") as td:
            res = run_elastic_microbench(td)
        if not res["identical"]:
            detail["elastic_drain_error"] = \
                "drain/kill arms diverged from the ground truth"
            return
        if res["drain_status"] != "drained":
            detail["elastic_drain_error"] = \
                f"planned drain fell back: {res['drain_status']}"
            return
        detail["drain_zero_reexec"] = res["reexec_drain"]
        detail["drain_vs_kill_reexec"] = res["reexec_kill"]
        detail["drain_makespan_s"] = res["drain_makespan_s"]
        detail["kill_makespan_s"] = res["kill_makespan_s"]
        detail["drain_makespan_delta_s"] = res["makespan_delta_s"]
    except Exception as e:  # noqa: BLE001
        detail["elastic_drain_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_pushplan(detail: dict) -> None:
    """The sender-driven planned shuffle's win, measured without
    hardware: the same reduce partitions drained at their PLANNED slots
    twice under a fixed per-frame service delay standing in for wire
    latency — once pulling (driver-table RPC + per-map block fetches)
    and once from the pushed staging landed during the map stage
    (shuffle/pushplan_bench.py). Gates: byte-identical output and ZERO
    metadata + ZERO data RPCs for the fully-pushed read, counted
    server-side across the whole cluster. ``pushplan_speedup`` is
    reduce-stage start-to-first-row, the latency the push moved off the
    reduce critical path. Pure host path — identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.pushplan_bench import (
            run_pushplan_microbench)

        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of

        with tempfile.TemporaryDirectory(prefix="pushplanbench_") as td:
            res = gated_best_of(
                lambda: run_pushplan_microbench(td, reps=2),
                key="pushplan_speedup")
        if not res["identical"]:
            detail["pushplan_error"] = \
                "push and pull reads fetched different bytes"
            return
        if res["rpcs"]["push"]["meta"] or res["rpcs"]["push"]["data"]:
            detail["pushplan_error"] = (
                f"fully-pushed read still hit the wire: {res['rpcs']['push']}")
            return
        detail["pushplan_speedup"] = res["pushplan_speedup"]
        detail["pushplan_makespan_speedup"] = res["makespan_speedup"]
        detail["pushplan_first_row_s"] = res["first_row_s"]
        detail["pushplan_rpcs"] = res["rpcs"]
    except Exception as e:  # noqa: BLE001
        detail["pushplan_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_ha_failover(detail: dict) -> None:
    """Driver HA's cost, measured without hardware: a lease-armed
    primary with a warm standby shadowing its op log CRASHES after the
    map outputs have replicated, and ``failover_downtime_ms`` is crash
    to the FIRST successful publish against the promoted standby — the
    whole control-plane outage as an executor sees it (lease expiry +
    CAS takeover + op-log replay + TakeoverMsg re-point), probed by an
    idempotent republish loop (shuffle/ha_bench.py). Gates: the
    post-failover reduce is byte-identical and re-executes ZERO maps —
    losing the driver may cost a wait, never a recompute.
    ``failover_replay_ops`` is the op-log tail the promotion replayed
    (the ``oplog_lag_entries`` gauge). Pure host path — identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.ha_bench import run_ha_microbench

        with tempfile.TemporaryDirectory(prefix="habench_") as td:
            res = run_ha_microbench(td)
        if not res["identical"]:
            detail["ha_failover_error"] = \
                "post-failover reduce diverged from the ground truth"
            return
        if res["reexec"] != 0:
            detail["ha_failover_error"] = (
                f"failover re-executed {res['reexec']} maps")
            return
        detail["failover_downtime_ms"] = res["failover_downtime_ms"]
        detail["failover_lease_ms"] = res["lease_ms"]
        detail["failover_replay_ops"] = res["replay_ops"]
    except Exception as e:  # noqa: BLE001
        detail["ha_failover_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_cold_restore(detail: dict) -> None:
    """The disaggregated cold tier's win, measured without hardware:
    the WHOLE fleet dies after map finalize and a fresh fleet must
    answer — once restoring from the blob store (cold_tier on: zero
    map re-executions, the reduce serves from tiered segments) and
    once re-executing the entire map stage (cold_tier off: nothing
    survived the fleet), with a fixed per-map compute shim pricing the
    work a re-execution repays (shuffle/cold_bench.py).
    ``cold_restore_speedup`` is the fresh fleet's makespan ratio.
    Gates: both phases byte-identical, the cold phase's post-restart
    re-executions exactly ZERO. Pure host path — identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.cold_bench import run_cold_microbench
        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of

        with tempfile.TemporaryDirectory(prefix="coldbench_") as td:
            res = gated_best_of(lambda: run_cold_microbench(td))
        if not res["identical"]:
            detail["cold_restore_error"] = \
                "cold restore or re-execution diverged from ground truth"
            return
        if res["reexec"]["cold"] != 0:
            detail["cold_restore_error"] = (
                f"cold restore re-executed {res['reexec']['cold']} maps")
            return
        detail["cold_restore_speedup"] = res["speedup"]
        detail["cold_restore_wall_s"] = res["wall_s"]
        detail["cold_restore_reexec"] = res["reexec"]
    except Exception as e:  # noqa: BLE001
        detail["cold_restore_error"] = f"{type(e).__name__}: {e}"[:120]


def _bench_tenant_isolation(detail: dict) -> None:
    """The multi-tenant service's win, measured without hardware: an
    antagonist tenant saturates one executor's serve path with a
    sustained backlog of wide fan-in reads while a victim tenant issues
    small latency-sensitive fetches — victim p99 under FIFO serving vs
    deficit-round-robin fair share, same process, same data, with a
    byte-proportional serve-cost shim standing in for the disk/NIC
    service time a real server pays (shuffle/tenant_bench.py). Gates:
    byte-identical to the solo run, ZERO cross-tenant cache evictions.
    Also runs the sustained-traffic driver (N tenants x
    terasort/pagerank/join jobs at a target arrival rate through the
    admission-controlled driver) for the aggregate rows/s + per-tenant
    p99 + clean-shedding record. Pure host path — identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.tenant_bench import (
            run_isolation_microbench, run_sustained_bench)

        from sparkrdma_tpu_torch.utils.benchgate import gated_best_of

        with tempfile.TemporaryDirectory(prefix="tenantbench_") as td:
            res = gated_best_of(lambda: run_isolation_microbench(td))
        if not res["identical"]:
            detail["tenant_isolation_error"] = \
                "fair/FIFO/solo reads fetched different bytes"
            return
        if res["cross_tenant_evictions"]:
            detail["tenant_isolation_error"] = (
                f"{res['cross_tenant_evictions']} cross-tenant cache "
                "evictions (must be 0)")
            return
        detail["tenant_isolation_speedup"] = res["speedup"]
        detail["tenant_victim_p99_ms"] = res["p99_ms"]
        detail["tenant_fair_served"] = res["fair_served"]
        with tempfile.TemporaryDirectory(prefix="tenantsust_") as td:
            sus = run_sustained_bench(td)
        if not sus["identical"]:
            detail["tenant_sustained_error"] = \
                "a tenant's job output mismatched its input"
            return
        detail["tenant_sustained_rows_per_s"] = sus["aggregate_rows_per_s"]
        detail["tenant_sustained_p99_ms"] = sus["per_tenant_p99_ms"]
        detail["tenant_sustained_jobs"] = sus["jobs"]
    except Exception as e:  # noqa: BLE001
        detail["tenant_isolation_error"] = f"{type(e).__name__}: {e}"[:120]

def _bench_write_path(detail: dict) -> None:
    """The streaming write dataplane's win, measured without hardware:
    the same record batches through the pre-streaming monolithic writer
    (close-time global sort + full rows copy) and the streaming writer
    (O(n) scatter on arrival, background bounded-memory spill, sequential
    merge commit) at a spill-forcing size — see shuffle/write_bench.py.
    Pure host path, identical on card and CPU records."""
    try:
        import tempfile

        from sparkrdma_tpu_torch.shuffle.write_bench import run_write_microbench

        with tempfile.TemporaryDirectory(prefix="writebench_") as td:
            res = run_write_microbench(td, reps=2, map_compute_s=0.004)
        if not res["identical"]:
            detail["shuffle_write_error"] = \
                "streaming and monolithic committed files differ"
            return
        detail["shuffle_write_throughput"] = res["throughput_mb_s"]["streaming"]
        detail["shuffle_write_speedup"] = res["speedup"]
        detail["shuffle_write_spills"] = res["spills"]
        detail["shuffle_write_wall_s"] = res["wall_s"]
    except Exception as e:  # noqa: BLE001
        detail["shuffle_write_error"] = f"{type(e).__name__}: {e}"[:120]


def _round_provenance(detail: dict) -> dict:
    """Host-contention provenance EVERY bench round must carry: the
    load average (a uniform slowdown across workloads under high load
    is noise, not a regression: the BENCH_r05 lesson), the capture
    timestamp, and the DETECTED TOPOLOGY (slice count, devices/slice,
    link coefficients) so multi-slice rounds are attributable to the
    fabric they ran on."""
    detail["host_load_avg"] = [round(x, 2) for x in os.getloadavg()]
    detail["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())
    try:
        from sparkrdma_tpu_torch.config import TpuShuffleConf
        from sparkrdma_tpu_torch.parallel.topology import host_topology

        # a round benched under overridden topology knobs must record
        # the values the topo secondary actually ran with (the same env
        # steers _bench_topo_exchange); unset = the auto-detected
        # fabric + defaults
        conf_kw = {key: os.environ[env] for env, key in
                   (("BENCH_SLICE_TOPOLOGY", "slice_topology"),
                    ("BENCH_ICI_GBPS", "ici_gbps"),
                    ("BENCH_DCN_GBPS", "dcn_gbps")) if env in os.environ}
        detail["topology"] = host_topology(
            TpuShuffleConf(**conf_kw) if conf_kw else None).describe()
    except Exception as e:  # noqa: BLE001 — provenance never fails a round
        detail["topology_error"] = f"{type(e).__name__}: {e}"[:120]
    return detail


def _bench_dense_guard(detail: dict, mesh, impl: str, small_cfg,
                       small_rows) -> None:
    """Dense-exchange regression guard: time the SAME small terasort
    step under the dense and gather transports IN THIS ROUND and record
    the ratio. The ratio cancels host noise: a dense-specific code
    regression inflates it, uniform host contention doesn't."""
    from sparkrdma_tpu_torch.models.terasort import make_terasort_step
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

    try:
        guard = {}
        rows_d = rows_from_numpy(small_rows, mesh)
        for gimpl in ("dense", "gather"):
            gstep = make_terasort_step(mesh, small_cfg, impl=gimpl)
            for _ in range(2):
                gstep(rows_d)[1].cpu()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                gstep(rows_d)[1].cpu()
                times.append(time.perf_counter() - t0)
            guard[gimpl + "_step_s"] = round(min(times), 6)
        guard["dense_vs_gather"] = round(
            guard["dense_step_s"] / max(guard["gather_step_s"], 1e-9), 3)
        if not (guard["dense_step_s"] > 0 and guard["gather_step_s"] > 0):
            raise AssertionError(f"a transport took no time: {guard}")
        detail["dense_exchange_guard"] = guard
    except Exception as e:  # noqa: BLE001 — the guard enriches detail,
        # never breaks the headline
        detail["dense_exchange_guard_error"] = f"{type(e).__name__}: {e}"[:120]


def main() -> None:
    size_mb = int(os.environ.get("BENCH_SIZE_MB", "1024"))
    reps = int(os.environ.get("BENCH_REPS", "5"))

    import torch

    from sparkrdma_tpu_torch.models.terasort import (
        TeraSortConfig,
        generate_rows,
        make_terasort_step,
        verify_terasort,
    )
    from sparkrdma_tpu_torch.ops import _build, ring_exchange
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
    from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, rows_to_numpy

    device = torch.device(
        "cpu" if os.environ.get("BENCH_FORCE_CPU") == "1" else "cuda")
    mesh = VirtualMesh(SHARDS, device)  # without a card this raises
    n = SHARDS
    devices = 1  # every shard lives on the one card: the per-chip divisor
    row_bytes = 100  # 1 key word + 24 payload words
    rows_per_device = (size_mb << 20) // row_bytes // n
    on_device = device.type == "cuda"
    out_factor = 1 if n == 1 else 2
    cache_dir = str(_build.BUILD_DIR)

    if os.environ.get("BENCH_SECONDARY") == "1":
        # baseline + secondary phase: no terasort timing at all; this
        # subprocess's budget belongs to the numpy baseline and the
        # secondary workloads (see _run_secondary)
        detail = {}
        cpu_dt, was_cached = _cpu_baseline(cache_dir, size_mb, n,
                                           out_factor=out_factor)
        detail["cpu_baseline_s"] = round(cpu_dt, 4)
        detail["cpu_baseline_cached"] = was_cached
        _progress(f"cpu baseline done ({cpu_dt:.1f}s, cached={was_cached})")
        if os.environ.get("BENCH_SKIP_SECONDARY") != "1":
            _secondary_workloads(detail, mesh, n, on_device)
        _round_provenance(detail)
        print(json.dumps({"metric": "terasort_secondary", "value": 0,
                          "unit": "", "detail": detail}))
        return

    impl = os.environ.get("BENCH_IMPL", "auto")
    cfg = TeraSortConfig(rows_per_device=rows_per_device, payload_words=24,
                         out_factor=out_factor)
    rows = None
    _progress(f"inner start: shards={n} platform={device.type} "
              f"mode={SORT_MODE}")
    if on_device:
        # the uniform-random dataset is generated ON THE CARD, in the
        # port's row layout (u32 bits in int32): 1 GiB through the host
        # is not what's being measured
        gen = torch.Generator(device=device).manual_seed(0)
        rows_d = torch.randint(-2**31, 2**31,
                               (n, rows_per_device, 1 + cfg.payload_words),
                               dtype=torch.int32, device=device,
                               generator=gen)
        torch.cuda.synchronize(device)
        data_gen = "on-device torch.randint (cuda Generator, seed 0)"
        _progress("on-device generation done")
    else:
        rows = generate_rows(cfg, n, seed=0)
        rows_d = rows_from_numpy(rows, mesh)
        data_gen = "host numpy (seed 0) + copy to the mesh"
        _progress("rows staged")
    step = make_terasort_step(mesh, cfg, impl=impl)
    # two warm-up steps, each read on the host: the kernel's build and
    # load, the allocator's pools
    for i in range(2):
        _, counts, _of = step(rows_d)
        counts.cpu()
        _progress(f"{SORT_MODE}: warmup {i} done")
    # per-step latency: host-synced each step
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out, counts, overflowed = step(rows_d)
        counts.cpu()
        times.append(time.perf_counter() - t0)
    # steady-state throughput: keep TWO steps in flight, reading step
    # i-1's counts while step i is queued. Depth is capped at 2: each
    # step in flight holds its output and sort workspace on the card
    launches_before = ring_exchange.LAUNCHES
    t0 = time.perf_counter()
    prev = None
    for _ in range(reps):
        out, counts, overflowed = step(rows_d)
        if prev is not None:
            prev.cpu()
        prev = counts
    prev.cpu()
    pipelined = (time.perf_counter() - t0) / reps
    launches = ring_exchange.LAUNCHES - launches_before
    _progress(f"{SORT_MODE}: timed latency={min(times):.4f}s "
              f"pipelined={pipelined:.4f}s")
    if overflowed.any().item():
        raise AssertionError("receive-buffer overflow in bench")
    total_bytes = rows_d.nbytes
    del out, counts, overflowed, prev

    # spot-verify on a subsample to keep bench time bounded
    small_cfg = TeraSortConfig(rows_per_device=4096, payload_words=24,
                               out_factor=out_factor)
    small_rows = generate_rows(small_cfg, n, seed=1)
    small_step = make_terasort_step(mesh, small_cfg, impl=impl)
    s_out, s_counts, _ = small_step(rows_from_numpy(small_rows, mesh))
    verify_terasort(rows_to_numpy(s_out), s_counts.cpu().numpy(),
                    small_rows, n)
    _progress("verify done")

    light = os.environ.get("BENCH_LIGHT") == "1"
    if light:
        # the TeraSort run under the watchdog: the baseline belongs to the
        # separate secondary phase (merged back in by the watchdog)
        cpu_dt = None
    else:
        # CPU baseline: identical pipeline, numpy, same distribution (on
        # the card the timed dataset was generated there, so the baseline
        # sorts its own host-generated instance)
        cpu_dt, was_cached = _cpu_baseline(cache_dir, size_mb, n, rows=rows,
                                           out_factor=out_factor)
        _progress(f"cpu baseline done ({cpu_dt:.1f}s, cached={was_cached})")

    gbps_per_chip = total_bytes / pipelined / 1e9 / devices
    detail = {
        "data_bytes": total_bytes,
        "devices": devices,
        "shards": n,
        "tpu_step_s": round(pipelined, 6),
        "cpu_baseline_s": round(cpu_dt, 4) if cpu_dt else None,
        "platform": device.type,
        "device_kind": (torch.cuda.get_device_name(device) if on_device
                        else device.type),
        "power_limit_w": _power_limit_w(device),
        "sort_mode": SORT_MODE,
        "sort_mode_step_s": {SORT_MODE: round(pipelined, 6)},
        "tpu_step_latency_s": round(min(times), 6),
        # repetitions + spread so a few-percent swing between rounds is
        # attributable (host noise vs real regression)
        "reps": reps,
        "step_s_mean": round(float(np.mean(times)), 6),
        "step_s_std": round(float(np.std(times)), 6),
        "data_gen": data_gen,
        # what actually ran, not the request: "auto" resolves per mesh
        "exchange_impl": _resolved_impl(mesh, impl),
        # the ring kernel's launches per pipelined step (0 off the card:
        # the wrapper counts only the kernel's own launches)
        "ring_launches_per_step": launches / reps,
    }
    # host contention provenance: a uniform slowdown across every
    # workload with high load here is noise, not a regression
    _round_provenance(detail)
    if detail["exchange_impl"] == "dense":
        # dense-exchange step time tracked per round, noise-cancelled
        # against gather on the same host in the same process
        _bench_dense_guard(detail, mesh, impl, small_cfg, small_rows)
        _progress("dense exchange guard done")

    if not light and os.environ.get("BENCH_SKIP_SECONDARY") != "1":
        # Secondary workloads (BASELINE.md configs #3/#4): best-effort,
        # they enrich `detail` but must never break the headline metric.
        _secondary_workloads(detail, mesh, n, on_device)

    result = {
        "metric": METRIC,
        "value": round(gbps_per_chip, 3),
        "unit": "GB/s/chip",
        "vs_baseline": round(cpu_dt / pipelined, 3) if cpu_dt else None,
        "detail": detail,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    if os.environ.get("BENCH_INNER") == "1":
        sys.exit(main())
    sys.exit(_run_with_watchdog())
