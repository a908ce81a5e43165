"""The port's headline benchmark entry (``python -m sparkrdma_tpu_torch.
bench``) against the top-level ``bench.py`` it ports.

On the CPU, asked for with ``BENCH_FORCE_CPU=1``: the inner run and the
watchdog path each print one line in ``bench.py``'s schema, with the
keys ``bench.py`` writes plus the port's three (``shards``,
``power_limit_w``, ``ring_launches_per_step``). With no card and no
``BENCH_FORCE_CPU`` the watchdog prints the zero-value error record and
exits 1. ``_round_provenance`` records the JAX function's keys, the
dense guard runs both transports, and each device secondary's builder
runs its step here at the bench's CPU sizes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import bench as jbench
from sparkrdma_tpu_torch import bench as tbench
from sparkrdma_tpu_torch.models import terasort as tt
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

ROOT = Path(__file__).resolve().parents[1]
SIZE_MB = 1
# detail keys bench.py writes into a watchdog record (bench.py main's
# detail, _round_provenance, the secondary phase's baseline flag and the
# watchdog's per-mode maps)
BENCH_PY_KEYS = frozenset((
    "data_bytes", "devices", "tpu_step_s", "cpu_baseline_s", "platform",
    "device_kind", "sort_mode", "sort_mode_step_s", "tpu_step_latency_s",
    "reps", "step_s_mean", "step_s_std", "data_gen", "exchange_impl",
    "host_load_avg", "captured_at", "topology", "cpu_baseline_cached",
    "sort_mode_gbps", "sort_mode_latency_s"))
WATCHDOG_ONLY = frozenset(("cpu_baseline_cached", "sort_mode_gbps",
                           "sort_mode_latency_s"))
PORT_KEYS = frozenset(("shards", "power_limit_w", "ring_launches_per_step"))
RUNS = {
    "inner": {"BENCH_INNER": "1", "BENCH_FORCE_CPU": "1"},
    "watchdog": {"BENCH_FORCE_CPU": "1"},
    # no card: CUDA_VISIBLE_DEVICES hides any the host has
    "no_card": {"CUDA_VISIBLE_DEVICES": ""},
}


@pytest.fixture(scope="module")
def runs():
    """Each ``RUNS`` entry as one ``python -m sparkrdma_tpu_torch.bench``
    process at ``BENCH_SIZE_MB=1`` with the secondaries skipped, all
    started together: ``{name: (returncode, stdout lines)}``."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    base.update(BENCH_SIZE_MB=str(SIZE_MB), BENCH_SKIP_SECONDARY="1",
                PYTHONPATH=str(ROOT))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "sparkrdma_tpu_torch.bench"],
        env=dict(base, **extra), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, extra in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            out[name] = (proc.returncode, stdout.splitlines(), stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _line(runs, name):
    rc, lines, stderr = runs[name]
    assert len(lines) == 1, (lines, stderr[-2000:])
    return rc, json.loads(lines[0])


def test_bench_py_writes_the_listed_keys():
    """The key list above stands for ``bench.py``: each is a literal
    there."""
    source = (ROOT / "bench.py").read_text()
    missing = [k for k in BENCH_PY_KEYS if f'"{k}"' not in source]
    assert not missing


@pytest.mark.parametrize("name", ["inner", "watchdog"])
def test_cpu_run_prints_one_line_in_bench_py_schema(runs, name):
    rc, rec = _line(runs, name)
    assert rc == 0
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert rec["metric"] == "terasort_shuffle_throughput_per_chip"
    assert rec["unit"] == "GB/s/chip"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    detail = rec["detail"]
    want = BENCH_PY_KEYS | PORT_KEYS
    if name == "inner":
        want -= WATCHDOG_ONLY
    assert set(detail) == want
    rows_per_shard = (SIZE_MB << 20) // 100 // tbench.SHARDS
    assert detail["data_bytes"] == tbench.SHARDS * rows_per_shard * 100
    assert detail["platform"] == "cpu" and detail["device_kind"] == "cpu"
    assert detail["devices"] == 1 and detail["shards"] == 8
    assert detail["power_limit_w"] is None
    assert detail["exchange_impl"] == "gather"   # auto off the card
    assert detail["sort_mode"] == "gather"
    assert detail["ring_launches_per_step"] == 0
    assert detail["tpu_step_s"] > 0 and detail["cpu_baseline_s"] > 0
    assert len(detail["host_load_avg"]) == 3
    assert abs(rec["value"] - detail["data_bytes"] / detail["tpu_step_s"]
               / 1e9) < 2e-3
    if name == "watchdog":
        assert detail["sort_mode_gbps"] == {"gather": rec["value"]}
        assert rec["vs_baseline"] == round(
            detail["cpu_baseline_s"] / detail["tpu_step_s"], 3)


def test_no_card_prints_the_error_record_and_exits_1(runs):
    rc, rec = _line(runs, "no_card")
    assert rc == 1
    assert rec["metric"] == "terasort_shuffle_throughput_per_chip"
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert set(rec["detail"]) == {"error"}
    assert "device probe" in rec["detail"]["error"]


def test_round_provenance_matches_the_jax_functions_keys():
    jax_detail = jbench._round_provenance({})
    port_detail = tbench._round_provenance({})
    assert set(port_detail) == set(jax_detail) == {
        "host_load_avg", "captured_at", "topology"}
    assert set(port_detail["topology"]) == set(jax_detail["topology"])


def test_dense_guard_runs_both_transports(monkeypatch):
    made = []
    real = tt.make_terasort_step

    def spy(mesh, cfg, impl="auto"):
        made.append(impl)
        return real(mesh, cfg, impl)

    monkeypatch.setattr(tt, "make_terasort_step", spy)
    cfg = tt.TeraSortConfig(rows_per_device=512, payload_words=24,
                            out_factor=2)
    rows = tt.generate_rows(cfg, 8, seed=1)
    detail = {}
    tbench._bench_dense_guard(detail, VirtualMesh(8, "cpu"), "dense", cfg,
                              rows)
    assert made == ["dense", "gather"]
    guard = detail["dense_exchange_guard"]
    assert guard["dense_step_s"] > 0 and guard["gather_step_s"] > 0
    assert 0 < guard["dense_vs_gather"] < 100


@pytest.mark.parametrize("prefix,rate_key", [
    ("pagerank", "pagerank_edges_per_s"), ("join", "join_rows_per_s"),
    ("tpcds", "tpcds_fact_rows_per_s")])
def test_device_secondary_builders_run_their_steps(prefix, rate_key):
    mesh = VirtualMesh(8, "cpu")
    build = getattr(tbench, f"bench_{prefix}")
    detail = {}
    tbench._bench_secondary(detail, prefix, rate_key,
                            lambda: build(mesh, 8, False), reps=1)
    assert set(detail) == {rate_key} and detail[rate_key] > 0


def test_als_secondary_runs_bounded_rounds():
    detail = {}
    tbench._bench_als(detail, VirtualMesh(8, "cpu"), 8, False)
    assert set(detail) == {"als_ratings_per_s", "als_rounds"}
    assert detail["als_ratings_per_s"] > 0 and detail["als_rounds"] > 1


def test_secondary_records_a_failure_under_its_prefix():
    detail = {}

    def broken():
        raise RuntimeError("no such table")

    tbench._bench_secondary(detail, "join", "join_rows_per_s", broken, 1)
    assert detail == {"join_error": "RuntimeError: no such table"}
