"""``BENCHMARK.json`` against the files of the benchmark, the import rule,
a run without a card, and a cell added as files alone."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_lines():
    names = [m["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for m in MANIFEST[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for metric in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for entry in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert _line(entry["why"]), entry["name"]
    for entry in MANIFEST["configs"]:
        assert _line(entry["source"])
    assert all(_line(word) for word in MANIFEST["command"])
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_every_entry_has_its_files():
    for entry in MANIFEST["configs"]:
        cfg = harness.load_config(entry["name"])
        assert entry["file"] == f"benchmarks/configs/{entry['name']}.json"
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
    readers = harness.load_readers()
    for entry in MANIFEST["workloads"]:
        work = harness.load_workload(entry["name"])
        assert (work["config"], work["traffic"], work["why"]) == (
            entry["config"], entry["traffic"], entry["why"])
        assert (BENCH / "jobs" / f"{work['job']}.py").is_file()
        assert (BENCH / "reference" / f"{work['job']}.py").is_file()
        assert entry["chips"] == 1
    read = set()
    for metric in MANIFEST["per_layer"]:
        for cell in metric["workloads"]:
            prefix = harness.load_workload(cell).get("metric_prefix", "")
            assert metric["name"].startswith(prefix)
            base = metric["name"][len(prefix):]
            assert readers[base].UNIT == metric["unit"]
            read.add(base)
    assert read == set(readers)


def test_each_metric_moves_what_its_cells_report():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in e2e.values():
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric.get("workloads", cells)) <= cells
    for metric in MANIFEST["per_layer"]:
        assert metric["moves"] in e2e
        assert set(metric["workloads"]) <= cells
    for cell in cells:
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])
        prefix = harness.load_workload(cell).get("metric_prefix", "")
        left_out = harness.load_workload(cell).get("leave_out", [])
        reported = {m["name"] for m in e2e.values()
                    if cell in m.get("workloads", cells)}
        assert reported == {
            prefix + name if name in harness.NOISE_SPLIT else name
            for name in ("throughput_gb_per_s", "job_p95_ms",
                         "peak_device_gib", "setup_s")
            if name not in left_out}
        for metric in MANIFEST["per_layer"]:
            if cell in metric["workloads"]:
                assert metric["moves"] in reported


def test_a_run_reports_its_cells_metrics():
    from conftest import run_small

    for cell in ("tpcds-sf1.q95", "terasort-large.uniform"):
        names = set(run_small(cell)["metrics"])
        assert names == {m["name"] for m in MANIFEST["end_to_end"]
                         if cell in m.get("workloads", [cell])}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & set(harness.FORBIDDEN), path
    for path in (BENCH / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "torch"}, path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sparkrdma_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib.xla"]


def _run(args, cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_no_card_exits_with_one_line(tmp_path):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    done = _run(["benchmarks/run.py", "--workload", "tpcds-sf1.q95",
                 "--seed", "3", "--seconds", "1", "--trace", "0"], ROOT)
    assert done.returncode != 0
    assert done.stdout == ""
    assert done.stderr.strip().splitlines() == [
        "benchmark: needs 1 CUDA card(s); found 0"]


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(["benchmarks/run.py", "--workload", "tpcds-sf1.q95",
                 "--seed", "3", "--seconds", "1", "--trace", "0"], tmp_path)
    assert done.returncode != 0 and done.stdout == ""


def test_a_cell_added_as_files_is_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.load_config("terasort-hibench-large")
    cfg.update(records=8 * 1000, rows_per_device=1000)
    (tmp_path / "benchmarks/configs/terasort-tiny.json").write_text(
        json.dumps(cfg))
    work = dict(harness.load_workload("terasort-large.uniform"),
                config="terasort-tiny", sample_from_first=2)
    (tmp_path / "benchmarks/workloads/terasort-tiny.uniform.json"
     ).write_text(json.dumps(work))
    script = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from benchmarks import harness\n"
        "assert harness.BENCH.parent.samefile(sys.argv[1])\n"
        "r = harness.run_cell('terasort-tiny.uniform', 5, 0.2, False, "
        "started=0.0, device='cpu', log=lambda line: None)\n"
        "print(r['correct'], r['attempted'])\n")
    done = _run(["-c", script, str(tmp_path), str(ROOT)], tmp_path)
    assert done.returncode == 0, done.stderr
    correct, attempted = done.stdout.split()
    assert correct == "True" and int(attempted) > 0


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = _run(["benchmarks/run.py", "--workload", "tpcds-sf1.q95",
                 "--seed", "3", "--seconds", "1", "--trace", "1"], ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
