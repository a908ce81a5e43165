"""Each job kind at a small size on a CPU mesh: the port's output equals
the plain reference, the check catches a planted fault, the control fails
the check, and each job's byte counts are the hand counts."""

from __future__ import annotations

import torch

from benchmarks import harness
from benchmarks.reference import q95 as q95_reference
from benchmarks.reference import terasort as terasort_reference

from conftest import run_small, small


def _cell_and_jobs(cell: str, jobs: int = 3):
    work, cfg = small(cell)
    job = harness.load_job(work["job"])
    c = job.Cell(cfg, work, 11, torch.device("cpu"))
    records = []
    for index in range(jobs):
        result = c.submit()
        records.append(c.finish(index, result, c.fetch(result)))
    return c, records


def test_port_matches_reference_terasort():
    c, records = _cell_and_jobs("terasort-large.uniform")
    rows, counts = terasort_reference.terasort(c.inputs["rows"], 8)
    assert len(c.kept) >= 1
    for out, got_counts in c.kept.values():
        assert torch.equal(got_counts.to(torch.int64), counts)
        start = 0
        for s, total in enumerate(counts.sum(dim=1).tolist()):
            assert torch.equal(out[s, :total], rows[start:start + total])
            start += total
        assert start == 8 * 1500
    assert all(torch.equal(torch.from_numpy(r["counts"]).to(torch.int64),
                           counts)
               for r in records)


def test_port_matches_reference_q95(cell):
    if not cell.endswith("q95"):
        return
    c, records = _cell_and_jobs(cell)
    want = c.check(records)
    assert want["partials_wrong"] == (0, 0)
    assert want["orders_answered"][0] > 20  # the small data answers
    ref = q95_reference.q95(
        c.inputs["ws"], c.inputs["wr"], c.inputs["date"], c.inputs["addr"],
        c.inputs["site"], window_start=c.cfg["window_start_day"],
        window_days=60, target_state=c.cfg["target_state"],
        target_company=c.cfg["target_company"], shards=8)
    assert all(torch.equal(torch.from_numpy(r["partial"]).to(torch.int64),
                           ref)
               for r in records)


def test_check_catches_swapped_and_dropped_rows():
    c, records = _cell_and_jobs("terasort-large.uniform")
    out, counts = next(iter(c.kept.values()))
    out[0, [3, 4]] = out[0, [4, 3]]  # two rows swapped
    assert c.check(records)["rows_wrong"][0] == 2
    out[0, [3, 4]] = out[0, [4, 3]]
    out[1, 5:-1] = out[1, 6:].clone()  # a row dropped, the rest moved up
    assert c.check(records)["rows_wrong"][0] > 0


def test_check_catches_a_dropped_line_q95():
    c, records = _cell_and_jobs("tpcds-sf1.q95")
    ws = c.inputs["ws"]
    qualifying = q95_reference.q95(
        ws, c.inputs["wr"], c.inputs["date"], c.inputs["addr"],
        c.inputs["site"], window_start=c.cfg["window_start_day"],
        window_days=60, target_state=c.cfg["target_state"],
        target_company=c.cfg["target_company"], shards=8)
    assert qualifying[:, 0].sum() > 0
    # the port's partials held against the tables with shard 0's lines
    # dropped
    ws[0] = -1
    assert c.check(records)["partials_wrong"][0] > 0


def test_control_fails_the_check(cell):
    result = run_small(cell, seed=23, control=True)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_program_passes_the_check(cell):
    result = run_small(cell, seed=29)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def test_terasort_bytes_by_hand():
    from benchmarks.jobs import terasort

    cfg = harness.load_config("terasort-hibench-large")
    assert terasort.input_bytes(cfg) == 32_000_000 * 100
    assert terasort.exchange_bytes(cfg) == 2 * 32_000_000 * 100


def test_q95_bytes_by_hand():
    from benchmarks.jobs import q95

    cfg = harness.load_config("tpcds-sf10")
    returned = int(600_000 * 0.72)
    assert q95.input_bytes(cfg) == 4 * (7_197_566 * 7 + returned
                                        + 2 * (73_049 + 250_000 + 42))
    # eight exchanges, dead pad rows routed too: web_sales (8 words with
    # its flags) four times; returns, dates, addresses and sites once
    words = (4 * 7_197_568 * 8 + 432_000 * 1 + 73_056 * 2
             + 250_000 * 2 + 48 * 2)
    assert q95.exchange_bytes(cfg) == 2 * 4 * words
