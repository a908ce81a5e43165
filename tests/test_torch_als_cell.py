"""The benchmark's ALS cell (``als-netflix.mllib-iteration``:
``benchmarks/jobs/als.py``) on the CPU.

The job's byte counts by hand at the Netflix Prize's counts; the Zipf
exponents against the popularity they were fitted to; and the cell at a
small size through the harness: the program passes its check, and one
entity's altered factor and each of the job's three controls (the normal
equations summed in bfloat16, the unweighted ``reg * I``, the most-rated
item's ratings lost once) make it fail."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks import harness
from benchmarks.jobs import als as job
from benchmarks.reference import als as reference

CELL = "als-netflix.mllib-iteration"


def test_als_bytes_by_hand():
    cfg = harness.load_config("als-netflix-mllib")
    assert job.input_bytes(cfg) == 1_205_766_084 + 19_207_560
    assert job.exchange_bytes(cfg) == 2 * 2 * 100_480_507 * 12
    # per half-step: 100,480,507 rows x (40 B factor + 4 B rating + 4 B
    # id), then 17,770 items or 480,189 users x 4 x (100 + 10) B
    assert job.gram_bytes(cfg) == (2 * 100_480_507 * 48
                                   + (17_770 + 480_189) * 440)
    assert round(job.gram_bytes(cfg) / 1e9, 2) == 9.87
    assert cfg["shards"] * cfg["rows_per_shard"] - cfg["ratings"] == 3


@pytest.mark.parametrize("side,share", [("items", 0.0023),
                                        ("users", 17_600 / 100_480_507)])
def test_zipf_exponents_give_the_fitted_top(side, share):
    """The most-rated item's share (0.23%, ~231k ratings) and the most
    active user's (~17.6k ratings) under the configuration's exponents."""
    cfg = harness.load_config("als-netflix-mllib")
    exponent = cfg["item_zipf" if side == "items" else "user_zipf"]
    weights = np.arange(1, cfg[side] + 1, dtype=np.float64) ** -exponent
    assert weights[0] / weights.sum() == pytest.approx(share, rel=1e-3)


def test_drawn_ratings_follow_the_configuration():
    cfg = _small()[1]
    got = job.make_inputs(cfg, 2**33 + 7, "cpu")
    again = job.make_inputs(cfg, 2**33 + 7, "cpu")
    rows = got["ratings"]
    assert rows.shape == (10, cfg["rows_per_shard"], 3)
    assert torch.equal(rows, again["ratings"])
    flat = rows.reshape(-1, 3)
    live = flat[:cfg["ratings"]]
    assert (flat[cfg["ratings"]:] == -1).all()
    assert live[:, 0].min() >= 0 and live[:, 0].max() < cfg["items"]
    assert live[:, 1].min() >= 0 and live[:, 1].max() < cfg["users"]
    stars = live[:, 2].view(torch.float32)
    assert set(stars.unique().tolist()) == {1.0, 2.0, 3.0, 4.0, 5.0}
    assert len(got["inits"]) == job.INIT_SETS
    for init in got["inits"]:
        assert init.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(init, axis=1), 1,
                                   rtol=1e-6)


# -- the cell through the harness, at a small size --------------------------

def _small():
    work = dict(harness.load_workload(CELL), warmup_jobs=1, trace_jobs=2)
    cfg = harness.load_config(work["config"])
    n = 6_003
    cfg.update(ratings=n, users=300, items=120, rows_per_shard=-(-n // 10),
               quota=64)
    return work, cfg


def _run(seed: int, control=False) -> dict:
    work, cfg = _small()
    return harness.run_cell(CELL, seed, 1.0, False, started=0.0,
                            device="cpu", work=work, cfg=cfg,
                            control=control, log=lambda line: None)


@pytest.fixture(autouse=True)
def _first_jobs(monkeypatch):
    """The check samples the window's first two jobs, which a short CPU
    window always holds: a job takes tens of ms on one thread (the
    benchmark's runs take two), where many threads on a loaded host can
    stall one for seconds."""
    monkeypatch.setattr(job, "AMONG", 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_program_passes_the_check():
    result = _run(41)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert result["checks"]["factors_wrong"]["value"] == 0
    assert result["checks"]["jobs_missing"]["value"] == 0


def _wrap_step(monkeypatch, around) -> None:
    real = job._port_step

    def make(*args, **kwargs):
        step, transport = real(*args, **kwargs)
        return (lambda *inputs: around(step, *inputs)), transport
    monkeypatch.setattr(job, "_port_step", make)


def test_an_altered_factor_makes_the_run_incorrect(monkeypatch):
    def altered(step, ratings, users):
        items, users = step(ratings, users)
        users[7] *= 1.001
        return items, users
    _wrap_step(monkeypatch, altered)
    result = _run(43)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["factors_wrong"]["value"] == 2  # both jobs


@pytest.mark.parametrize("control", sorted(job.CONTROLS))
def test_control_fails_the_check(control):
    result = _run(47, control=control)
    assert result["correct"] is False
    assert result["checks"]["factors_wrong"]["value"] > 0


def test_the_reference_skips_pad_rows_and_drops_the_top_item():
    work, cfg = _small()
    rows = job.make_inputs(cfg, 9, "cpu")["ratings"]
    users = torch.from_numpy(job.make_inputs(cfg, 9, "cpu")["inits"][0])
    top = reference.most_rated_item(rows, cfg["items"])
    items = rows.reshape(-1, 3)[:cfg["ratings"], 0]
    assert int((items == top).sum()) == int(torch.bincount(items).max())
    kept = reference.half_step(rows, users, key_col=0, num_out=cfg["items"],
                               reg=0.1)
    lost = reference.half_step(rows, users, key_col=0, num_out=cfg["items"],
                               reg=0.1, drop_item=top)
    assert lost[top].abs().sum() == 0 and kept[top].abs().sum() > 0
    others = torch.arange(cfg["items"]) != top
    assert torch.equal(lost[others], kept[others])
