"""Small shapes of each cell for the CPU tests: the cell's own files with
a few sizes cut, so that a run takes well under a second here."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import harness  # noqa: E402

SMALL = {
    "terasort-large.uniform": (
        {"sample_from_first": 3},
        {"rows_per_device": 1500}),
    "tpcds-sf10.q95": (
        {},
        {"web_sales_rows": 24003, "ws_rows_per_device": 3001,
         "orders": 2000, "customer_address_rows": 400, "states": 3,
         "target_state": 1, "companies": 2, "web_site_rows": 7,
         "ship_span_days": 200, "window_start_day": 35850}),
    "tpcds-sf1.q95": (
        {},
        {"web_sales_rows": 16000, "ws_rows_per_device": 2000,
         "orders": 1500, "customer_address_rows": 300, "states": 3,
         "target_state": 2, "companies": 2, "web_site_rows": 6,
         "ship_span_days": 150, "window_start_day": 35830}),
}
CELLS = sorted(SMALL)


def small(cell: str) -> tuple[dict, dict]:
    """``(workload, config)`` of ``cell`` at a CPU test's size."""
    work_cut, cfg_cut = SMALL[cell]
    work = dict(harness.load_workload(cell), **work_cut)
    return work, dict(harness.load_config(work["config"]), **cfg_cut)


def run_small(cell: str, seed: int = 7, trace: bool = False,
              control: bool = False, seconds: float = 0.2) -> dict:
    """One run of ``cell`` on the CPU at its small size."""
    work, cfg = small(cell)
    return harness.run_cell(cell, seed, seconds, trace, started=0.0,
                            device="cpu", work=work, cfg=cfg,
                            control=control, log=lambda line: None)


@pytest.fixture(params=CELLS)
def cell(request) -> str:
    return request.param
