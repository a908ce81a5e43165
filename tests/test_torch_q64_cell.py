"""q64 past the 16-bit key convention, and the benchmark's q64 cell
(``tpcds-sf10.q64``: ``benchmarks/jobs/q64.py``) on the CPU.

The port's ``make_q64_step`` with item keys past 2**16 and tickets and
orders past 2**20 against the numpy oracle and the cell's plain reference
(``benchmarks/reference/q64.py``), where the 16-bit pair key would fold
pairs together; the job's byte counts by hand at SF10; and the cell at a
small size through the harness: the program passes its check, and three
planted faults (the pair key truncated to 16 + 16 bits, one returned
ticket dropped, one shard's partial altered) and each of the job's three
controls make it fail."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks import harness
from benchmarks.jobs import q64 as job
from benchmarks.reference import q64 as reference
from sparkrdma_tpu_torch.models import tpcds_queries as tq
from sparkrdma_tpu_torch.ops import hash_lookup
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import MASK, rows_from_numpy, to_u64

D = 8
CELL = "tpcds-sf10.q64"
SMALL = tq.Q64Config(ss_rows_per_device=400, cs_rows_per_device=300,
                     num_items=3000, out_factor=4)
ITEM_BASE = 70_000      # past 2**16
TICKET_BASE = 1 << 20   # tickets and orders past 2**20


def _wide_tables(seed: int) -> tuple:
    """``generate_q64`` tables with every item moved past 2**16 and every
    ticket and order spread past 2**20 (each key's map one to one, so
    pairs stay unique and returns keep their sales' pairs)."""
    ss, sr, cs, cr, date = (t.copy() for t in tq.generate_q64(SMALL, D,
                                                               seed))
    for table in (ss, sr, cs, cr):
        table[:, 0] += ITEM_BASE
        table[:, 1] = (table[:, 1] << 6) + TICKET_BASE
    return ss, sr, cs, cr, date


@pytest.mark.parametrize("impl", ["gather", "native"])
def test_step_past_16_bits_matches_the_oracle_and_reference(impl):
    tables = _wide_tables(5)
    mesh = VirtualMesh(D, "cpu")
    staged = [rows_from_numpy(tq.pad_rows_to_devices(t, D), mesh)
              for t in tables]
    partial, overflowed = tq.make_q64_step(mesh, SMALL, impl)(*staged)
    assert not overflowed.any()
    want = tq.numpy_q64_by_shard(*tables, SMALL, D)
    assert want[:, 0].sum() > 0, "degenerate q64: no qualifying items"
    np.testing.assert_array_equal(partial.numpy().astype(np.int64), want)
    ref = reference.q64(*staged, shards=D)
    np.testing.assert_array_equal(ref.numpy(), want)
    # the keys outgrow the 16-bit pair key: it folds pairs together, and
    # the plan joined on it answers otherwise
    ss = tables[0]
    assert len(np.unique(tq._pairkey(ss[:, 0], ss[:, 1]))) < len(ss)
    folded = reference.q64(*staged, shards=D, pair_bits=16)
    assert not torch.equal(folded, ref)


def test_pair64_is_exact_and_dead_rows_take_the_sentinel():
    from sparkrdma_tpu_torch.utils.u32 import SENTINEL64

    words = np.array([[0, 0], [1, 0xFFFFFFFF], [0x7FFFFFFE, 0xFFFFFFFF],
                      [0xFFFFFFFF, 0xFFFFFFFF], [102_000, 28_800_990]],
                     np.uint32)
    cols = torch.from_numpy(words.view(np.int32))
    got = hash_lookup.pair64(cols[:, 0], cols[:, 1]).tolist()
    assert got[0] == 0 and got[1] == (1 << 32) + MASK
    assert got[2] == (0x7FFFFFFE << 32) + MASK < SENTINEL64
    assert got[3] == SENTINEL64
    assert got[4] == (102_000 << 32) + 28_800_990
    # the route key is the JAX package's u32 pair key, a function of the
    # pair alone
    route = tq._pairkey(to_u64(torch.from_numpy(words[:, 0].view(np.int32))),
                        to_u64(torch.from_numpy(words[:, 1].view(np.int32))))
    np.testing.assert_array_equal(route.numpy(),
                                  tq._pairkey(words[:, 0], words[:, 1]))


def test_generator_refuses_keys_past_their_words():
    with pytest.raises(ValueError):
        tq.generate_q64(tq.Q64Config(ss_rows_per_device=8,
                                     cs_rows_per_device=8,
                                     num_items=1 << 31), D)


def test_q64_bytes_by_hand():
    cfg = harness.load_config("tpcds-sf10-q64")
    assert job.input_bytes(cfg) == 4 * (28_800_991 * 4 + 2_875_432 * 2
                                        + 14_401_261 * 3 + 1_439_749 * 3
                                        + 73_049 * 2)
    # days 0..73048, year = day % 3: 24,350 + 24,350 of them in Y or Y+1
    years = round(2_875_432 * 48_700 / 73_049)
    words = (2 * 14_401_264 * 3 + 1_439_752 * 3 + 28_800_992 * 4
             + 2_875_432 * 2 + 73_056 * 2 + 2_875_432 * 4 + years * 3)
    assert job.exchange_bytes(cfg) == 2 * 4 * words


# -- the cell through the harness, at a small size --------------------------

def _small():
    work = dict(harness.load_workload(CELL), warmup_jobs=1, trace_jobs=2)
    cfg = harness.load_config(work["config"])
    ss, cs = 72_003, 36_001  # tickets past 2**16, dead rows to pad
    cfg.update(store_sales_rows=ss, ss_rows_per_device=-(-ss // D),
               store_returns_rows=int(ss * cfg["sr_fraction"]),
               catalog_sales_rows=cs, cs_rows_per_device=-(-cs // D),
               catalog_returns_rows=int(cs * cfg["cr_fraction"]))
    return work, cfg


def _run(seed: int, control=False) -> dict:
    work, cfg = _small()
    return harness.run_cell(CELL, seed, 0.2, False, started=0.0,
                            device="cpu", work=work, cfg=cfg,
                            control=control, log=lambda line: None)


def test_program_passes_the_check():
    result = _run(41)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["partials_wrong"]["value"] == 0


def _truncated_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return ((to_u64(hi) & 0xFFFF) << 16) | (to_u64(lo) & 0xFFFF)


def _a_return_that_counts(seed: int) -> int:
    """A store_returns row whose loss changes the answer."""
    _, cfg = _small()
    inputs = job.make_inputs(cfg, seed, "cpu")
    tables = [inputs[k] for k in ("ss", "sr", "cs", "cr", "date")]
    want = reference.q64(*tables, shards=D)
    for row in range(cfg["store_returns_rows"]):
        sr = tables[1].clone()
        sr.view(-1, 2)[row] = -1
        if not torch.equal(reference.q64(tables[0], sr, *tables[2:],
                                         shards=D), want):
            return row
    raise AssertionError("no store return changes the answer")


def _wrap_step(monkeypatch, around) -> None:
    real = tq.make_q64_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda *tables: around(step, *tables)
    monkeypatch.setattr(tq, "make_q64_step", make)


@pytest.mark.parametrize("fault", ["pair_truncated", "return_dropped",
                                   "partial_altered"])
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    seed = 43
    if fault == "pair_truncated":
        monkeypatch.setattr(hash_lookup, "pair64", _truncated_pair)
    elif fault == "return_dropped":
        row = _a_return_that_counts(seed)

        def dropped(step, ss, sr, *rest):
            sr = sr.clone()
            sr.view(-1, 2)[row] = -1
            return step(ss, sr, *rest)
        _wrap_step(monkeypatch, dropped)
    else:
        def altered(step, *tables):
            partial, overflowed = step(*tables)
            partial[0, 1] += 1
            return partial, overflowed
        _wrap_step(monkeypatch, altered)
    result = _run(seed)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["partials_wrong"]["value"] > 0


@pytest.mark.parametrize("control", sorted(job.CONTROLS))
def test_control_fails_the_check(control):
    result = _run(47, control=control)
    assert result["correct"] is False
    assert result["checks"]["partials_wrong"]["value"] > 0
