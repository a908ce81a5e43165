"""A whole run on the CPU with the timed path broken underneath: each
fault a cell can have makes ``correct`` come out false.

The faults are planted in the port's own functions: the CPU transport
(``gather``) and the step builders the job modules call."""

from __future__ import annotations

import pytest
import torch

from conftest import CELLS, run_small


def _exchange_half(real):
    def broken(data, mat, output, *args):
        return real(data, mat // 2, output, *args)
    return broken


def _exchange_left_out(real):
    def broken(data, mat, output, *args):
        out = output.clone()
        n = min(data.shape[1], out.shape[1])
        out[:, :n] = data[:, :n]  # every shard keeps its own rows
        return out
    return broken


def _wrap_step(module, name: str, after):
    real = getattr(module, name)

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(*inputs):
            return after(inputs, step(*inputs))
        return broken
    return make


def _terasort_unchanged(inputs, result):
    out, counts, overflowed = result
    rows = inputs[0]
    same = torch.zeros_like(out)
    same[:, :rows.shape[1]] = rows  # the input handed back unsorted
    return same, counts, overflowed


def _terasort_altered(inputs, result):
    out, counts, overflowed = result
    out[0, 0, 1] ^= 1  # one payload bit of one row
    return out, counts, overflowed


def _q95_altered(inputs, result):
    partial, overflowed = result
    partial[0, 1] += 1  # one shard's cost sum
    return partial, overflowed


def _plant(monkeypatch, fault: str, cell: str) -> None:
    from sparkrdma_tpu_torch.models import terasort, tpcds_queries
    from sparkrdma_tpu_torch.parallel import exchange

    if fault == "half_the_rows":
        monkeypatch.setattr(exchange, "_gather_exchange",
                            _exchange_half(exchange._gather_exchange))
    elif fault == "exchange_left_out":
        monkeypatch.setattr(exchange, "_gather_exchange",
                            _exchange_left_out(exchange._gather_exchange))
    elif fault == "output_unchanged":
        monkeypatch.setattr(terasort, "make_terasort_step", _wrap_step(
            terasort, "make_terasort_step", _terasort_unchanged))
    elif cell.startswith("terasort"):
        monkeypatch.setattr(terasort, "make_terasort_step", _wrap_step(
            terasort, "make_terasort_step", _terasort_altered))
    else:
        monkeypatch.setattr(tpcds_queries, "make_q95_step", _wrap_step(
            tpcds_queries, "make_q95_step", _q95_altered))


FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("half_the_rows", "exchange_left_out",
                        "answer_altered")
          ] + [("terasort-large.uniform", "output_unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    _plant(monkeypatch, fault, cell)
    result = run_small(cell, seed=31)
    assert result["correct"] is False, result["checks"]
