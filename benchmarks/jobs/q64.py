"""TPC-DS q64 jobs: the port's ``make_q64_step`` over one set of tables.

The tables are made once, on the host, by the port's own ``generate_q64``
from the seed at the configuration's dsdgen row counts (Zipf-skewed
items, tickets and orders unique row indices, returns a share of the
sales' lines), each padded with dead rows to a multiple of the shards and
staged to the device. Every job's per-shard partials come back to the host
and are checked against ``reference/q64.py``.

The controls put the reference in the program's place with one of the
plan's guarantees broken (``CONTROLS``); ``control=True`` takes the
first. All three on a few seeds:

    python -m benchmarks.jobs.q64 --seconds 3 --seed 1 2 3
"""

from __future__ import annotations

import time

import torch

from benchmarks.reference import q64 as reference

# reference keywords of each control: the parent's u32 pair key, the
# store join on item alone, cs_ui without its HAVING
CONTROLS = {"pairkey16": {"pair_bits": 16},
            "store_semi_join_on_item": {"store_join_on_item": True},
            "no_having": {"having": False}}


def _padded(rows: int, shards: int) -> int:
    return -(-rows // shards) * shards


def _tables(cfg: dict):
    """(name, real rows, words) of each table the step takes, in order."""
    return (("ss", cfg["store_sales_rows"], 4),
            ("sr", cfg["store_returns_rows"], 2),
            ("cs", cfg["catalog_sales_rows"], 3),
            ("cr", cfg["catalog_returns_rows"], 3),
            ("date", cfg["date_dim_rows"], 2))


def input_bytes(cfg: dict) -> int:
    """The tables handed to the port, as int32 words, without padding."""
    return sum(rows * words * 4 for _, rows, words in _tables(cfg))


def _years_share(cfg: dict) -> float:
    """The share of date_dim's days in year Y or Y+1 (``(day + mod) % 3 <=
    1``), over which sold dates are drawn uniformly."""
    days = cfg["date_dim_rows"]
    return sum((d + cfg["first_year_mod"]) % 3 <= 1
               for d in range(days)) / days


def exchange_bytes(cfg: dict) -> int:
    """Rows the step's eight exchanges route, each read once and written
    once: every table once with its dead rows (the pair joins' four,
    date_dim), catalog_sales again by item, the store lines with a return
    by date, and those of years Y and Y+1 by item. That last count depends
    on the drawn dates and enters at its expectation, a few hundredths of
    a percent from the count on the card."""
    d = cfg["shards"]
    words = sum(_padded(rows, d) * w for _, rows, w in _tables(cfg))
    words += _padded(cfg["catalog_sales_rows"], d) * 3
    returned = cfg["store_returns_rows"]
    words += returned * 4 + round(returned * _years_share(cfg)) * 3
    return 2 * 4 * words


def _port_config(cfg: dict, ss_rows: int, cs_rows: int):
    from sparkrdma_tpu_torch.models.tpcds_queries import Q64Config

    return Q64Config(ss_rows_per_device=ss_rows, cs_rows_per_device=cs_rows,
                     num_items=cfg["num_items"], num_dates=cfg["num_dates"],
                     first_year_mod=cfg["first_year_mod"],
                     sr_fraction=cfg["sr_fraction"],
                     cr_fraction=cfg["cr_fraction"], zipf_a=cfg["zipf_a"],
                     out_factor=cfg["out_factor"])


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The port's ``generate_q64`` tables at the dsdgen counts, padded
    to ``[shards, rows, words]`` int32 on ``device``."""
    from sparkrdma_tpu_torch.models import tpcds_queries as port

    d = cfg["shards"]
    tables = port.generate_q64(_port_config(
        cfg, cfg["store_sales_rows"], cfg["catalog_sales_rows"]), 1, seed)
    inputs = {}
    for (name, rows, words), table in zip(_tables(cfg), tables):
        if table.shape != (rows, words):
            raise ValueError(f"{name}: {table.shape} made, the "
                             f"configuration has {(rows, words)}")
        padded = port.pad_rows_to_devices(table, d).view("<i4")
        inputs[name] = torch.from_numpy(padded).reshape(
            d, -1, words).to(device)
    return inputs


def _args(inputs: dict) -> tuple:
    return tuple(inputs[name] for name in ("ss", "sr", "cs", "cr", "date"))


def _port_step(cfg: dict, device):
    from sparkrdma_tpu_torch.models import tpcds_queries as port
    from sparkrdma_tpu_torch.parallel.exchange import resolve_transport
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    d = cfg["shards"]
    for rows, per in (("store_sales_rows", "ss_rows_per_device"),
                      ("catalog_sales_rows", "cs_rows_per_device")):
        if _padded(cfg[rows], d) != cfg[per] * d:
            raise ValueError(f"{per} {cfg[per]} does not hold {rows} "
                             f"{cfg[rows]} over {d} shards")
    mesh = VirtualMesh(d, device)
    step = port.make_q64_step(mesh, _port_config(
        cfg, cfg["ss_rows_per_device"], cfg["cs_rows_per_device"]),
        impl="auto")
    return step, resolve_transport(mesh, "auto")


def _control_step(cfg: dict, kind: str):
    """The reference in the program's place, one guarantee broken."""
    def step(*tables):
        partial = reference.q64(*tables, shards=cfg["shards"],
                                **CONTROLS[kind])
        return (partial.to(torch.int32),
                torch.zeros(cfg["shards"], dtype=torch.bool,
                            device=tables[0].device))
    return step


class Cell:
    """One run's q64: tables, the entry, every job's partials.
    ``control`` is False, True (the first control) or a control's name."""

    def __init__(self, cfg: dict, work: dict, seed: int, device,
                 control=False):
        self.cfg = cfg
        self.inputs = make_inputs(cfg, seed, device)
        if control:
            kind = next(iter(CONTROLS)) if control is True else control
            self.step, self.transport = _control_step(cfg, kind), "control"
        else:
            self.step, self.transport = _port_step(cfg, device)

    def submit(self):
        return self.step(*_args(self.inputs))

    @staticmethod
    def fetch(result) -> tuple:
        """Copies of the job's partials and overflow flags on their way
        to the host, not waited for."""
        return tuple(t.to("cpu", non_blocking=True) for t in result)

    def finish(self, index: int, result, host) -> dict:
        """The job's host result, copied out of the pinned buffers so
        that they are reused."""
        partial, overflowed = host
        return {"partial": partial.numpy().copy(),
                "overflowed": bool(overflowed.any())}

    def kept_bytes(self) -> int:
        return 0

    def release(self) -> None:
        self.step = None

    def check(self, records: list) -> dict:
        shards = self.cfg["shards"]
        want = reference.q64(*_args(self.inputs), shards=shards).cpu()
        wrong = sum(int((torch.from_numpy(r["partial"]).to(torch.int64)
                         != want).sum()) for r in records)
        i = self.inputs
        skew = reference.by_item_skew(i["ss"], i["sr"], i["cs"], i["date"],
                                      shards=shards)
        return {
            "partials_wrong": (wrong, 0),
            "jobs_overflowed": (sum(r["overflowed"] for r in records), 0),
            "items_answered": (int(want[:, 0].sum()), None),
            "by_item_max_over_mean": (skew, None),
        }


def main(argv=None) -> int:
    """Each control of the cell on each seed: the usual check must come
    out not correct. Exits 1 unless every run failed it."""
    import argparse
    import json

    from benchmarks import harness

    parser = argparse.ArgumentParser(description=main.__doc__.split(".")[0])
    parser.add_argument("--workload", default="tpcds-sf10.q64")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seed", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    caught = runs = 0
    for kind in CONTROLS:
        for seed in args.seed:
            result = harness.run_cell(args.workload, seed, args.seconds,
                                      False, started=time.perf_counter(),
                                      control=kind)
            runs += 1
            caught += not result["correct"]
            print(json.dumps({"control": kind, "seed": seed,
                              "correct": result["correct"],
                              "checks": result["checks"]}), flush=True)
    return 0 if caught == runs else 1


if __name__ == "__main__":
    raise SystemExit(main())
