"""TPC-DS q95 jobs: the port's ``make_q95_step`` over one set of tables.

The tables are made on the device from the seed, at the configuration's
row counts: a frozen copy of the port's ``generate_q95`` (uniform orders,
warehouses, addresses, sites and amounts; a fixed share of orders
returned; dimension keys ``0..rows-1``), with ship dates drawn over the
configuration's span, each table padded with dead rows to a multiple of
the shards. Every job's per-shard partials come back to the host and are
checked.
"""

from __future__ import annotations

import torch

from benchmarks.reference import q95 as reference

PAD = -1  # 0xFFFFFFFF as an int32 word
WS_WORDS = 7


def _padded(rows: int, shards: int) -> int:
    return -(-rows // shards) * shards


def _returned(cfg: dict) -> int:
    return int(cfg["orders"] * cfg["returned_order_fraction"])


def _tables(cfg: dict):
    """(name, real rows, words) of each table the step takes, in order."""
    return (("ws", cfg["web_sales_rows"], WS_WORDS),
            ("wr", _returned(cfg), 1),
            ("date", cfg["date_dim_rows"], 2),
            ("addr", cfg["customer_address_rows"], 2),
            ("site", cfg["web_site_rows"], 2))


def input_bytes(cfg: dict) -> int:
    """The tables handed to the port, as int32 words, without padding."""
    return sum(rows * words * 4 for _, rows, words in _tables(cfg))


def exchange_bytes(cfg: dict) -> int:
    """Rows the step's eight exchanges route (dead rows too), each read
    once and written once: web_sales with its flags word in each of the
    three dimension joins and the co-location by order, and each of the
    four other tables once."""
    d = cfg["shards"]
    words = sum(_padded(rows, d) * w for name, rows, w in _tables(cfg)
                if name != "ws")
    words += 4 * _padded(cfg["web_sales_rows"], d) * (WS_WORDS + 1)
    return 2 * 4 * words


def _shard(table: torch.Tensor, shards: int) -> torch.Tensor:
    rows = _padded(len(table), shards)
    pad = torch.full((rows - len(table), table.shape[1]), PAD,
                     dtype=torch.int32, device=table.device)
    return torch.cat([table.to(torch.int32), pad]).reshape(
        shards, rows // shards, table.shape[1])


def make_inputs(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    n = cfg["web_sales_rows"]

    def draw(high: int, low: int = 0) -> torch.Tensor:
        return torch.randint(low, high, (n,), generator=gen, device=device)

    first = cfg["ship_first_day"]
    ws = torch.stack([
        draw(cfg["orders"]),
        draw(cfg["warehouse_rows"]),
        draw(first + cfg["ship_span_days"], first),
        draw(cfg["customer_address_rows"]),
        draw(cfg["web_site_rows"]),
        draw(cfg["max_cost"]),
        draw(cfg["max_profit"]),
    ], dim=1)
    returned = torch.randperm(cfg["orders"], generator=gen, device=device)
    wr = returned[:_returned(cfg)].sort().values.reshape(-1, 1)

    def dim(rows: int, modulus: int = 0) -> torch.Tensor:
        keys = torch.arange(rows, device=device)
        return torch.stack([keys, keys % modulus if modulus else keys], 1)

    d = cfg["shards"]
    return {"ws": _shard(ws, d), "wr": _shard(wr, d),
            "date": _shard(dim(cfg["date_dim_rows"]), d),
            "addr": _shard(dim(cfg["customer_address_rows"], cfg["states"]),
                           d),
            "site": _shard(dim(cfg["web_site_rows"], cfg["companies"]), d)}


def _reference(cfg: dict, inputs: dict, semi_joins: bool = True):
    return reference.q95(
        inputs["ws"], inputs["wr"], inputs["date"], inputs["addr"],
        inputs["site"], window_start=cfg["window_start_day"],
        window_days=cfg["window_days"], target_state=cfg["target_state"],
        target_company=cfg["target_company"], shards=cfg["shards"],
        semi_joins=semi_joins)


def _port_step(cfg: dict, device):
    from sparkrdma_tpu_torch.models import tpcds_queries as port
    from sparkrdma_tpu_torch.parallel.exchange import resolve_transport
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    if cfg["window_days"] != 60:
        raise ValueError("the port's q95 ships within a 60-day window")
    mesh = VirtualMesh(cfg["shards"], device)
    step = port.make_q95_step(mesh, port.Q95Config(
        ws_rows_per_device=_padded(cfg["web_sales_rows"], cfg["shards"])
        // cfg["shards"],
        num_orders=cfg["orders"],
        num_warehouses=cfg["warehouse_rows"],
        num_dates=cfg["date_dim_rows"],
        window_start=cfg["window_start_day"],
        num_states=cfg["states"], target_state=cfg["target_state"],
        num_sites=cfg["web_site_rows"], num_companies=cfg["companies"],
        target_company=cfg["target_company"],
        return_fraction=cfg["returned_order_fraction"],
        out_factor=cfg["out_factor"]), impl="auto")
    return step, resolve_transport(mesh, "auto")


def _control_step(cfg: dict):
    """The reference in the program's place, its semi-joins made inner
    joins."""
    def step(ws, wr, date, addr, site):
        tables = {"ws": ws, "wr": wr, "date": date, "addr": addr,
                  "site": site}
        partial = _reference(cfg, tables, semi_joins=False)
        return (partial.to(torch.int32),
                torch.zeros(cfg["shards"], dtype=torch.bool,
                            device=ws.device))
    return step


class Cell:
    """One run's q95: tables, the entry, every job's partials."""

    def __init__(self, cfg: dict, work: dict, seed: int, device,
                 control: bool = False):
        self.cfg = cfg
        self.inputs = make_inputs(cfg, seed, device)
        if control:
            self.step, self.transport = _control_step(cfg), "control"
        else:
            self.step, self.transport = _port_step(cfg, device)

    def submit(self):
        i = self.inputs
        return self.step(i["ws"], i["wr"], i["date"], i["addr"], i["site"])

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
        want = _reference(self.cfg, self.inputs).cpu()
        wrong = sum(int((torch.from_numpy(r["partial"]).to(torch.int64)
                         != want).sum()) for r in records)
        return {
            "partials_wrong": (wrong, 0),
            "jobs_overflowed": (sum(r["overflowed"] for r in records), 0),
            "orders_answered": (int(want[:, 0].sum()), None),
        }
