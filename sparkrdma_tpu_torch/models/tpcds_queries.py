"""TPC-DS q95 and q64 as chained shuffles over the virtual mesh.

Port of the on-mesh half of ``sparkrdma_tpu/models/tpcds_queries.py``
(BASELINE.md config #4). ``models.tpcds`` covers the star class; this
module expresses the two named plans:

**q95**, web-sales shipping analysis: the ``ws_wh`` self-semi-join (orders
shipped from more than one warehouse), a semi-join against web_returns on
order_number, and dimension filters on date_dim (a 60-day ship window),
customer_address (state) and web_site (company); output
count(distinct order_number), sum(ext_ship_cost), sum(net_profit).

**q64**, cross-channel sales with both returns tables: ``cs_ui``
(catalog_sales joined to catalog_returns on (item, order), grouped by
item, HAVING sum(sales) > 2 * sum(refund)); store_sales joined to
store_returns on (item, ticket); date_dim on sold_date (two consecutive
years); a semi-join against cs_ui on item; per (item, year) aggregation
and the CTE self-joined across years (items where cnt(year+1) <=
cnt(year)); output count(qualifying items), sum(both years' price sums).

``make_q95_step`` / ``make_q64_step`` chain every shuffle inside one step
over all shards (on ``cuda`` each through the ring all-to-all kernel);
dimension joins are shuffle joins, heavier than Spark's broadcast hash
joins on purpose, because the exchange is the thing under test. Shapes
are static: selectivity travels as flag bits and validity masks, never
as data-dependent row counts. The steps return the JAX package's
per-shard partials (each order, and each item, is owned by exactly one
shard), which the runners sum on the host.

Key-space convention: keys are u32 words and ``PAD = 0xFFFFFFFF`` marks
dead rows. q95's orders fit 16 bits (``generate_q95``). q64's (item,
ticket) and (item, order) pairs are exact: item keys lie below 2**31 - 1
and tickets and orders anywhere in u32, and the pair joins look a pair up
on the rows' first two words (item high, key low; ``ops/hash_lookup.py``,
where a dead row's PAD item word is no key). They route a row by
``_pairkey``, the JAX package's u32 pair key ``item << 16 + key`` mod
2**32: exact below 2**16, so every row routes as the JAX step routes it
there, and above it a hash of the pair that both sides compute alike.
Arithmetic is the JAX package's: u32 values as zero-extended int64
(``utils.u32``), int32 sums summed in int64 and wrapped to int32, which
is the same modulo 2**32.

Per-segment reductions (the JAX ``segment_min/max/sum`` over key-sorted
rows) come from the sorted layout itself: a segment's sum is a difference
of prefix sums at its ends, and q95's "more than one warehouse" (JAX:
segment min != segment max) is a warehouse change inside an order's run
once rows are sorted by (order, warehouse). No scatter is involved, so a
hot key (q64's top item holds about a quarter of store sales) costs no
more than a cold one.

Every unique-key join (the dimension rounds, the semi-joins, the pair
joins) is ``ops/hash_lookup.py::hash_lookup`` on the received rows' own
key words, given a bound on the dimension rows from shapes (the rows that
side sent, or q64's item count); its flag joins the step's
``overflowed``.

The engine-DAG variants (``build_q95_job``, ``build_q64_job``) express
the same plans as stage DAGs of numpy tasks for ``engine.DAGEngine``;
with ``mesh=`` their shuffles ride the device plane. Their joins use the
host lookup ``_np_lookup`` the oracles use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.hash_lookup import (
    HIGH_LIMIT,
    hash_lookup,
    low_word,
)
from sparkrdma_tpu_torch.ops.partition import hash_partition
from sparkrdma_tpu_torch.ops.sort import sort_rows
from sparkrdma_tpu_torch.parallel.device_plane import stage_to_device
from sparkrdma_tpu_torch.parallel.exchange import (
    resolve_transport,
    shuffle_into,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import (
    MASK,
    SENTINEL,
    to_bits,
    to_u64,
)

PAD = np.uint32(0xFFFFFFFF)
_KEY_BITS = 16  # q95's order key space, and q64's route key (module docstring)
_ITEM_LIMIT = HIGH_LIMIT  # q64's item keys: a pair key's high word lies below


def _pairkey(a, b):
    """The u32 route key of (item, key) pairs, ``a << 16 + b`` mod
    2**32: numpy u32 arrays or zero-extended int64 tensors. Exact for
    16-bit keys (the JAX package's pair key), a hash of the pair past
    them."""
    if isinstance(a, torch.Tensor):
        return (a * (1 << _KEY_BITS) + b) & MASK
    return a * np.uint32(1 << _KEY_BITS) + b


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's range (two's complement wrap), as
    int64: what an int32 sum or product holds in the JAX package."""
    return ((x & MASK) ^ 0x80000000) - 0x80000000


# ---------------------------------------------------------------------------
# shared per-shard helpers ([D, N] tensors, every shard at once)
# ---------------------------------------------------------------------------


def _route(keys, valid, n: int):
    return torch.where(valid, hash_partition(keys, n), -1)


def _all(rows):
    return torch.ones(rows.shape[:2], dtype=torch.bool, device=rows.device)


def _sent(table: torch.Tensor) -> int:
    """``D * N`` of a ``[D, N, ...]`` table: the rows it sends when
    shuffled, a bound on the rows the shards receive from it, and so on a
    lookup's live dimension rows."""
    return table.shape[0] * table.shape[1]


def _dim_cap(rows_per_shard: int, n: int) -> int:
    """Receive capacity for a small broadcast-class table: ``rows * n``.
    One shard receiving EVERYTHING fits, and each (src, dst) pair's
    fixed slot ``cap // n = rows`` is all a source has, so no pair can
    overflow either."""
    return rows_per_shard * n


class _Segments:
    """The runs of equal keys in per-shard sorted keys ``[D, N]``: for
    each row, whether it starts its run (``first``) and the positions of
    its run's first and last rows (two binary searches of the row's own
    key). ``sum`` gives every row its whole run's sum.

    Prefix sums run over all shards' rows as ONE flat vector: a scan
    along dim 1 of a ``[D, N]`` tensor gets one thread block per row on
    the card (8 blocks for 8 shards), a flat one spreads over the whole
    card; a run never crosses a shard, so differences within a run are
    the same either way."""

    def __init__(self, sorted_keys: torch.Tensor):
        d, n = sorted_keys.shape
        dev = sorted_keys.device
        self.first = torch.cat(
            [torch.ones((d, 1), dtype=torch.bool, device=dev),
             sorted_keys[:, 1:] != sorted_keys[:, :-1]], dim=1)
        base = torch.arange(d, device=dev)[:, None] * n
        self._start = (torch.searchsorted(sorted_keys, sorted_keys)
                       + base).reshape(-1)
        self._end = (torch.searchsorted(sorted_keys, sorted_keys, right=True)
                     - 1 + base).reshape(-1)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """int64 sum over each row's run."""
        flat = values.to(torch.int64).reshape(-1)
        inclusive = torch.cumsum(flat, dim=0)
        run = inclusive[self._end] - (inclusive - flat)[self._start]
        return run.reshape(values.shape)


# ===========================================================================
# q95
# ===========================================================================


@dataclass(frozen=True)
class Q95Config:
    ws_rows_per_device: int
    num_orders: int            # < 2**16
    num_warehouses: int = 8
    num_dates: int = 365
    window_start: int = 40     # d_date in [start, start + 60)
    num_states: int = 16
    target_state: int = 3
    num_sites: int = 12
    num_companies: int = 4
    target_company: int = 1
    return_fraction: float = 0.4
    out_factor: int = 3


def generate_q95(cfg: Q95Config, num_devices: int, seed: int = 0):
    """(ws[N,7], wr[R,1], date[D,2], addr[A,2], site[S,2]) as u32, the
    same arrays as the JAX package's generator for the same seed.

    ws columns: order, warehouse, ship_date, ship_addr, site, cost,
    profit. Orders have several line items each (the self-semi-join
    needs real multi-row orders)."""
    assert cfg.num_orders < (1 << _KEY_BITS)
    rng = np.random.default_rng(seed)
    n_rows = cfg.ws_rows_per_device * num_devices
    order = rng.integers(0, cfg.num_orders, n_rows)
    ws = np.stack([
        order,
        rng.integers(0, cfg.num_warehouses, n_rows),
        rng.integers(0, cfg.num_dates, n_rows),
        rng.integers(0, cfg.num_states * 50, n_rows),
        rng.integers(0, cfg.num_sites, n_rows),
        rng.integers(0, 1000, n_rows),
        rng.integers(0, 1000, n_rows),
    ], axis=1).astype(np.uint32)
    returned = rng.permutation(cfg.num_orders)[
        : int(cfg.num_orders * cfg.return_fraction)]
    wr = np.sort(returned).astype(np.uint32).reshape(-1, 1)
    date = np.stack([np.arange(cfg.num_dates),
                     np.arange(cfg.num_dates)], axis=1).astype(np.uint32)
    addr = np.stack([np.arange(cfg.num_states * 50),
                     np.arange(cfg.num_states * 50) % cfg.num_states],
                    axis=1).astype(np.uint32)
    site = np.stack([np.arange(cfg.num_sites),
                     np.arange(cfg.num_sites) % cfg.num_companies],
                    axis=1).astype(np.uint32)
    return ws, wr, date, addr, site


def _np_lookup(dkeys, dattr, probes):
    """Vectorized unique-key join on the host: (attr[N], found[N])."""
    if len(dkeys) == 0:
        return np.zeros(len(probes), np.int64), np.zeros(len(probes), bool)
    order = np.argsort(dkeys, kind="stable")
    ks, at = dkeys[order], dattr[order].astype(np.int64)
    idx = np.clip(np.searchsorted(ks, probes), 0, len(ks) - 1)
    return at[idx], ks[idx] == probes


def _np_owner(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """The shard ``hash_partition`` routes each u32 key to."""
    return hash_partition(torch.from_numpy(keys.astype(np.int64)),
                          num_shards).numpy().astype(np.int64)


def numpy_q95_by_shard(ws, wr, date, addr, site, cfg: Q95Config,
                       num_shards: int) -> np.ndarray:
    """Oracle: ``int64[num_shards, 3]``, (distinct qualifying orders, sum
    cost, sum profit) of the orders each shard owns (``hash_partition``
    of the order key, the step's last routing). The JAX package's per-row
    loop, vectorised; dimension keys are unique."""
    dd, dd_found = _np_lookup(date[:, 0], date[:, 1], ws[:, 2])
    st, st_found = _np_lookup(addr[:, 0], addr[:, 1], ws[:, 3])
    co, co_found = _np_lookup(site[:, 0], site[:, 1], ws[:, 4])
    order = ws[:, 0]
    pairs = np.unique((order.astype(np.uint64) << np.uint64(32))
                      | ws[:, 1].astype(np.uint64))
    pair_orders, per_order = np.unique(pairs >> np.uint64(32),
                                       return_counts=True)
    multi = pair_orders[per_order > 1].astype(np.uint32)
    lo, hi = cfg.window_start, cfg.window_start + 60
    keep = (dd_found & (dd >= lo) & (dd < hi)
            & st_found & (st == cfg.target_state)
            & co_found & (co == cfg.target_company)
            & np.isin(order, multi) & np.isin(order, wr[:, 0]))
    out = np.zeros((num_shards, 3), np.int64)
    orders = np.unique(order[keep])
    out[:, 0] = np.bincount(_np_owner(orders, num_shards),
                            minlength=num_shards)
    owner = _np_owner(order[keep], num_shards)
    for col, src in ((1, 5), (2, 6)):
        np.add.at(out[:, col], owner, ws[keep, src].astype(np.int64))
    return out


def numpy_q95(ws, wr, date, addr, site, cfg: Q95Config
              ) -> Tuple[int, int, int]:
    """Oracle: (distinct qualifying orders, sum cost, sum profit)."""
    return tuple(int(x) for x in numpy_q95_by_shard(
        ws, wr, date, addr, site, cfg, 1)[0])


def make_q95_step(mesh: VirtualMesh, cfg: Q95Config, impl: str = "auto"):
    """q95 as chained shuffles in one step over every shard.

    Rounds 1-3 shuffle-join the three dimensions (date/addr/site),
    accumulating pass/fail as flag bits on the moving rows (column 7);
    round 4 co-locates web_sales and web_returns by order_number, where
    the multi-warehouse self-semi-join and the returns semi-join become
    per-order segment reductions. ``step(ws, wr, date, addr, site)`` takes
    ``int32[D, rows, W]`` u32 words (PAD-key rows dead) and returns
    per-shard partials ``(int32[D, 3], overflowed bool[D])``: host sums
    give the exact answer (each order lives on exactly one shard)."""
    n = mesh.num_shards
    impl = resolve_transport(mesh, impl)
    cap = cfg.ws_rows_per_device * cfg.out_factor
    lo, hi = cfg.window_start, cfg.window_start + 60

    def dim_round(rows, valid, key_col, dim, flag_bit, pred):
        """Shuffle-join one dimension; OR ``pred(attr) & found`` into the
        flags column (col 7); returns (rows, valid, overflowed)."""
        d_recv, d_valid, of_d = shuffle_into(
            dim, _route(dim[..., 0], _all(dim), n),
            _dim_cap(dim.shape[1], n), impl)
        f_recv, f_valid, of_f = shuffle_into(
            rows, _route(rows[..., key_col], valid, n), cap, impl)
        attr, found, of_l = hash_lookup(
            (d_recv[..., 0],), d_valid, d_recv[..., 1],
            (f_recv[..., key_col],), f_valid, _sent(dim))
        ok = found & pred(attr)
        f_recv[..., 7] |= torch.where(ok, flag_bit, 0).to(torch.int32)
        return f_recv, f_valid, of_d | of_f | of_l

    def step(ws, wr, date, addr, site):
        # working rows: [order, wh, date, addr, site, cost, profit, flags]
        rows = torch.cat([ws, torch.zeros_like(ws[..., :1])], dim=2)
        valid = _all(rows)
        with trace_mod.span("q95.date"):
            rows, valid, of1 = dim_round(rows, valid, 2, date, 1,
                                         lambda d: (d >= lo) & (d < hi))
        with trace_mod.span("q95.addr"):
            rows, valid, of2 = dim_round(
                rows, valid, 3, addr, 2, lambda s: s == cfg.target_state)
        with trace_mod.span("q95.site"):
            rows, valid, of3 = dim_round(
                rows, valid, 4, site, 4, lambda c: c == cfg.target_company)
        with trace_mod.span("q95.by_order"):
            # round 4: co-locate by order_number (fact AND returns)
            rows, valid, of4 = shuffle_into(
                rows, _route(rows[..., 0], valid, n), cap, impl)
            wr_recv, wr_valid, of5 = shuffle_into(
                wr, _route(wr[..., 0], _all(wr), n),
                _dim_cap(wr.shape[1], n), impl)
        with trace_mod.span("q95.aggregate"):
            # per-order reductions over rows sorted by (order, warehouse):
            # an order ships from more than one warehouse when the
            # warehouse changes inside its run (the keys are made outside
            # the sort's span, so this span's device range starts before it)
            keys = (torch.where(valid, to_u64(rows[..., 0]), SENTINEL),
                    to_u64(rows[..., 1]))
            with trace_mod.span("q95.aggregate.sort"):
                o_s, r_s = sort_rows(rows, keys)
            del keys  # freed as the sort returns, not held to the step's end
            seg = _Segments(o_s)
            live = o_s != SENTINEL
            wh_change = torch.cat(
                [torch.zeros_like(seg.first[:, :1]),
                 r_s[:, 1:, 1] != r_s[:, :-1, 1]], dim=1) & ~seg.first
            multi = seg.sum(wh_change) > 0  # >1 distinct warehouse
            _, has_ret, of6 = hash_lookup(
                (wr_recv[..., 0],), wr_valid, None, (low_word(o_s),), live,
                _sent(wr))
            qual = live & (r_s[..., 7] == 7) & has_ret & multi
            distinct = (seg.first & (seg.sum(qual) > 0)).sum(dim=1)
            cost = torch.where(qual, to_u64(r_s[..., 5]), 0).sum(dim=1)
            profit = torch.where(qual, to_u64(r_s[..., 6]), 0).sum(dim=1)
        overflowed = of1 | of2 | of3 | of4 | of5 | of6
        partial = torch.stack([distinct, _wrap32(cost), _wrap32(profit)],
                              dim=1).to(torch.int32)
        return partial, overflowed

    return step


def _stage_all(mesh: VirtualMesh, tables) -> list:
    return [stage_to_device(pad_rows_to_devices(t, mesh.num_shards), mesh)
            for t in tables]


def run_q95(mesh: VirtualMesh, cfg: Q95Config, seed: int = 0,
            impl: str = "auto", tables: Optional[tuple] = None,
            ) -> Tuple[int, int, int]:
    """Host driver: the exact global q95 answer. ``tables`` is a
    ``generate_q95`` result (made from ``seed`` when not given). Raises
    ``OverflowError`` when a shuffle overflowed its receive headroom or a
    lookup its bound (``hash_lookup``'s flag)."""
    if tables is None:
        tables = generate_q95(cfg, mesh.num_shards, seed)
    partial, overflowed = make_q95_step(mesh, cfg, impl)(
        *_stage_all(mesh, tables))
    if overflowed.any().item():
        raise OverflowError("q95: an exchange overflowed its receive "
                            "headroom (raise out_factor) or a lookup "
                            "its bound")
    totals = partial.cpu().numpy().sum(axis=0).astype(np.int64)
    return int(totals[0]), int(totals[1]), int(totals[2])


# ===========================================================================
# q64
# ===========================================================================


@dataclass(frozen=True)
class Q64Config:
    ss_rows_per_device: int
    cs_rows_per_device: int
    num_items: int             # < 2**31 - 1: the pair key's high word
    num_dates: int = 365
    first_year_mod: int = 0    # dates with (date % 3) == mod are year Y
    sr_fraction: float = 0.5   # store returns coverage of store sales
    cr_fraction: float = 0.5   # catalog returns coverage
    zipf_a: float = 1.3        # item popularity skew
    out_factor: int = 4


def _zipf_items(rng, num_items, size, a):
    z = rng.zipf(a, size=size * 2)
    z = z[z <= num_items][:size]
    while len(z) < size:
        more = rng.zipf(a, size=size)
        z = np.concatenate([z, more[more <= num_items]])[:size]
    return (z - 1).astype(np.uint32)


def generate_q64(cfg: Q64Config, num_devices: int, seed: int = 0):
    """(ss[N,4], sr[R,2], cs[M,3], cr[Q,3], date[D,2]) as u32, the same
    arrays as the JAX package's generator for the same seed.

    ss: item, ticket, sold_date, price.  sr: item, ticket.
    cs: item, order, price.              cr: item, order, refund.
    date: date_sk, year (0 = Y, 1 = Y+1, 2 = other -> filtered).
    Tickets/orders are globally unique (row index), so (item, key) pairs
    are unique, the join-on-pair contract of the real tables. Items lie
    below ``num_items`` (< 2**31 - 1) and tickets and orders below the
    row counts (< 2**32); below 2**16 both, the JAX package's limits,
    the draws are its draws."""
    n_ss = cfg.ss_rows_per_device * num_devices
    n_cs = cfg.cs_rows_per_device * num_devices
    if cfg.num_items >= _ITEM_LIMIT or max(n_ss, n_cs) > (1 << 32):
        raise ValueError(f"q64 keys past their words: {cfg.num_items} "
                         f"items, {n_ss} store and {n_cs} catalog rows")
    rng = np.random.default_rng(seed)
    ss = np.stack([
        _zipf_items(rng, cfg.num_items, n_ss, cfg.zipf_a),
        np.arange(n_ss, dtype=np.uint32),
        rng.integers(0, cfg.num_dates, n_ss).astype(np.uint32),
        rng.integers(0, 1000, n_ss).astype(np.uint32),
    ], axis=1)
    sr_rows = rng.permutation(n_ss)[: int(n_ss * cfg.sr_fraction)]
    sr = ss[np.sort(sr_rows)][:, :2].copy()
    cs = np.stack([
        _zipf_items(rng, cfg.num_items, n_cs, cfg.zipf_a),
        np.arange(n_cs, dtype=np.uint32),
        rng.integers(0, 1000, n_cs).astype(np.uint32),
    ], axis=1)
    cr_rows = rng.permutation(n_cs)[: int(n_cs * cfg.cr_fraction)]
    cr = np.concatenate(
        [cs[np.sort(cr_rows)][:, :2],
         rng.integers(0, 1000, len(cr_rows)).astype(np.uint32)
         .reshape(-1, 1)], axis=1)
    date = np.stack([
        np.arange(cfg.num_dates, dtype=np.uint32),
        ((np.arange(cfg.num_dates) + cfg.first_year_mod) % 3)
        .astype(np.uint32),
    ], axis=1)
    return ss, sr, cs, cr, date


def _np_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)


def numpy_q64_by_shard(ss, sr, cs, cr, date, cfg: Q64Config,
                       num_shards: int) -> np.ndarray:
    """Oracle: ``int64[num_shards, 2]``, (qualifying item count, sum of
    both years' price sums) of the items each shard owns
    (``hash_partition`` of the item key, the step's last routing). The
    JAX package's per-row loop, vectorised; pair and date keys are
    unique."""
    # cs_ui: join cr on (item, order), group by item, HAVING
    refund, found = _np_lookup(_np_pair(cr[:, 0], cr[:, 1]), cr[:, 2],
                               _np_pair(cs[:, 0], cs[:, 1]))
    items, inv = np.unique(cs[:, 0], return_inverse=True)
    sale = np.zeros(len(items), np.int64)
    refunds = np.zeros(len(items), np.int64)
    np.add.at(sale, inv, cs[:, 2].astype(np.int64))
    np.add.at(refunds, inv, np.where(found, refund, 0))
    ui = items[sale > 2 * refunds]
    # store_sales join store_returns (inner), date, cs_ui (semi)
    year, y_found = _np_lookup(date[:, 0], date[:, 1], ss[:, 2])
    keep = (np.isin(_np_pair(ss[:, 0], ss[:, 1]), _np_pair(sr[:, 0], sr[:, 1]))
            & np.isin(ss[:, 0], ui) & y_found & (year <= 1))
    items, inv = np.unique(ss[keep, 0], return_inverse=True)
    cnt = np.zeros((len(items), 2), np.int64)
    np.add.at(cnt, (inv, year[keep]), 1)
    psum = np.zeros(len(items), np.int64)
    np.add.at(psum, inv, ss[keep, 3].astype(np.int64))
    # CTE self-join across years: cnt(Y+1) <= cnt(Y)
    qual = (cnt[:, 0] > 0) & (cnt[:, 1] > 0) & (cnt[:, 1] <= cnt[:, 0])
    owner = _np_owner(items[qual], num_shards)
    out = np.zeros((num_shards, 2), np.int64)
    np.add.at(out[:, 0], owner, 1)
    np.add.at(out[:, 1], owner, psum[qual])
    return out


def numpy_q64(ss, sr, cs, cr, date, cfg: Q64Config) -> Tuple[int, int]:
    """Oracle: (qualifying item count, sum of both years' price sums)."""
    return tuple(int(x) for x in numpy_q64_by_shard(
        ss, sr, cs, cr, date, cfg, 1)[0])


def make_q64_step(mesh: VirtualMesh, cfg: Q64Config, impl: str = "auto"):
    """q64 as chained shuffles in one step over every shard.

    1. catalog_sales + catalog_returns by hash(item, order): pair join.
    2. joined rows by hash(item): per-item sale/refund sums -> cs_ui.
    3. store_sales + store_returns by hash(item, ticket): inner pair join.
    4. survivors + date_dim by hash(sold_date): year lookup + filter.
    5. survivors by hash(item): per-(item, year) aggregation, the cs_ui
       semi-join, and the across-years CTE self-join (items co-located).

    ``step(ss, sr, cs, cr, date)`` takes ``int32[D, rows, W]`` u32 words
    and returns per-shard partials ``(int32[D, 2], overflowed bool[D])``.
    The pair joins carry each pair as the rows' first two words (item
    high, key low), route by ``_pairkey`` and look up on those words.
    """
    n = mesh.num_shards
    impl = resolve_transport(mesh, impl)
    cap_ss = cfg.ss_rows_per_device * cfg.out_factor
    cap_cs = cfg.cs_rows_per_device * cfg.out_factor

    def by_pair(t):
        return _route(_pairkey(to_u64(t[..., 0]), to_u64(t[..., 1])),
                      _all(t), n)

    def pair_lookup(dim, dim_valid, dim_attr, rows, valid, bound):
        with trace_mod.span("q64.pair_lookup"):
            return hash_lookup((dim[..., 0], dim[..., 1]), dim_valid,
                               dim_attr, (rows[..., 0], rows[..., 1]), valid,
                               bound)

    def step(ss, sr, cs, cr, date):
        with trace_mod.span("q64.catalog_join"):
            # round 1: catalog pair join
            cs_r, cs_v, o1 = shuffle_into(cs, by_pair(cs), cap_cs, impl)
            cr_r, cr_v, o2 = shuffle_into(cr, by_pair(cr), cap_cs, impl)
            refund, found, o9 = pair_lookup(cr_r, cr_v, cr_r[..., 2], cs_r,
                                            cs_v, _sent(cr))
            refund = torch.where(found, refund, 0)
        with trace_mod.span("q64.catalog_group"):
            # round 2: group catalog by item -> cs_ui
            joined = torch.stack([cs_r[..., 0], cs_r[..., 2],
                                  to_bits(refund)], dim=2)
            j_r, j_v, o3 = shuffle_into(
                joined, _route(cs_r[..., 0], cs_v, n), cap_cs, impl)
            ik_s, j_s = sort_rows(
                j_r, (torch.where(j_v, to_u64(j_r[..., 0]), SENTINEL),))
            seg = _Segments(ik_s)
            live = ik_s != SENTINEL
            sale_sum = _wrap32(seg.sum(torch.where(live, to_u64(j_s[..., 1]),
                                                   0)))
            refund_sum = seg.sum(torch.where(live, to_u64(j_s[..., 2]), 0))
            ui_flag = sale_sum > _wrap32(2 * refund_sum)
            # one entry per item run -> this shard's cs_ui items
            ui = seg.first & ui_flag & live
        with trace_mod.span("q64.store_join"):
            # round 3: store pair join (inner)
            ss_r, ss_v, o4 = shuffle_into(ss, by_pair(ss), cap_ss, impl)
            sr_r, sr_v, o5 = shuffle_into(sr, by_pair(sr), cap_ss, impl)
            _, ret_found, o10 = pair_lookup(sr_r, sr_v, None, ss_r, ss_v,
                                            _sent(sr))
            surv_v = ss_v & ret_found
        with trace_mod.span("q64.date_join"):
            # round 4: date join on survivors
            d_r, d_v, o6 = shuffle_into(
                date, _route(date[..., 0], _all(date), n),
                _dim_cap(date.shape[1], n), impl)
            s2, s2_v, o7 = shuffle_into(ss_r, _route(ss_r[..., 2], surv_v, n),
                                        cap_ss, impl)
            year, y_found, o11 = hash_lookup(
                (d_r[..., 0],), d_v, d_r[..., 1], (s2[..., 2],), s2_v,
                _sent(date))
            s2_v = s2_v & y_found & (year <= 1)
        with trace_mod.span("q64.by_item"):
            # round 5: group by item; semi-join cs_ui; CTE self-join
            rows5 = torch.stack([s2[..., 0], to_bits(year), s2[..., 3]],
                                dim=2)
            r5, v5, o8 = shuffle_into(
                rows5, _route(s2[..., 0], s2_v, n), cap_ss, impl)
            ik5_s, r5_s = sort_rows(
                r5, (torch.where(v5, to_u64(r5[..., 0]), SENTINEL),))
            seg5 = _Segments(ik5_s)
            live5 = ik5_s != SENTINEL
            cnt0 = seg5.sum(live5 & (r5_s[..., 1] == 0))
            cnt1 = seg5.sum(live5 & (r5_s[..., 1] == 1))
            sum01 = seg5.sum(torch.where(live5, to_u64(r5_s[..., 2]), 0))
            # items were routed by the SAME hash in rounds 2 and 5, so the
            # semi-join against this shard's cs_ui entries is local
            # (one entry per item: at most num_items of them)
            _, is_ui, o12 = hash_lookup(
                (low_word(ik_s),), ui, None, (low_word(ik5_s),), live5,
                min(cfg.num_items, _sent(ik_s)))
            qual = (seg5.first & is_ui & live5 & (cnt0 > 0) & (cnt1 > 0)
                    & (cnt1 <= cnt0))
            items = qual.sum(dim=1)
            total = torch.where(qual, sum01, 0).sum(dim=1)
        overflowed = (o1 | o2 | o3 | o4 | o5 | o6 | o7 | o8 | o9 | o10 | o11
                      | o12)
        return (torch.stack([items, _wrap32(total)], dim=1).to(torch.int32),
                overflowed)

    return step


def run_q64(mesh: VirtualMesh, cfg: Q64Config, seed: int = 0,
            impl: str = "auto", tables: Optional[tuple] = None,
            ) -> Tuple[int, int]:
    """Host driver: the exact global q64 answer. ``tables`` is a
    ``generate_q64`` result (made from ``seed`` when not given). Raises
    ``OverflowError`` when a shuffle overflowed its receive headroom or a
    lookup its bound (``hash_lookup``'s flag)."""
    if tables is None:
        tables = generate_q64(cfg, mesh.num_shards, seed)
    partial, overflowed = make_q64_step(mesh, cfg, impl)(
        *_stage_all(mesh, tables))
    if overflowed.any().item():
        raise OverflowError("q64: an exchange overflowed its receive "
                            "headroom (raise out_factor) or a lookup "
                            "its bound")
    totals = partial.cpu().numpy().sum(axis=0).astype(np.int64)
    return int(totals[0]), int(totals[1])


def pad_rows_to_devices(table: np.ndarray, n: int) -> np.ndarray:
    """Pad a global table to a shard multiple with PAD rows (dead keys
    never match a lookup; they route like any key)."""
    rem = (-len(table)) % n
    if rem == 0:
        return table
    padding = np.full((rem, table.shape[1]), PAD, dtype=table.dtype)
    return np.concatenate([table, padding])


# ===========================================================================
# engine-DAG variants (the drop-in SPI path)
# ===========================================================================


def _engine_dep(num_partitions: int, width: int):
    from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec
    from sparkrdma_tpu_torch.shuffle.spark_compat import ShuffleDependency

    return ShuffleDependency(num_partitions, PartitionerSpec("modulo"),
                             row_payload_bytes=4 * width)


def _engine_src(table: np.ndarray, keyfn, num_maps: int):
    """Source-stage task fn: stripe ``table`` across map tasks, write
    u32 rows keyed by ``keyfn(rows) -> u64``."""
    width = table.shape[1] * 4

    def fn(ctx, writer, task, _t=table, _w=width):
        rows = _t[task::num_maps]
        writer.write((keyfn(rows), np.ascontiguousarray(rows, "<u4")
                      .view(np.uint8).reshape(len(rows), _w)))
    return fn


def _read_u32(ctx, parent: int, width: int):
    """Drain one parent shuffle into (keys u64[N], cols u32[N, width])."""
    ks, vs = [], []
    for keys, payload in ctx.read(parent).readBatches():
        ks.append(keys)
        vs.append(np.ascontiguousarray(payload).view("<u4")
                  .reshape(len(keys), -1))
    if not ks:
        return np.zeros(0, np.uint64), np.zeros((0, width), np.uint32)
    return np.concatenate(ks), np.concatenate(vs)


def build_q95_job(cfg: Q95Config, num_maps: int, num_partitions: int,
                  seed: int = 0, data_scale: int = 1):
    """q95 as a stage DAG for ``engine.DAGEngine.run``: five sources,
    three dimension shuffle-join MapStages, a final by-order ResultStage
    — seven shuffles through the SPI. Returns (result_stage, finish)."""
    from sparkrdma_tpu_torch.engine import MapStage, ResultStage

    ws, wr, date, addr, site = generate_q95(cfg, data_scale, seed)

    def dep(width):
        return _engine_dep(num_partitions, width)

    def col(key_col):
        return lambda rows, _k=key_col: rows[:, _k].astype(np.uint64)

    # working rows carry an extra flags column (col 7)
    ws8 = np.concatenate(
        [ws, np.zeros((len(ws), 1), np.uint32)], axis=1)
    ws_st = MapStage(num_maps, dep(8),
                     _engine_src(ws8, col(2), num_maps))   # by ship_date
    date_st = MapStage(num_maps, dep(2), _engine_src(date, col(0), num_maps))
    addr_st = MapStage(num_maps, dep(2), _engine_src(addr, col(0), num_maps))
    site_st = MapStage(num_maps, dep(2), _engine_src(site, col(0), num_maps))
    wr_st = MapStage(num_maps, dep(1),
                     _engine_src(wr, col(0), num_maps))    # by order

    lo, hi = cfg.window_start, cfg.window_start + 60

    def join_stage(key_col, next_key_col, flag_bit, pred):
        def fn(ctx, writer, task, _k=key_col, _nk=next_key_col,
               _b=flag_bit, _p=pred):
            _, rows = _read_u32(ctx, 0, 8)
            dkeys, dcols = _read_u32(ctx, 1, 2)
            attr, found = _np_lookup(dkeys, dcols[:, 1],
                                     rows[:, _k].astype(np.uint64))
            ok = found & _p(attr)
            rows = rows.copy()
            rows[:, 7] |= np.where(ok, np.uint32(_b), np.uint32(0))
            writer.write((rows[:, _nk].astype(np.uint64),
                          np.ascontiguousarray(rows, "<u4").view(np.uint8)
                          .reshape(len(rows), 32)))
            del task
        return fn

    j1 = MapStage(num_partitions, dep(8),
                  join_stage(2, 3, 1, lambda d: (d >= lo) & (d < hi)),
                  parents=[ws_st, date_st])
    j2 = MapStage(num_partitions, dep(8),
                  join_stage(3, 4, 2, lambda s: s == cfg.target_state),
                  parents=[j1, addr_st])
    j3 = MapStage(num_partitions, dep(8),
                  join_stage(4, 0, 4, lambda c: c == cfg.target_company),
                  parents=[j2, site_st])

    def final_fn(ctx, task):
        _, rows = _read_u32(ctx, 0, 8)
        wr_keys, _wr_rows = _read_u32(ctx, 1, 1)
        returned = set(wr_keys.tolist())
        wh_by_order: dict = {}
        for o, w in zip(rows[:, 0].tolist(), rows[:, 1].tolist()):
            wh_by_order.setdefault(o, set()).add(w)
        multi = {o for o, s in wh_by_order.items() if len(s) > 1}
        orders = set()
        cost = profit = 0
        for r in rows.tolist():
            o = r[0]
            if r[7] == 7 and o in multi and o in returned:
                orders.add(o)
                cost += r[5]
                profit += r[6]
        del task
        return len(orders), cost, profit

    result = ResultStage(num_partitions, final_fn, parents=[j3, wr_st])

    def finish(results):
        return (sum(r[0] for r in results), sum(r[1] for r in results),
                sum(r[2] for r in results))

    return result, finish


def build_q64_job(cfg: Q64Config, num_maps: int, num_partitions: int,
                  seed: int = 0, data_scale: int = 1):
    """q64 as a stage DAG: five sources, catalog pair-join, catalog
    group-by(item) -> cs_ui, store pair-join, date join, final by-item
    ResultStage with the across-years CTE self-join — eight shuffles
    through the SPI. Returns (result_stage, finish)."""
    from sparkrdma_tpu_torch.engine import MapStage, ResultStage

    ss, sr, cs, cr, date = generate_q64(cfg, data_scale, seed)

    def dep(width):
        return _engine_dep(num_partitions, width)

    def pair_u64(rows):
        return _np_pair(rows[:, 0], rows[:, 1])

    def col0_u64(rows):
        return rows[:, 0].astype(np.uint64)

    cs_st = MapStage(num_maps, dep(3), _engine_src(cs, pair_u64, num_maps))
    cr_st = MapStage(num_maps, dep(3), _engine_src(cr, pair_u64, num_maps))
    ss_st = MapStage(num_maps, dep(4), _engine_src(ss, pair_u64, num_maps))
    sr_st = MapStage(num_maps, dep(2), _engine_src(sr, pair_u64, num_maps))
    date_st = MapStage(num_maps, dep(2),
                       _engine_src(date, col0_u64, num_maps))

    def cat_join_fn(ctx, writer, task):
        cs_keys, cs_rows = _read_u32(ctx, 0, 3)
        cr_keys, cr_rows = _read_u32(ctx, 1, 3)
        refund_by_pair = dict(zip(cr_keys.tolist(),
                                  cr_rows[:, 2].tolist()))
        refunds = np.array([refund_by_pair.get(k, 0)
                            for k in cs_keys.tolist()], np.uint32)
        out = np.stack([cs_rows[:, 0], cs_rows[:, 2], refunds], axis=1)
        writer.write((cs_rows[:, 0].astype(np.uint64),
                      np.ascontiguousarray(out, "<u4").view(np.uint8)
                      .reshape(len(out), 12)))
        del task

    cat_join = MapStage(num_partitions, dep(3), cat_join_fn,
                        parents=[cs_st, cr_st])

    def ui_fn(ctx, writer, task):
        _, rows = _read_u32(ctx, 0, 3)
        sale: dict = {}
        refund: dict = {}
        for i, p, r in rows.tolist():
            sale[i] = sale.get(i, 0) + p
            refund[i] = refund.get(i, 0) + r
        ui = np.array([i for i in sale if sale[i] > 2 * refund[i]],
                      np.uint32).reshape(-1, 1)
        writer.write((ui[:, 0].astype(np.uint64),
                      np.ascontiguousarray(ui, "<u4").view(np.uint8)
                      .reshape(len(ui), 4)))
        del task

    ui_st = MapStage(num_partitions, dep(1), ui_fn, parents=[cat_join])

    def store_join_fn(ctx, writer, task):
        ss_keys, ss_rows = _read_u32(ctx, 0, 4)
        sr_keys, _ = _read_u32(ctx, 1, 2)
        returned = set(sr_keys.tolist())
        keep = np.array([k in returned for k in ss_keys.tolist()], bool)
        rows = ss_rows[keep]
        writer.write((rows[:, 2].astype(np.uint64),   # by sold_date
                      np.ascontiguousarray(rows, "<u4").view(np.uint8)
                      .reshape(len(rows), 16)))
        del task

    store_join = MapStage(num_partitions, dep(4), store_join_fn,
                          parents=[ss_st, sr_st])

    def date_join_fn(ctx, writer, task):
        _, rows = _read_u32(ctx, 0, 4)
        dkeys, dcols = _read_u32(ctx, 1, 2)
        year = dict(zip(dkeys.tolist(), dcols[:, 1].tolist()))
        ys = np.array([year.get(d, 99) for d in rows[:, 2].tolist()],
                      np.uint32)
        keep = ys <= 1
        out = np.stack([rows[:, 0][keep], ys[keep], rows[:, 3][keep]],
                       axis=1)
        writer.write((out[:, 0].astype(np.uint64),    # by item
                      np.ascontiguousarray(out, "<u4").view(np.uint8)
                      .reshape(len(out), 12)))
        del task

    date_join = MapStage(num_partitions, dep(3), date_join_fn,
                         parents=[store_join, date_st])

    def final_fn(ctx, task):
        _, rows = _read_u32(ctx, 0, 3)
        ui_keys, _ = _read_u32(ctx, 1, 1)
        ui = set(ui_keys.tolist())
        cnt: dict = {}
        psum: dict = {}
        for i, y, p in rows.tolist():
            if i not in ui:
                continue
            cnt[(i, y)] = cnt.get((i, y), 0) + 1
            psum[(i, y)] = psum.get((i, y), 0) + p
        items = total = 0
        for i in {i for i, _y in cnt}:
            c0, c1 = cnt.get((i, 0), 0), cnt.get((i, 1), 0)
            if c0 > 0 and c1 > 0 and c1 <= c0:
                items += 1
                total += psum.get((i, 0), 0) + psum.get((i, 1), 0)
        del task
        return items, total

    result = ResultStage(num_partitions, final_fn,
                         parents=[date_join, ui_st])

    def finish(results):
        return (sum(r[0] for r in results), sum(r[1] for r in results))

    return result, finish
