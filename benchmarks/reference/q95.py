"""TPC-DS q95 in plain PyTorch, over whole tables.

Tables are ``int32[D, rows, W]`` u32 words, dead rows keyed ``0xFFFFFFFF``:
web_sales (order, warehouse, ship date, ship address, site, ext_ship_cost,
net_profit), web_returns (order), and the dimensions date_dim (key, day),
customer_address (key, state) and web_site (key, company), keys unique.

A line qualifies when it ships inside the window, to the target state,
from a site of the target company, and its order both ships from more than
one warehouse (``ws_wh``) and has a return. The answer is count(distinct
order), sum(ext_ship_cost), sum(net_profit) of the qualifying lines, split
by the shard that owns each order: the port's last exchange routes an order
to ``fmix32(order) % D`` (MurmurHash3's finalizer on u32 words), and its
sums wrap to int32 as the port's do.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
PAD = 0xFFFFFFFF


def _words(table: torch.Tensor) -> torch.Tensor:
    return table.reshape(-1, table.shape[-1]).to(torch.int64) & MASK


def _lookup(dim: torch.Tensor, probes: torch.Tensor):
    """``(attr, found)`` of each probe in a ``[M, 2]`` (key, attr) table."""
    dim = dim[dim[:, 0] != PAD]
    keys, order = torch.sort(dim[:, 0])
    idx = torch.searchsorted(keys, probes.contiguous()).clamp(
        max=len(keys) - 1)
    return dim[order, 1][idx], keys[idx] == probes


def _mul32(k: torch.Tensor, c: int) -> torch.Tensor:
    lo = k * (c & 0xFFFF)
    hi = ((k * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def owner(keys: torch.Tensor, shards: int) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer of each u32 key, mod ``shards``."""
    k = _mul32(keys ^ (keys >> 16), 0x85EBCA6B)
    k = _mul32(k ^ (k >> 13), 0xC2B2AE35)
    return (k ^ (k >> 16)) % shards


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x & MASK) ^ 0x80000000) - 0x80000000


def q95(ws, wr, date, addr, site, *, window_start: int, window_days: int,
        target_state: int, target_company: int, shards: int,
        semi_joins: bool = True) -> torch.Tensor:
    """``int64[shards, 3]``: per owning shard, (distinct qualifying
    orders, sum cost, sum profit), sums wrapped to int32.

    ``semi_joins=False`` is the control: both ``IN`` subqueries evaluated
    as inner joins, so each qualifying line counts once per ``ws_wh`` row
    of its order (the ordered pairs of its lines from different
    warehouses) and once per return of its order."""
    ws = _words(ws)
    ws = ws[ws[:, 0] != PAD]
    order, wh = ws[:, 0], ws[:, 1]
    day, found_d = _lookup(_words(date), ws[:, 2])
    state, found_s = _lookup(_words(addr), ws[:, 3])
    company, found_c = _lookup(_words(site), ws[:, 4])
    keep = (found_d & (day >= window_start)
            & (day < window_start + window_days)
            & found_s & (state == target_state)
            & found_c & (company == target_company))

    # ws_wh: each order's lines per warehouse
    pairs, per_pair = torch.unique(order * (1 << 32) + wh,
                                   return_counts=True)
    pair_order = pairs >> 32
    orders, inv = torch.unique(pair_order, return_inverse=True)
    lines = torch.zeros_like(orders).index_add_(0, inv, per_pair)
    squares = torch.zeros_like(orders).index_add_(0, inv, per_pair ** 2)
    wh_rows = lines * lines - squares  # ordered pairs, warehouses differ

    returns = _words(wr)[:, 0]
    returns = returns[returns != PAD]
    ret_orders, ret_rows = torch.unique(returns, return_counts=True)

    o = order[keep]
    at = torch.searchsorted(orders, o)
    weight = wh_rows[at]
    r_at = torch.searchsorted(ret_orders, o).clamp(max=len(ret_orders) - 1)
    has_ret = ret_orders[r_at] == o
    weight = weight * torch.where(has_ret, ret_rows[r_at], 0)
    qual = weight > 0
    if semi_joins:
        weight = qual.to(torch.int64)
    o, weight = o[qual], weight[qual]
    cost, profit = ws[keep][qual, 5], ws[keep][qual, 6]

    out = torch.zeros((shards, 3), dtype=torch.int64, device=ws.device)
    distinct = torch.unique(o)
    out[:, 0].index_add_(0, owner(distinct, shards),
                         torch.ones_like(distinct))
    own = owner(o, shards)
    out[:, 1].index_add_(0, own, cost * weight)
    out[:, 2].index_add_(0, own, profit * weight)
    out[:, 1:] = _wrap32(out[:, 1:])
    return out
