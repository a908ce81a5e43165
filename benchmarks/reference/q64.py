"""TPC-DS q64 in plain PyTorch, over whole tables, in blocks of rows.

Tables are ``int32[D, rows, W]`` u32 words, dead rows holding 0xFFFFFFFF
in every word: store_sales (item, ticket, sold date, price),
store_returns (item, ticket), catalog_sales (item, order, price),
catalog_returns (item, order, refund) and date_dim (date key, year: 0
for year Y, 1 for Y+1, 2 for neither). Each (item, ticket) and (item,
order) pair is a line's primary key, as in TPC-DS; item keys lie below
2**31 - 1, tickets and orders anywhere in u32. Pairs are compared exactly,
as ``item * 2**32 + key``.

``cs_ui`` is the items whose catalog sales sum to more than twice their
catalog refunds (a sale's refund is its return's, by pair, or 0). A
store line survives when a store return has its pair, its sold date is in
year Y or Y+1, and its item is in ``cs_ui``; per item, ``cnt`` of each
year and the price sum of both. An item qualifies when it sold in both
years and ``cnt(Y+1) <= cnt(Y)`` (the CTE joined to itself across years).
The answer is (qualifying items, sum of their price sums), split by the
shard that owns each item: the port's last exchange routes an item to
``fmix32(item) % D`` (MurmurHash3's finalizer on u32 words). Sums wrap to
int32 as the port's and the JAX package's do.

Departures from TPC-DS's text, the port's plan as the JAX package has it:
- q64 joins ten more tables (store, customer, demographics, addresses,
  promotion, income bands, item with its color and price filter) and
  groups ``cross_sales`` by item, store and zip; here by item alone.
- ``cs_ui`` joins catalog_sales to catalog_returns as an inner join, so
  its sums run over returned lines only; here every catalog sale of the
  item counts against the refunds of its returned lines.
- The refund is one column, not ``cr_refunded_cash + cr_reversed_charge
  + cr_store_credit``; one price stands for q64's three store sums.
- The years are ``date_dim``'s year column as the generator sets it, not
  1999 and 2000; the output is a count and a sum, not the rows.
- Sums wrap to int32 (where TPC-DS's decimals do not).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
PAD = 0xFFFFFFFF
BLOCK = 1 << 22  # fact rows a block


def _blocks(table: torch.Tensor):
    """The live rows of ``table`` as int64 u32 values, a block at a time."""
    flat = table.reshape(-1, table.shape[-1])
    for start in range(0, len(flat), BLOCK):
        rows = flat[start:start + BLOCK].to(torch.int64) & MASK
        yield rows[rows[:, 0] != PAD]


def _rows(table: torch.Tensor) -> torch.Tensor:
    return torch.cat(list(_blocks(table)))


def _pairs(item: torch.Tensor, key: torch.Tensor, pair_bits: int
           ) -> torch.Tensor:
    """Exact pairs (``pair_bits`` 32), or the parent's u32 pair key
    ``item << 16 + key`` mod 2**32 (16: the control)."""
    if pair_bits == 32:
        return item * (1 << 32) + key
    return (item * (1 << pair_bits) + key) & MASK


def _lookup(keys: torch.Tensor, attr: torch.Tensor, probes: torch.Tensor):
    """``(attr, found)`` of each probe in sorted ``keys``."""
    if len(keys) == 0:
        return torch.zeros_like(probes), torch.zeros_like(probes,
                                                          dtype=torch.bool)
    idx = torch.searchsorted(keys, probes.contiguous()).clamp(
        max=len(keys) - 1)
    return attr[idx], keys[idx] == probes


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


def _cs_ui(cs, cr, pair_bits: int, having: bool) -> torch.Tensor:
    """``cs_ui``'s items, sorted (every catalog item without HAVING)."""
    cr = _rows(cr)
    keys, order = torch.sort(_pairs(cr[:, 0], cr[:, 1], pair_bits))
    refunds = cr[order, 2]
    items = torch.unique(torch.cat([b[:, 0].unique() for b in _blocks(cs)]))
    sale = torch.zeros_like(items)
    refund = torch.zeros_like(items)
    for rows in _blocks(cs):
        got, found = _lookup(keys, refunds,
                             _pairs(rows[:, 0], rows[:, 1], pair_bits))
        at = torch.searchsorted(items, rows[:, 0].contiguous())
        sale.index_add_(0, at, rows[:, 2])
        refund.index_add_(0, at, torch.where(found, got, 0))
    if not having:
        return items
    return items[_wrap32(sale) > _wrap32(2 * refund)]


def _survivors(ss, sr, date, ui, pair_bits: int, store_join_on_item: bool
               ) -> torch.Tensor:
    """The surviving store lines' (item, year, price) ``[S, 3]``: after
    the pair join, the years' filter and, unless ``ui`` is None, the
    semi-join on ``cs_ui``'s items ``ui``."""
    sr = _rows(sr)
    if store_join_on_item:
        returned = torch.unique(sr[:, 0])
    else:
        returned = torch.sort(_pairs(sr[:, 0], sr[:, 1], pair_bits)).values
    date = _rows(date)
    day_keys, order = torch.sort(date[:, 0])
    years = date[order, 1]
    kept = []
    for rows in _blocks(ss):
        probe = rows[:, 0] if store_join_on_item else _pairs(
            rows[:, 0], rows[:, 1], pair_bits)
        _, has_return = _lookup(returned, returned, probe)
        year, dated = _lookup(day_keys, years, rows[:, 2])
        keep = has_return & dated & (year <= 1)
        if ui is not None:
            keep &= _lookup(ui, ui, rows[:, 0])[1]
        kept.append(torch.stack([rows[keep, 0], year[keep], rows[keep, 3]],
                                dim=1))
    return torch.cat(kept)


def q64(ss, sr, cs, cr, date, *, shards: int, pair_bits: int = 32,
        store_join_on_item: bool = False, having: bool = True
        ) -> torch.Tensor:
    """``int64[shards, 2]``: per owning shard, (qualifying items, sum of
    their price sums), the sum wrapped to int32.

    The controls: ``pair_bits=16`` joins on the parent's u32 pair key,
    which folds tickets and orders past 2**16 into the item's bits;
    ``store_join_on_item`` keeps a store line when any return has its
    item; ``having=False`` drops ``cs_ui``'s HAVING."""
    ui = _cs_ui(cs, cr, pair_bits, having)
    lines = _survivors(ss, sr, date, ui, pair_bits, store_join_on_item)
    items, inv = torch.unique(lines[:, 0], return_inverse=True)
    cnt0 = torch.zeros_like(items).index_add_(
        0, inv, (lines[:, 1] == 0).to(torch.int64))
    cnt1 = torch.zeros_like(items).index_add_(
        0, inv, (lines[:, 1] == 1).to(torch.int64))
    price = torch.zeros_like(items).index_add_(0, inv, lines[:, 2])
    qual = (cnt0 > 0) & (cnt1 > 0) & (cnt1 <= cnt0)
    own = owner(items[qual], shards)
    out = torch.zeros((shards, 2), dtype=torch.int64, device=items.device)
    out[:, 0].index_add_(0, own, torch.ones_like(own))
    out[:, 1].index_add_(0, own, price[qual])
    out[:, 1] = _wrap32(out[:, 1])
    return out


def by_item_skew(ss, sr, cs, date, *, shards: int) -> list:
    """The by-item shuffles' largest receiver's rows over the mean: the
    catalog lines (the ``cs_ui`` grouping) and the store lines that pass
    the pair join and the years (the per-item aggregation, before its
    semi-join), each counted at its item's owner; dead rows left out."""
    catalog = sum(torch.bincount(owner(rows[:, 0], shards), minlength=shards)
                  for rows in _blocks(cs))
    lines = _survivors(ss, sr, date, None, 32, False)
    store = torch.bincount(owner(lines[:, 0], shards), minlength=shards)
    return [float(c.max() * shards / c.sum()) for c in (catalog, store)]
