"""Device-side aggregation ops for the reduce side of a shuffle.

Port of ``sparkrdma_tpu/ops/aggregate.py``: segment reductions keyed by
u32 keys over the exchange's packed output, static-shape throughout. All
take ``(keys, values, valid)`` padded buffers, pre-sorted by key with
invalid rows at the end (the layout ``ops.sort.sort_segments`` produces),
and a static ``max_unique`` capacity, and return dense ``(unique_keys,
aggregates, count)`` with padding at the end: reduceByKey, countByKey,
maxByKey.

Keys are u32 values carried as int32 bit patterns (or zero-extended
int64) and come back in the dtype they came in; padding keys are the u32
maximum. Every function takes one shard's ``[N]`` buffers or a batch of
shards' ``[D, N]`` buffers.

JAX scatters with ``mode="drop"``: an out-of-range index is dropped.
PyTorch has no such mode, so each scatter here writes into
``max_unique + 1`` places and the last place, the one every dropped
write goes to, is sliced off.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparkrdma_tpu_torch.utils.u32 import SENTINEL, from_u64, to_u64


def _batched(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() > 1 else x.unsqueeze(0)


def _scatter(init: torch.Tensor, index: torch.Tensor, src: torch.Tensor,
             reduce: str) -> torch.Tensor:
    """Per-shard scatter of ``src [D, N]`` into ``init [D, M]`` at
    ``index [D, N]`` (entries in ``[0, M)``) with ``reduce`` (``"set"``,
    ``"sum"``, ``"amax"`` or ``"amin"``)."""
    if reduce == "set":
        return init.scatter(1, index, src)
    return init.scatter_reduce(1, index, src, reduce=reduce,
                               include_self=True)


def _compact_unique(keys: torch.Tensor, valid: torch.Tensor,
                    max_unique: int):
    """Sorted keys -> (segment ids per row, unique keys buffer, n_unique).

    Rows must be pre-sorted by key with invalid rows at the end."""
    k = _batched(to_u64(keys))
    v = _batched(valid)
    first = torch.cat([torch.ones_like(k[:, :1], dtype=torch.bool),
                       k[:, 1:] != k[:, :-1]], dim=1) & v
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    n_unique = first.sum(dim=1)
    # only a segment's first row writes its key, and only below
    # max_unique; every other row lands in the extra place, sliced off
    # (it must NOT collide with the last real slot)
    target = torch.where(first & (seg < max_unique), seg, max_unique)
    init = torch.full((k.shape[0], max_unique + 1), SENTINEL,
                      dtype=torch.int64, device=k.device)
    uniq = from_u64(_scatter(init, target, k, "set")[:, :max_unique], keys)
    if keys.dim() == 1:
        return seg[0], uniq[0], n_unique[0]
    return seg, uniq, n_unique


def _identity(dtype: torch.dtype, op: str):
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def segment_reduce_by_key(keys: torch.Tensor, values: torch.Tensor,
                          valid: torch.Tensor, max_unique: int,
                          op: str = "sum",
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """reduceByKey over a padded, key-sorted buffer.

    Returns ``(unique_keys[max_unique], agg[max_unique], n_unique)``
    (each with a leading ``D`` axis for batched input); entries past
    ``n_unique`` are padding (key = u32 maximum, agg = the op's
    identity). ``op``: "sum" | "max" | "min" | "count".

    ``n_unique`` counts ALL distinct keys present, so ``n_unique >
    max_unique`` signals capacity truncation (the excess segments
    collapse into the last slot): the caller must check it and re-run
    with a larger capacity rather than trust the buffers."""
    if op not in ("sum", "max", "min", "count"):
        raise ValueError(f"unknown op {op!r}")
    seg, uniq, n_unique = _compact_unique(keys, valid, max_unique)
    seg, v = _batched(seg), _batched(valid)
    seg_safe = torch.where(v, torch.clamp(seg, max=max_unique - 1),
                           max_unique - 1)
    vals = _batched(values)
    shape = (seg.shape[0], max_unique)
    if op == "count":
        agg = _scatter(torch.zeros(shape, dtype=torch.int32,
                                   device=seg.device),
                       seg_safe, v.to(torch.int32), "sum")
    elif op == "sum":
        agg = _scatter(torch.zeros(shape, dtype=vals.dtype,
                                   device=seg.device),
                       seg_safe, torch.where(v, vals, 0).to(vals.dtype),
                       "sum")
    else:
        ident = _identity(vals.dtype, op)
        agg = _scatter(torch.full(shape, ident, dtype=vals.dtype,
                                  device=seg.device),
                       seg_safe, torch.where(v, vals, ident).to(vals.dtype),
                       "amax" if op == "max" else "amin")
    if keys.dim() == 1:
        agg = agg[0]
    return uniq, agg, n_unique


def count_by_key(keys: torch.Tensor, valid: torch.Tensor, max_unique: int):
    """countByKey (keys pre-sorted, padded)."""
    return segment_reduce_by_key(keys, torch.zeros_like(keys), valid,
                                 max_unique, op="count")
