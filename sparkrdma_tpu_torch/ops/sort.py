"""Local sort ops: the port's one row sort and the sorts around it.

Port of ``sparkrdma_tpu/ops/sort.py``: on-device sorts feeding and
draining the exchange. Keys are u32 values, carried as int32 bit patterns
or zero-extended int64 (``utils.u32``), and compared unsigned; sorted keys
come back in the dtype they came in. Every function takes one shard's
``[N]`` keys or a batch of shards' ``[D, N]`` keys and sorts along the
last axis.

This module owns how rows sort by their u32 key words: ``sort_rows``
(LSD stable passes, then one row gather), which the range step's local
sort and q95's aggregate sort call; ``sort_live_rows``, that sort with
pad rows sent last and key 0 written back, for the one-shard step and
``sort_received``, the ``dest`` step's sort of received rows and the
plain version ``ops/run_merge.py``'s merge kernel is held to; and
``lookup_unique``, the sorted unique-key join of the query plans, on
u32 words or on 64-bit composite keys.

Sorts are stable (ties keep their input order). ``lax.sort`` in the JAX
package makes no promise about the order of ties, so the two agree
exactly wherever keys are distinct.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sparkrdma_tpu_torch.parallel.mesh import take_rows
from sparkrdma_tpu_torch.utils.u32 import (
    SENTINEL,
    SENTINEL64,
    from_u64,
    to_bits,
    to_u64,
)


def sort_kv(keys: torch.Tensor, values: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort rows by key; ``values`` (``[N, ...]``, or ``[D, N, ...]`` for
    batched keys) ride along. Returns ``(sorted_keys, sorted_values)``."""
    sorted_keys, order = torch.sort(to_u64(keys), dim=-1, stable=True)
    sorted_keys = from_u64(sorted_keys, keys)
    if values is None:
        return sorted_keys, None
    if keys.dim() == 1:
        return sorted_keys, values.index_select(0, order)
    return sorted_keys, take_rows(values, order)


def sort_segments(keys: torch.Tensor, valid: torch.Tensor,
                  values: Optional[torch.Tensor] = None):
    """Sort only the valid rows of a padded buffer: invalid rows are keyed
    with the u32 maximum, so they go to the end (fixed-capacity exchange
    outputs where ``recv_total <= capacity``)."""
    masked = torch.where(valid, to_u64(keys), SENTINEL)
    return sort_kv(from_u64(masked, keys), values)


def merge_sorted_padded(keys: torch.Tensor, counts: torch.Tensor
                        ) -> torch.Tensor:
    """Exchange output grouped by source in segments of sizes ``counts``
    (``[n]``, or ``[D, n]`` for batched ``[D, N]`` keys): the validity mask
    of the packed region."""
    total = counts.to(torch.int64).sum(dim=-1, keepdim=True)
    pos = torch.arange(keys.shape[-1], device=keys.device)
    mask = pos < total
    return mask if keys.dim() > 1 else mask.reshape(-1)


def sort_rows(rows: torch.Tensor, keys: Tuple[torch.Tensor, ...]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``[D, N, W]`` stably sorted per shard by ``keys``, a tuple of
    pre-masked int64 ``[D, N]`` key words, most significant first: one
    stable sort a word, least significant first, then one row gather.
    Returns ``(sorted_key0, sorted_rows)`` with ``sorted_key0`` the most
    significant word in sorted order.

    The JAX package's three local-sort strategies (``gather``,
    ``multisort``, ``colsort``) are three ways to make XLA carry the
    payload through a sort; they give this one stable order (ties by
    arrival), and in PyTorch a stable sort of the keys plus one row
    gather is that order."""
    order = None
    for k in reversed(keys):
        kk = k if order is None else k.gather(1, order)
        _, idx = torch.sort(kk, dim=1, stable=True)
        order = idx if order is None else order.gather(1, idx)
    # the row gather before the key gather: a span around this sort then
    # ends on a kernel of its own, so its device range covers the
    # ``mesh.take_rows`` one
    sorted_rows = take_rows(rows, order)
    return keys[0].gather(1, order), sorted_rows


def row_keys(rows: torch.Tensor, key_words: int
             ) -> Tuple[torch.Tensor, ...]:
    """The per-row sort key words (int64 ``[D, N]``), most significant
    first: column 0 for single-word u32 keys, ``(hi=col 1, lo=col 0)``
    for the little-endian packed u64 layout."""
    if key_words == 1:
        return (to_u64(rows[:, :, 0]),)
    return (to_u64(rows[:, :, 1]), to_u64(rows[:, :, 0]))


def sort_live_rows(rows: torch.Tensor, pad: torch.Tensor,
                   key_words: int = 1) -> torch.Tensor:
    """Key-sort rows ``[D, N, W]`` with the rows where ``pad`` (bool
    ``[D, N]``) is set masked to the sentinel on every key word, so they
    sort last; stable order within equal keys is input order. Single-word
    keys are written back into column 0, so pads show the sentinel."""
    keys = tuple(k.masked_fill(pad, SENTINEL)
                 for k in row_keys(rows, key_words))
    sorted_keys, sorted_rows = sort_rows(rows, keys)
    if key_words == 1:
        sorted_rows[:, :, 0] = to_bits(sorted_keys)
    return sorted_rows


def sort_received(received: torch.Tensor, recv_counts: torch.Tensor,
                  key_words: int = 1) -> torch.Tensor:
    """``sort_live_rows`` of received rows ``[D, R, W]`` whose pads are
    the rows past the receiver's ``recv_counts`` total; ties keep arrival
    (source-major) order."""
    total = recv_counts.sum(dim=1)
    idx = torch.arange(received.shape[1], device=received.device)
    return sort_live_rows(received, idx[None, :] >= total[:, None],
                          key_words)


def lookup_unique(dim_keys: torch.Tensor, dim_valid: torch.Tensor,
                  dim_attr: torch.Tensor, probes: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique-key lookup per shard: ``dim_attr`` u32 words ``[D,
    M]``, ``dim_keys`` ``[D, M]`` (rows where ``dim_valid`` is false take
    no part) and ``probes`` int64 ``[D, N]``. Returns ``(attr int64,
    found)`` per probe; a sentinel probe is never found.

    Two forms, by ``dim_keys``' dtype: int32 u32 words, probed by
    zero-extended u32 values with ``SENTINEL`` the "no row" probe; or
    int64 keys taken as they are (q64's 64-bit pair composites, or u32
    values that are never 0xFFFFFFFF where valid), with ``SENTINEL64``
    the "no row" probe."""
    wide = dim_keys.dtype == torch.int64
    sentinel = SENTINEL64 if wide else SENTINEL
    dk = torch.where(dim_valid, dim_keys if wide else to_u64(dim_keys),
                     sentinel)
    ks, order = torch.sort(dk, dim=1, stable=True)
    at = to_u64(dim_attr).gather(1, order)
    idx = torch.clamp(torch.searchsorted(ks, probes), 0, ks.shape[1] - 1)
    found = (ks.gather(1, idx) == probes) & (probes != sentinel)
    return at.gather(1, idx), found
