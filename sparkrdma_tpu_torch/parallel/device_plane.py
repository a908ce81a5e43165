"""The fused device step: partition + exchange + local sort.

Port of ``make_fused_step`` and its helpers from
``sparkrdma_tpu/parallel/device_plane.py``. The step runs every shard of
the virtual mesh at once on ``[D, cap, W]`` int32 rows; keys are u32
words compared as zero-extended int64 (``utils.u32``).

Each layer of the step runs under a ``record_function`` span
(``fused.local_sort``, ``fused.counts``, ``fused.exchange``,
``fused.receive_sort``; the exchange adds its own inside), so a
``torch.profiler`` trace of a step splits its device time by layer.
A span costs a few microseconds of host time when no profiler runs.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.profiler import record_function

from sparkrdma_tpu_torch.ops.partition import uniform_splitters
from sparkrdma_tpu_torch.parallel.exchange import (
    group_by_destination,
    ragged_exchange_shard,
    resolve_transport,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh, take_rows
from sparkrdma_tpu_torch.utils.u32 import SENTINEL, to_bits, to_u64

SORT_MODES = ("gather", "multisort", "colsort")


def _stable_order(keys: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Per-shard permutation that sorts ``keys`` (int64 ``[D, N]``, most
    significant first) with ties in original position order: LSD passes,
    one stable sort per key word, least significant first."""
    order = None
    for k in reversed(keys):
        kk = k if order is None else k.gather(1, order)
        _, idx = torch.sort(kk, dim=1, stable=True)
        order = idx if order is None else order.gather(1, idx)
    return order


def _local_sort(rows: torch.Tensor, keys: Tuple[torch.Tensor, ...],
                sort_mode: str, write_back_keys: bool):
    """One per-shard sort of full rows ``[D, N, W]`` by (pre-masked)
    keys, a tuple of int64 ``[D, N]`` key words, most significant first.
    Returns ``(sorted_rows, sorted_keys)`` with ``sorted_keys`` the most
    significant word.

    The JAX package's three ``sort_mode``s are three ways to make XLA
    carry the payload through a sort: ``gather`` sorts (key, iota) and
    gathers rows once, ``multisort`` and ``colsort`` feed the payload
    columns through the sort network. All three give the same stable
    order (ties by arrival). In PyTorch a stable sort of the keys plus one
    row gather IS that order, so the three modes share this one
    implementation; the names stay for parity with the JAX config.

    ``write_back_keys`` overwrites column 0 with the sorted key
    (single-word layouts only), so padding rows show the sentinel."""
    if sort_mode not in SORT_MODES:
        raise ValueError(f"unknown sort_mode {sort_mode!r} "
                         "(expected 'gather', 'multisort' or 'colsort')")
    order = _stable_order(keys)
    sorted_keys = keys[0].gather(1, order)
    sorted_rows = take_rows(rows, order)
    if write_back_keys:
        sorted_rows[:, :, 0] = to_bits(sorted_keys)
    return sorted_rows, sorted_keys


def _row_keys(rows: torch.Tensor, key_words: int):
    """The per-row sort key words (int64 ``[D, N]``), most significant
    first: column 0 for single-word u32 keys, ``(hi=col 1, lo=col 0)``
    for the little-endian packed u64 layout."""
    if key_words == 1:
        return (to_u64(rows[:, :, 0]),)
    return (to_u64(rows[:, :, 1]), to_u64(rows[:, :, 0]))


def make_fused_step(mesh: VirtualMesh, row_words: int, *,
                    out_factor: int = 2, impl: str = "auto",
                    sort_mode: str = "gather", key_words: int = 1,
                    partition: str = "range") -> Callable:
    """Build the fused partition+exchange+local-sort step over ``mesh``.

    ``partition`` selects how rows find their destination shard:

    * ``"range"`` — uniform u32 key-range split (TeraSort): ONE key sort
      doubles as the destination grouping, and per-destination counts
      come from D-1 binary searches. ``step(rows)`` with ``rows:
      int32[D, cap, row_words]``, key = column 0.
    * ``"dest"`` — caller-computed destinations: ``step(rows, dest)``
      with ``dest: int[D, cap]``; ``dest < 0`` marks padding rows (not
      sent). Rows group by destination, ride the exchange, and key-sort
      on the receiving shard (``key_words`` 1 = u32 column 0, 2 = u64
      packed columns [0, 1]).

    Returns ``(sorted_rows [D, cap * out_factor, row_words],
    recv_counts int32[D, D], overflowed bool[D])`` with each shard's rows
    key-sorted, padding at the end (strip with ``recv_counts[d].sum()``).
    ``overflowed[d]`` flags a receive past the ``out_factor`` headroom or
    a slot-pair overflow: results there are truncated and must not be
    trusted.
    """
    if sort_mode not in SORT_MODES:
        # a typo must not silently measure (and mislabel) the gather path
        raise ValueError(f"unknown sort_mode {sort_mode!r} "
                         "(expected 'gather', 'multisort' or 'colsort')")
    if partition not in ("range", "dest"):
        raise ValueError(f"unknown partition {partition!r} "
                         "(expected 'range' or 'dest')")
    if partition == "range" and key_words != 1:
        raise ValueError("range partitioning is defined on single-word "
                         "u32 keys")
    n = mesh.num_shards
    impl = resolve_transport(mesh, impl)
    write_back = key_words == 1
    splitters = (uniform_splitters(n, mesh.device) if partition == "range"
                 else None)

    def sort_received(received, total):
        """Key-sort received rows with pads (index >= total) masked to
        the sentinel on every key word so they sort last; stable order
        within equal keys is arrival (source-major) order."""
        idx = torch.arange(received.shape[1], device=received.device)
        pad = idx[None, :] >= total[:, None]
        keys = tuple(k.masked_fill(pad, SENTINEL)
                     for k in _row_keys(received, key_words))
        return _local_sort(received, keys, sort_mode, write_back)[0]

    def exchange_and_sort(grouped, counts):
        output = torch.zeros(
            (n, grouped.shape[1] * out_factor, row_words),
            dtype=grouped.dtype, device=grouped.device)
        with record_function("fused.exchange"):
            received, recv_counts, _, overflowed = ragged_exchange_shard(
                grouped, counts, output=output, impl=impl)
        with record_function("fused.receive_sort"):
            sorted_rows = sort_received(received, recv_counts.sum(dim=1))
        return sorted_rows, recv_counts, overflowed

    def no_exchange(rows, valid):
        # single shard: no exchange, one sort is the whole job
        keys = tuple(k.masked_fill(~valid, SENTINEL)
                     for k in _row_keys(rows, key_words))
        sorted_rows, _ = _local_sort(rows, keys, sort_mode, write_back)
        counts = valid.sum(dim=1, dtype=torch.int32).reshape(1, 1)
        return sorted_rows, counts, torch.zeros(1, dtype=torch.bool,
                                                device=rows.device)

    if partition == "range":

        def step(rows: torch.Tensor):
            if n == 1:
                return no_exchange(rows, torch.ones(rows.shape[:2],
                                                    dtype=torch.bool,
                                                    device=rows.device))
            # Local sort by KEY once: range partition is monotonic in
            # key, so key-sorted rows are destination-grouped for free.
            with record_function("fused.local_sort"):
                grouped, sorted_keys = _local_sort(
                    rows, _row_keys(rows, 1), sort_mode, write_back)
            # per-destination counts: D-1 binary searches on sorted keys
            with record_function("fused.counts"):
                bounds = torch.searchsorted(
                    sorted_keys, splitters.expand(n, n - 1).contiguous())
                edge = torch.full((n, 1), rows.shape[1], dtype=bounds.dtype,
                                  device=bounds.device)
                bounds = torch.cat([torch.zeros_like(edge), bounds, edge],
                                   dim=1)
                counts = torch.diff(bounds, dim=1).to(torch.int32)
            return exchange_and_sort(grouped, counts)

        return step

    def step(rows: torch.Tensor, dest: torch.Tensor):
        dest = dest.reshape(rows.shape[:2])
        if n == 1:
            return no_exchange(rows, dest >= 0)
        with record_function("fused.local_sort"):
            grouped, counts = group_by_destination(rows, dest, n)
        return exchange_and_sort(grouped, counts)

    return step
