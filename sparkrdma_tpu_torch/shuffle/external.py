"""Positional merges of key-sorted row sets (plain numpy).

A copy of ``merge_two`` and ``merge_runs`` from
``sparkrdma_tpu/shuffle/external.py``, which the streamed TeraSort driver
uses to merge each shard's per-round runs. Two sorted arrays interleave
with two ``searchsorted`` calls and two scatters, no per-row Python; R
runs merge as an O(N log R) pairwise tournament.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]  # (keys[N], rows[N, ...])


def merge_two(a_keys: np.ndarray, a_rows: np.ndarray,
              b_keys: np.ndarray, b_rows: np.ndarray) -> Batch:
    """Merge two key-sorted row sets, stable with ``a`` first on ties."""
    pos_a = np.arange(len(a_keys)) + np.searchsorted(b_keys, a_keys, "left")
    pos_b = np.arange(len(b_keys)) + np.searchsorted(a_keys, b_keys, "right")
    keys = np.empty(len(a_keys) + len(b_keys), a_keys.dtype)
    rows = np.empty((len(keys),) + a_rows.shape[1:], a_rows.dtype)
    keys[pos_a], keys[pos_b] = a_keys, b_keys
    rows[pos_a], rows[pos_b] = a_rows, b_rows
    return keys, rows


def merge_runs(runs: Sequence[Batch]) -> Batch:
    """Tournament-merge R key-sorted runs in O(N log R); earlier runs win
    ties."""
    runs = list(runs)
    nonempty = [r for r in runs if len(r[0])]
    if not nonempty:
        if runs:  # preserve the caller's dtypes/row shape, just empty
            k0, r0 = runs[0]
            return k0[:0], r0[:0]
        return np.zeros(0, np.uint64), np.zeros((0, 0), np.uint8)
    runs = nonempty
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(merge_two(*runs[i], *runs[i + 1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]
