"""TeraSort over two executors in plain PyTorch: one executor's part of
the whole sort.

The rows are every executor's shards, ``int32[G, N, W]``, shard-major,
as ``reference/terasort.py`` takes them; executor ``r`` holds global
shards ``[r * Dl, (r + 1) * Dl)``. Its part of the answer is those
shards' receipts: the run of the stable key sort that lands on them, in
shard order, and their rows of the count matrix.
"""

from __future__ import annotations

import torch

from . import terasort  # the plain sort, torch alone


def executor_part(rows: torch.Tensor, first: int, local: int,
                  key_bits: int = 32):
    """``(sorted_rows [T, W], recv_counts int64[local, G], totals
    int64[local])`` of global shards ``[first, first + local)``: the
    rows they receive laid end to end (``T`` = their totals' sum), what
    each receives from each global source, and each one's total.
    ``key_bits`` as in ``terasort.terasort``."""
    shards = rows.shape[0]
    flat, counts = terasort.terasort(rows, shards, key_bits)
    totals = counts.sum(dim=1)
    start = int(totals[:first].sum())
    end = start + int(totals[first:first + local].sum())
    return (flat[start:end], counts[first:first + local],
            totals[first:first + local])
