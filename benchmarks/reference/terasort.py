"""TeraSort in plain PyTorch: one stable key sort of every row.

Rows are ``int32[D, N, W]`` u32 words, key in column 0, shard-major. The
port range-partitions keys over ``D`` shards at ``(i << 32) // D`` and
sorts each shard's receipts stably by key, arrivals in source order. A
range partition is monotone in the key, so a stable sort of all rows in
shard-major order is every shard's output laid end to end.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def _keys(flat: torch.Tensor, key_bits: int) -> torch.Tensor:
    keys = flat[:, 0].to(torch.int64) & MASK
    return keys >> (32 - key_bits)


def terasort(rows: torch.Tensor, shards: int, key_bits: int = 32):
    """``(sorted_rows [D*N, W], recv_counts int64[D, D])``:
    ``recv_counts[d, j]`` rows shard d receives from shard j.
    ``key_bits`` below 32 sorts on the key's top bits alone: the control,
    which breaks TeraSort's guarantee of a total order."""
    d, n, w = rows.shape
    flat = rows.reshape(d * n, w)
    full = flat[:, 0].to(torch.int64) & MASK
    edges = torch.tensor([(i << 32) // shards for i in range(1, shards)],
                         dtype=torch.int64, device=rows.device)
    dest = torch.searchsorted(edges, full, right=True)
    src = torch.arange(d, device=rows.device).repeat_interleave(n)
    counts = torch.zeros(shards * d, dtype=torch.int64, device=rows.device)
    counts.index_add_(0, dest * d + src, torch.ones_like(dest))
    order = torch.sort(_keys(flat, key_bits), stable=True).indices
    if key_bits < 32:
        # the control still partitions on the full key
        order = order[torch.sort(dest[order], stable=True).indices]
    return flat[order], counts.reshape(shards, d)
