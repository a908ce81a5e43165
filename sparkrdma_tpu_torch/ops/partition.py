"""Partitioning ops: key -> destination assignment.

Port of ``sparkrdma_tpu/ops/partition.py``. Keys are u32 values carried
as int32 bit patterns or zero-extended int64 (``utils.u32``); every
function takes a tensor of any shape, so a ``[D, N]`` batch of shards
partitions in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.mesh import resolve_device
from sparkrdma_tpu_torch.utils.u32 import MASK, to_u64


def _mul_u32(k: torch.Tensor, c: int) -> torch.Tensor:
    """``k * c mod 2**32`` for int64 ``k`` in ``[0, 2**32)``, split into
    16-bit halves of ``c`` so no product leaves the int64 range."""
    lo = k * (c & 0xFFFF)
    hi = ((k * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def hash_partition(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Stateless integer hash -> partition id (int32): the Murmur3
    finalizer with the u32 wraparound of the JAX version, bit for bit."""
    k = to_u64(keys)
    k = _mul_u32(k ^ (k >> 16), 0x85EBCA6B)
    k = _mul_u32(k ^ (k >> 13), 0xC2B2AE35)
    k = k ^ (k >> 16)
    return (k % num_partitions).to(torch.int32)


def range_partition(keys: torch.Tensor, splitters: torch.Tensor
                    ) -> torch.Tensor:
    """Destination = number of splitters <= key (int32 in
    ``[0, len(splitters)]``); keys and splitters are u32 values."""
    return torch.searchsorted(to_u64(splitters), to_u64(keys),
                              right=True).to(torch.int32)


def sample_splitters(sample: np.ndarray, num_partitions: int) -> np.ndarray:
    """Choose ``num_partitions - 1`` splitters from a key sample (host-side,
    once per job — the TeraSort recipe)."""
    s = np.sort(np.asarray(sample))
    if num_partitions <= 1 or len(s) == 0:
        return np.zeros(0, dtype=s.dtype if len(s) else np.int64)
    idx = (np.arange(1, num_partitions) * len(s)) // num_partitions
    return s[np.minimum(idx, len(s) - 1)]


def uniform_splitters(num_partitions: int, device=None) -> torch.Tensor:
    """Analytic splitters for keys uniform over the full u32 range, as
    zero-extended int64 values — avoids the sampling pass when the key
    distribution is known. ``device`` defaults to ``cuda``."""
    span = 1 << 32
    edges = [(i * span) // num_partitions for i in range(1, num_partitions)]
    return torch.tensor(edges, dtype=torch.int64,
                        device=resolve_device(device))


def partition_and_count(keys: torch.Tensor, splitters: torch.Tensor,
                        num_partitions: int):
    """Destination ids + per-partition histogram in one pass: the
    ``range_partition`` destinations and an int32 count of each id in
    ``[0, num_partitions)`` along the last axis (``[..., num_partitions]``;
    a 1-D ``keys`` gives the JAX function's ``[num_partitions]``).

    ``jnp.bincount(length=n)`` drops ids ``>= n`` (a key past every
    splitter when there are ``n`` or more of them), where
    ``torch.bincount(minlength=n)`` would grow; the counts here come from
    the sorted ids, one binary search per partition bound, so ids past
    the last bound are left out as JAX leaves them out, with no host
    sync and no atomics."""
    dest = range_partition(keys, splitters)
    sorted_dest, _ = torch.sort(dest.to(torch.int64), dim=-1)
    bounds = torch.arange(num_partitions + 1, device=dest.device)
    edges = torch.searchsorted(
        sorted_dest,
        bounds.expand(dest.shape[:-1] + (num_partitions + 1,)).contiguous())
    return dest, torch.diff(edges, dim=-1).to(torch.int32)
