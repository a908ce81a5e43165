"""Local sort ops.

Port of ``sparkrdma_tpu/ops/sort.py``: on-device sorts feeding and
draining the exchange. Keys are u32 values, carried as int32 bit patterns
or zero-extended int64 (``utils.u32``), and compared unsigned; sorted keys
come back in the dtype they came in. Every function takes one shard's
``[N]`` keys or a batch of shards' ``[D, N]`` keys and sorts along the
last axis.

Sorts are stable (ties keep their input order). ``lax.sort`` in the JAX
package makes no promise about the order of ties, so the two agree
exactly wherever keys are distinct.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sparkrdma_tpu_torch.parallel.mesh import take_rows
from sparkrdma_tpu_torch.utils.u32 import SENTINEL, from_u64, to_u64


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
