"""The virtual mesh: D shards held as the leading axis of one tensor.

The JAX package runs its device plane inside ``shard_map`` over a
``jax.sharding.Mesh`` (``sparkrdma_tpu/utils/compat.py``). The port
keeps all D shards on ONE device as a ``[D, cap, ...]`` tensor instead of
emulating ``shard_map`` with a per-shard loop, so a step is a few dozen
launches whatever D is:

* ``lax.axis_index`` is ``torch.arange(D)``;
* the ``all_gather`` of per-shard ``send_counts`` is the ``[D, D]``
  count matrix itself;
* ``lax.all_to_all`` is a swap of the two leading axes;
* every per-shard op (sort, searchsorted, take, cumsum) runs batched
  along dim 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller asks for another device. With no GPU
    and no explicit request this raises: the port never falls back to
    the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


@dataclass(frozen=True)
class VirtualMesh:
    """``num_shards`` virtual shards on one ``device`` (default ``cuda``)."""

    num_shards: int
    device: torch.device

    def __init__(self, num_shards: int,
                 device: Optional[Union[str, torch.device]] = None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        object.__setattr__(self, "num_shards", int(num_shards))
        object.__setattr__(self, "device", resolve_device(device))


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard ``take`` along dim 1: ``rows[d, idx[d, k]]`` for every
    shard d, as one flat ``index_select`` (``rows: [D, N, ...]``,
    ``idx: [D, K]`` with entries in ``[0, N)``) -> ``[D, K, ...]``."""
    d, n = rows.shape[0], rows.shape[1]
    flat = idx.to(torch.int64) + torch.arange(
        d, device=idx.device, dtype=torch.int64)[:, None] * n
    picked = rows.reshape((d * n,) + rows.shape[2:]).index_select(
        0, flat.reshape(-1))
    return picked.reshape(idx.shape + rows.shape[2:])
