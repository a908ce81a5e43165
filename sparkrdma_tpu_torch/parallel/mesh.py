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

A ``GlobalMesh`` spans several processes (``parallel/multihost.py``
builds it): each holds ``local_shards`` of the ``num_shards`` global
shards as its own ``[Dl, cap, ...]`` tensors, and only the exchange
crosses processes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import torch

from sparkrdma_tpu_torch.ops.row_gather import row_gather
from sparkrdma_tpu_torch.utils import trace as trace_mod


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

    @property
    def local_shards(self) -> int:
        """Shards this process holds: all of them."""
        return self.num_shards


@dataclass(frozen=True)
class ShardDevice:
    """Where global shard ``id`` of a ``GlobalMesh`` lives: its process
    and, for this process's shards, the device (None for a peer's).
    ``process_index`` is what
    ``topology.detect_topology`` groups shards into slices by, as the
    JAX package's devices expose it."""

    id: int
    process_index: int
    device: Optional[torch.device]


@dataclass(frozen=True, eq=False)
class GlobalMesh:
    """``num_processes`` processes, each with ``local_shards`` virtual
    shards on its ``device``: ``num_shards = P * Dl`` global shards, and
    global shard ``g = rank * Dl + d`` is local shard ``d`` of process
    ``rank`` (the JAX package's ``mesh.devices.flat`` order).

    ``group`` is the gloo control group (metadata, barriers, IPC
    handles); ``data_group`` is a group whose backend takes tensors on
    ``device`` (the control group on the CPU, an NCCL group where each
    rank has a card of its own), or None. ``arena`` is the receive arena
    the ring kernel writes into across processes. Hashed by identity:
    one mesh per process (``multihost.global_mesh``)."""

    num_processes: int
    local_shards: int
    rank: int
    device: torch.device
    group: object = field(repr=False)
    data_group: object = field(repr=False, default=None)
    arena: object = field(repr=False, default=None)

    @property
    def num_shards(self) -> int:
        return self.num_processes * self.local_shards

    @property
    def first_shard(self) -> int:
        """This process's first global shard."""
        return self.rank * self.local_shards

    @property
    def devices(self) -> Tuple[ShardDevice, ...]:
        dl = self.local_shards
        return tuple(ShardDevice(g, g // dl, self.device
                                 if g // dl == self.rank else None)
                     for g in range(self.num_shards))

    def local_view(self) -> VirtualMesh:
        """This process's shards as a ``VirtualMesh`` (host staging)."""
        return VirtualMesh(self.local_shards, self.device)


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard ``take`` along dim 1: ``rows[d, idx[d, k]]`` for every
    shard d (``rows: [D, N, ...]``, ``idx: [D, K]`` int32 or int64 with
    entries in ``[0, N)``) -> ``[D, K, ...]``: one launch of the row
    gather kernel on the card (``ops/row_gather.py``), one flat
    ``index_select`` on the CPU.

    One ``mesh.take_rows`` span; while profiled, ``gather.bytes`` counts
    the bytes the gather must move: each picked row read and written,
    and its 8-byte index read."""
    with trace_mod.span("mesh.take_rows"):
        picked = row_gather(rows, idx)
    if trace_mod.counting():
        row_bytes = math.prod(rows.shape[2:]) * rows.element_size()
        trace_mod.count("gather.bytes", idx.numel() * (2 * row_bytes + 8))
    return picked
