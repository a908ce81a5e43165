"""Stable partition of each shard's rows by destination: the grouping in
front of every shuffle (``parallel/exchange.py::group_by_destination``).

``dest_partition(dest, P)`` takes ``dest [D, N]`` (int32 or int64, read
as given) and returns ``order int64 [D, N]``, each shard's row indices
grouped by destination, ascending within a destination, the pads (``dest
< 0`` or ``dest >= P``) last, and ``totals int32 [D, P + 1]``, the rows of
each destination with the pads' last. The JAX package leaves this to XLA's
``jnp.argsort(dest, stable=True)``; here it is the CUDA kernel
``dest_partition_launch`` in ``csrc/dest_partition.cu`` (its header says
what bounds it and how the design follows): a count pass, a scan and a
place pass, with no sort.

A CUDA tensor always reaches the kernel (or an exception); a CPU tensor
takes ``dest_partition_plain``, the stable ``torch.sort`` of the
destinations and a search of the sorted ones, which the CPU tests and the
on-card comparison use. ``LAUNCHES`` counts the calls that launch the
kernel's three passes, one a call with rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from sparkrdma_tpu_torch.ops._build import bind

LAUNCHES = 0
_KERNEL = "dest_partition"

TILE_ROWS = 2048          # kTileRows in csrc/dest_partition.cu
MAX_PARTITIONS = 255      # kMaxBuckets - 1: the pads take the last bucket
MAX_ROWS = 2**31 - 1      # kMaxRows
DEST_DTYPES = (torch.int32, torch.int64)
# csrc/dest_partition.cu's extern "C" functions: name -> (argtypes, restype)
SIGNATURES = {
    "dest_partition_launch": (
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p),
        ctypes.c_int),
    "dest_partition_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}

def dest_partition_plain(dest: torch.Tensor, num_partitions: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the pads mapped to
    ``num_partitions``, a stable sort of the int64 destinations, and the
    totals from a search of the sorted ones."""
    dest = dest.to(torch.int64)
    dest = torch.where((dest < 0) | (dest >= num_partitions),
                       num_partitions, dest)
    sorted_dest, order = torch.sort(dest, dim=1, stable=True)
    bounds = torch.arange(num_partitions + 2, device=dest.device)
    edges = torch.searchsorted(
        sorted_dest, bounds.expand(dest.shape[0], -1).contiguous())
    return order, torch.diff(edges, dim=1).to(torch.int32)


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    return bind(_KERNEL, SIGNATURES)


def _check(dest: torch.Tensor, num_partitions: int) -> None:
    """What the kernel takes, or raise."""
    if dest.dim() != 2:
        raise ValueError(f"dest must be [D, N], got {tuple(dest.shape)}")
    if dest.dtype not in DEST_DTYPES:
        raise TypeError(f"dest_partition takes int32 or int64 "
                        f"destinations, got {dest.dtype}")
    if not 1 <= num_partitions <= MAX_PARTITIONS:
        raise ValueError(f"dest_partition takes 1 to {MAX_PARTITIONS} "
                         f"partitions, got {num_partitions}")
    if dest.shape[1] > MAX_ROWS:
        raise ValueError(f"dest_partition takes at most {MAX_ROWS} rows a "
                         f"shard, got {dest.shape[1]}")


def dest_partition(dest: torch.Tensor, num_partitions: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dest [D, N]`` -> ``(order int64 [D, N], totals int32 [D,
    num_partitions + 1])``; see the module's docstring. Launches on the
    current stream and reads nothing back to the host."""
    global LAUNCHES
    if not dest.is_cuda:
        if dest.device.type == "cpu":
            return dest_partition_plain(dest, num_partitions)
        raise ValueError(f"dest_partition runs on cuda or cpu, not "
                         f"{dest.device}")
    _check(dest, num_partitions)
    dest = dest.contiguous()
    d, n = dest.shape
    buckets = num_partitions + 1
    order = torch.empty((d, n), dtype=torch.int64, device=dest.device)
    if order.numel() == 0:
        return order, torch.zeros((d, buckets), dtype=torch.int32,
                                  device=dest.device)
    totals = torch.empty((d, buckets), dtype=torch.int32, device=dest.device)
    table = torch.empty((d, buckets, math.ceil(n / TILE_ROWS)),
                        dtype=torch.int32, device=dest.device)
    lib = _library()
    err = lib.dest_partition_launch(
        dest.data_ptr(), order.data_ptr(), table.data_ptr(),
        totals.data_ptr(), d, n, num_partitions, dest.element_size(),
        torch._C._cuda_getCurrentRawStream(dest.get_device()))
    if err != 0:
        raise RuntimeError("dest_partition launch failed: "
                           + lib.dest_partition_error_string(err).decode())
    LAUNCHES += 1
    return order, totals
