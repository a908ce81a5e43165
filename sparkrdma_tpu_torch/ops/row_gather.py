"""Row gather: ``out[d, k] = rows[d, idx[d, k]]`` for every shard at once.

The per-shard ``take`` under ``parallel/mesh.py::take_rows``, and so
under every grouping, sort and landing of the device plane. The JAX
package leaves it to XLA's gather; here it is the CUDA kernel
``row_gather_launch`` in ``csrc/row_gather.cu`` (its header says what
bounds it and how the design follows), which reads the ``[D, K]``
indices itself and adds each shard's base in the kernel.

``row_gather`` is the wrapper: a CUDA tensor always reaches the kernel
(or an exception); a CPU tensor takes ``row_gather_plain``, one flat
``index_select``, the plain version that the CPU tests and the on-card
comparison use. ``LAUNCHES`` counts the kernel's launches (one a call,
unless ``pieces`` cuts a gather of 2^31 rows or more) and ``SHAPES``
counts them per ``(row_bytes, V)``, V the bytes each lane moves at a
time (``vector_bytes``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import torch

from sparkrdma_tpu_torch.ops._build import bind

LAUNCHES = 0
SHAPES: Dict[Tuple[int, int], int] = {}
_KERNEL = "row_gather"

MAX_ROWS = 2**31 - 1          # kMaxRows in csrc/row_gather.cu
INDEX_DTYPES = (torch.int32, torch.int64)
# csrc/row_gather.cu's extern "C" functions: name -> (argtypes, restype)
SIGNATURES = {
    "row_gather_launch": (
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
        ctypes.c_int),
    "row_gather_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}

def row_gather_plain(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each shard's indices
    offset by its base ``d * N`` and one ``index_select`` over the
    ``[D * N, ...]`` rows."""
    d, n = rows.shape[0], rows.shape[1]
    flat = idx.to(torch.int64) + torch.arange(
        d, device=idx.device, dtype=torch.int64)[:, None] * n
    picked = rows.reshape((d * n,) + rows.shape[2:]).index_select(
        0, flat.reshape(-1))
    return picked.reshape(idx.shape + rows.shape[2:])


def vector_bytes(row_bytes: int, *addresses: int) -> int:
    """V: the largest of 16, 8, 4, 2, 1 bytes that divides ``row_bytes``
    and every address (the rows' and the output's bases)."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(a % v == 0 for a in addresses):
            return v
    return 1


def pieces(d: int, k: int, limit: int = MAX_ROWS
           ) -> List[Tuple[int, int, int, int]]:
    """The launches of a gather of ``d`` shards by ``k`` indices, each of
    at most ``limit`` output rows: ``(first shard, shards, first index,
    indices)``; whole shards where one fits, else runs of one shard's
    indices."""
    if d * k <= limit:
        return [(0, d, 0, k)]
    if k <= limit:
        step = limit // k
        return [(d0, min(step, d - d0), 0, k) for d0 in range(0, d, step)]
    return [(d0, 1, k0, min(limit, k - k0))
            for d0 in range(d) for k0 in range(0, k, limit)]


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    return bind(_KERNEL, SIGNATURES)


def _check(rows: torch.Tensor, idx: torch.Tensor) -> None:
    """What the kernel takes, or raise."""
    if rows.dim() < 2 or idx.dim() != 2 or idx.shape[0] != rows.shape[0]:
        raise ValueError(f"rows must be [D, N, ...] and idx [D, K], got "
                         f"{tuple(rows.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in INDEX_DTYPES:
        raise TypeError(f"row_gather takes int32 or int64 indices, got "
                        f"{idx.dtype}")
    if rows.device != idx.device:
        raise ValueError(f"rows and idx must share a device, got "
                         f"{rows.device} and {idx.device}")


def row_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows [D, N, ...]`` gathered per shard by ``idx [D, K]`` (int32 or
    int64, entries in ``[0, N)``) -> ``[D, K, ...]`` of ``rows``' dtype.
    Launches on the current stream and reads nothing back to the host;
    an index out of range stops the kernel (as ``index_select``'s device
    assert does)."""
    global LAUNCHES
    _check(rows, idx)
    if not rows.is_cuda:
        if rows.device.type == "cpu":
            return row_gather_plain(rows, idx)
        raise ValueError(f"row_gather runs on cuda or cpu, not "
                         f"{rows.device}")
    rows, idx = rows.contiguous(), idx.contiguous()
    d, n, k = rows.shape[0], rows.shape[1], idx.shape[1]
    out = torch.empty(idx.shape + rows.shape[2:], dtype=rows.dtype,
                      device=rows.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise IndexError("row_gather: indices into an empty dimension")
    row_bytes = math.prod(rows.shape[2:]) * rows.element_size()
    index_bytes = idx.element_size()
    v = vector_bytes(row_bytes, rows.data_ptr(), out.data_ptr())
    lib = _library()
    stream = torch._C._cuda_getCurrentRawStream(rows.get_device())
    for d0, nd, k0, nk in pieces(d, k):
        first = d0 * k + k0
        err = lib.row_gather_launch(
            rows.data_ptr() + d0 * n * row_bytes,
            idx.data_ptr() + first * index_bytes,
            out.data_ptr() + first * row_bytes,
            nd, n, nk, row_bytes, index_bytes, v, stream)
        if err != 0:
            raise RuntimeError("row_gather launch failed: "
                               + lib.row_gather_error_string(err).decode())
        LAUNCHES += 1
        SHAPES[(row_bytes, v)] = SHAPES.get((row_bytes, v), 0) + 1
    return out
