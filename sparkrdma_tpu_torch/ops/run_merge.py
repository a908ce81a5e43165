"""Merge of key-sorted runs: the range step's receive side.

After the range step's exchange each receiver holds S runs back to back,
one a source, each key-sorted: the sources key-sort their rows before the
range split, which is monotone in the key, and every transport packs the
received rows grouped by source. A stable S-way merge of those runs, ties
to the earlier run, is the stable key sort of the whole buffer that
``ops/sort.py``'s ``sort_received`` makes, byte for byte,
pads included. The JAX package sorts there with XLA; here it is the CUDA
kernel ``run_merge_launch`` in ``csrc/run_merge.cu`` (its header says what
bounds it and how the design follows).

``merge_runs(received, recv_counts)`` is the wrapper: a CUDA tensor always
reaches the kernel (or an exception); a CPU tensor takes ``sort_received``
itself, the plain function the kernel is held to. ``LAUNCHES`` counts the
kernel's launches, one a call with rows to merge.

A receiver merges at most ``MAX_RUNS`` (32) runs, one a lane of a warp:
one a source shard, 8 on one card and 8 across HiBench's two executor
processes. Where a slot transport flags a pair past its slot, the runs
it packed are not where the counts say; the kernel's output is then no
merge, and stays in bounds (every row a row of the buffer or a pad row),
and the step's ``overflowed`` flag says so.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sparkrdma_tpu_torch.ops._build import bind
from sparkrdma_tpu_torch.ops.row_gather import vector_bytes
from sparkrdma_tpu_torch.ops.sort import sort_received

LAUNCHES = 0
_KERNEL = "run_merge"

TILE_ROWS = 1024          # kTileRows in csrc/run_merge.cu
MAX_RUNS = 32             # kMaxRuns
MAX_ROWS = 2**31 - 1 - TILE_ROWS   # kMaxRows
# csrc/run_merge.cu's extern "C" functions: name -> (argtypes, restype)
SIGNATURES = {
    "run_merge_launch": (
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p),
        ctypes.c_int),
    "run_merge_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}

def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    return bind(_KERNEL, SIGNATURES)


def _check(received: torch.Tensor, recv_counts: torch.Tensor) -> None:
    """What the kernel takes, or raise: int32 rows ``[D, R, W]`` whose
    single-word u32 key is column 0, and int32 counts ``[D, S]``, S in
    ``[1, MAX_RUNS]``, on one device, both contiguous."""
    if received.dtype != torch.int32 or recv_counts.dtype != torch.int32:
        raise TypeError(f"merge_runs takes int32 rows and counts, got "
                        f"{received.dtype} and {recv_counts.dtype}")
    if (received.dim() != 3 or received.shape[2] < 1
            or recv_counts.dim() != 2
            or recv_counts.shape[0] != received.shape[0]):
        raise ValueError(f"received must be [D, R, W] with the key word in "
                         f"column 0 and recv_counts [D, S], got "
                         f"{tuple(received.shape)} and "
                         f"{tuple(recv_counts.shape)}")
    if not 1 <= recv_counts.shape[1] <= MAX_RUNS:
        raise ValueError(f"merge_runs merges 1 to {MAX_RUNS} runs a "
                         f"receiver, got {recv_counts.shape[1]}")
    if received.shape[1] > MAX_ROWS:
        raise ValueError(f"merge_runs takes at most {MAX_ROWS} rows a "
                         f"receiver, got {received.shape[1]}")
    if received.device != recv_counts.device:
        raise ValueError(f"received and recv_counts must share a device, "
                         f"got {received.device} and {recv_counts.device}")
    if not (received.is_contiguous() and recv_counts.is_contiguous()):
        raise ValueError("merge_runs takes contiguous tensors")


def merge_runs(received: torch.Tensor,
               recv_counts: torch.Tensor) -> torch.Tensor:
    """``received [D, R, W]`` int32, S key-sorted runs a receiver back to
    back (run s: ``recv_counts[d, s]`` rows at their exclusive prefix) ->
    a new ``[D, R, W]``: the runs' stable merge by the u32 key in column 0
    (ties to the lower run, then the lower position), then pad rows (zero,
    key word 0xFFFFFFFF) from the live total on. Launches on the current
    stream and reads nothing back to the host."""
    global LAUNCHES
    _check(received, recv_counts)
    if not received.is_cuda:
        if received.device.type == "cpu":
            return sort_received(received, recv_counts)
        raise ValueError(f"merge_runs runs on cuda or cpu, not "
                         f"{received.device}")
    d, rows, runs = received.shape[0], received.shape[1], recv_counts.shape[1]
    out = torch.empty_like(received)
    if out.numel() == 0:
        return out
    row_bytes = received.shape[2] * received.element_size()
    co = torch.empty((d, math.ceil(rows / TILE_ROWS) + 1, runs),
                     dtype=torch.int32, device=received.device)
    v = vector_bytes(row_bytes, received.data_ptr(), out.data_ptr())
    lib = _library()
    err = lib.run_merge_launch(
        received.data_ptr(), recv_counts.data_ptr(), out.data_ptr(),
        co.data_ptr(), d, rows, runs, row_bytes, v,
        torch._C._cuda_getCurrentRawStream(received.get_device()))
    if err != 0:
        raise RuntimeError("run_merge launch failed: "
                           + lib.run_merge_error_string(err).decode())
    LAUNCHES += 1
    return out
