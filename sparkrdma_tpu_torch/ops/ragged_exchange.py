"""Ragged all-to-all: the ``native`` transport of the ragged exchange.

The JAX package's ``native`` transport is one XLA collective,
``lax.ragged_all_to_all`` (``sparkrdma_tpu/parallel/exchange.py``,
``ragged_exchange_shard``): each (source i, destination j) pair moves as
one contiguous run of rows, with no slots, no padding and no pack. Over
the port's virtual mesh all D shards share one card's memory, so the same
function is one copy of D*D ragged runs, done by the CUDA kernel
``ragged_all_to_all_launch`` in ``csrc/ring_exchange.cu`` (its section
says what bounds it and how the design follows): the ring's load/store
body, run over each pair's own length and bases.

``ragged_all_to_all`` is the wrapper: a CUDA tensor always reaches the
kernel (or an exception); a CPU tensor takes ``ragged_all_to_all_plain``,
the plain PyTorch version that the CPU tests and the on-card comparison
use. ``LAUNCHES`` counts kernel launches and ``SHAPES`` counts them per
shape ``(D, cap, W, out_cap)``.

Unlike the JAX function, both write into ``output`` in place and return
it: every caller builds ``output`` for one exchange and reads it only as
the result. A caller that reuses its buffer clones it first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sparkrdma_tpu_torch.ops.ring_exchange import MAX_SHARDS, _library

LAUNCHES = 0
SHAPES: Dict[Tuple[int, ...], int] = {}


def ragged_all_to_all_plain(data: torch.Tensor, mat: torch.Tensor,
                            output: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, one slice copy per pair
    with the counts read on the host: rows ``[start[i, j], start[i, j] +
    mat[i, j])`` of ``data[i]`` land at rows ``[land[i, j], ...)`` of
    ``output[j]``, ``start`` the exclusive prefix of ``mat`` along dim 1,
    ``land[i, j]`` that of ``mat[:, j]`` over sources. Rows past a
    source's capacity are not read, rows at or past ``output``'s
    capacity not written, and a negative count counts as 0, as in the
    kernel. Writes ``output`` in place and returns it."""
    d, cap = data.shape[0], data.shape[1]
    out_cap = output.shape[1]
    m = mat.to("cpu", torch.int64).clamp(min=0).tolist()
    for j in range(d):
        land = 0
        for i in range(d):
            start = sum(m[i][:j])
            rows = min(m[i][j], cap - start, out_cap - land)
            if rows > 0:
                output[j, land:land + rows] = data[i, start:start + rows]
            land += m[i][j]
    return output


def _check(data: torch.Tensor, mat: torch.Tensor,
           output: torch.Tensor) -> None:
    """What the kernel takes, or raise."""
    if data.dtype != torch.int32 or output.dtype != torch.int32:
        raise TypeError(f"ragged_all_to_all moves int32 words, got "
                        f"{data.dtype} -> {output.dtype}")
    if data.dim() != 3 or output.dim() != 3:
        raise ValueError(f"data and output must be [D, cap, W] and [D, "
                         f"out_cap, W], got {tuple(data.shape)} and "
                         f"{tuple(output.shape)}")
    d, _, w = data.shape
    if output.shape[0] != d or output.shape[2] != w:
        raise ValueError(f"output {tuple(output.shape)} does not match "
                         f"data {tuple(data.shape)} in D and W")
    if tuple(mat.shape) != (d, d) or mat.dtype != torch.int32:
        raise ValueError(f"mat must be int32[{d}, {d}], got {mat.dtype}"
                         f"{list(mat.shape)}")
    if d > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards, got {d}")
    if not (data.device == mat.device == output.device):
        raise ValueError(f"data, mat and output must share a device, got "
                         f"{data.device}, {mat.device}, {output.device}")
    if not (data.is_contiguous() and mat.is_contiguous()
            and output.is_contiguous()):
        raise ValueError("data, mat and output must be contiguous")


def ragged_all_to_all(data: torch.Tensor, mat: torch.Tensor,
                      output: torch.Tensor) -> torch.Tensor:
    """Ragged all-to-all of every shard at once, written into ``output``.

    ``data: int32[D, cap, W]``, shard i's rows grouped by destination;
    ``mat: int32[D, D]``, ``mat[i, j]`` rows shard i sends to shard j;
    ``output: int32[D, out_cap, W]``. Returns ``output``, which now holds
    each receiver's rows grouped by source (``ragged_all_to_all_plain``
    says exactly what is written). Launches on the current stream and
    reads nothing back to the host."""
    global LAUNCHES
    if not data.is_cuda:
        if data.device.type == "cpu":
            return ragged_all_to_all_plain(data, mat, output)
        raise ValueError(f"ragged_all_to_all runs on cuda or cpu, not "
                         f"{data.device}")
    _check(data, mat, output)
    if data.numel() == 0 or output.numel() == 0:
        return output
    d, cap, w = data.shape
    out_cap = output.shape[1]
    lib = _library()
    book = torch.empty((3, d, d), dtype=torch.int64, device=data.device)
    stream = torch._C._cuda_getCurrentRawStream(data.get_device())
    err = lib.ragged_all_to_all_launch(
        data.data_ptr(), output.data_ptr(), mat.data_ptr(), book.data_ptr(),
        d, cap, out_cap, w, stream)
    if err != 0:
        raise RuntimeError("ragged_all_to_all launch failed: "
                           + lib.ring_all_to_all_error_string(err).decode())
    LAUNCHES += 1
    shape = (d, cap, w, out_cap)
    SHAPES[shape] = SHAPES.get(shape, 0) + 1
    return output
