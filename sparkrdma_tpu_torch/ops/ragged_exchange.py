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

Across processes (a ``parallel.mesh.GlobalMesh``) the wrapper is
``ragged_all_to_all_peers``: each process launches the kernel's range
form (``ragged_all_to_all_launch_range``) over its own source shards
with the whole ``[G, G]`` count matrix, and each pair's rows are written
once, through CUDA IPC peer pointers, into the receive arena of the
process that holds the receiver (``ring_exchange.PeerArena``, which the
ring shares); after the closing fence each process copies its receivers'
rows out of its arena into ``output``. On the CPU it takes
``ragged_all_to_all_peers_plain``, one ``all_to_all_single`` with split
sizes over the process group. Its launches count in ``LAUNCHES`` and in
``SHAPES`` per ``(Dl, G, cap, W, out_cap)``. Both forms copy the
received rows into ``output`` inside one ``exchange.arena_copy`` span
and, while profiled, count those rows' bytes, read and written, in
``exchange.arena_copy_bytes``; on ``cuda`` the host nanoseconds of the
fences add to ``exchange.fence_ns``.

Unlike the JAX function, all of them write into ``output`` in place and
return it: every caller builds ``output`` for one exchange and reads it
only as the result. A caller that reuses its buffer clones it first.
"""

from __future__ import annotations

import ctypes
import math
import time
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.ops.ring_exchange import (
    MAX_SHARDS,
    _fill_bases,
    _library,
)
from sparkrdma_tpu_torch.utils import trace as trace_mod

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


def _book(g: int, device) -> torch.Tensor:
    """The launch's scratch: counts, starts and lands of the ``[g, g]``
    matrix, as the kernel fills them."""
    return torch.empty((3, g, g), dtype=torch.int64, device=device)


def _check(data: torch.Tensor, mat: torch.Tensor, output: torch.Tensor,
           g: int = 0) -> None:
    """What the kernel takes, or raise: ``g`` receivers of ``mat``
    (default the ``D`` of ``data``)."""
    if data.dtype != torch.int32 or output.dtype != torch.int32:
        raise TypeError(f"ragged_all_to_all moves int32 words, got "
                        f"{data.dtype} -> {output.dtype}")
    if data.dim() != 3 or output.dim() != 3:
        raise ValueError(f"data and output must be [D, cap, W] and [D, "
                         f"out_cap, W], got {tuple(data.shape)} and "
                         f"{tuple(output.shape)}")
    d, _, w = data.shape
    g = g or d
    if output.shape[0] != d or output.shape[2] != w:
        raise ValueError(f"output {tuple(output.shape)} does not match "
                         f"data {tuple(data.shape)} in D and W")
    if tuple(mat.shape) != (g, g) or mat.dtype != torch.int32:
        raise ValueError(f"mat must be int32[{g}, {g}], got {mat.dtype}"
                         f"{list(mat.shape)}")
    if g > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards, got {g}")
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
    book = _book(d, data.device)
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


# -- across processes: the range launch into peers' receive arenas ---------

def ragged_all_to_all_peers_plain(data: torch.Tensor, mat: torch.Tensor,
                                  output: torch.Tensor, mesh
                                  ) -> torch.Tensor:
    """The cross-process ragged all-to-all in plain PyTorch: one
    ``all_to_all_single`` with split sizes over the mesh's control group.
    ``data [Dl, cap, ...]`` are this process's shards, ``mat [G, G]`` the
    whole count matrix; the send side is this process's rows grouped by
    destination process (each source shard's segment for that process's
    shards is contiguous); the receive side arrives (source process,
    source shard, receiver) major and is regrouped per receiver by
    source into ``output [Dl, out_cap, ...]``, past ``out_cap``
    truncated, rows past each total kept. Writes ``output`` in place and
    returns it."""
    p, dl, g = mesh.num_processes, mesh.local_shards, mesh.num_shards
    lo = mesh.first_shard
    m = mat.to("cpu", torch.int64).numpy()
    cap, out_cap = data.shape[1], output.shape[1]
    mine = m[lo:lo + dl]                                 # [Dl src, G dst]
    starts = np.cumsum(mine, axis=1) - mine
    send_idx, in_splits = [], []
    for q in range(p):
        n = 0
        for d in range(dl):
            k = int(mine[d, q * dl:(q + 1) * dl].sum())
            first = d * cap + int(starts[d, q * dl])
            send_idx.append(np.arange(first, first + k))
            n += k
        in_splits.append(n)
    to_me = m[:, lo:lo + dl]                             # [G src, Dl dst]
    out_splits = [int(to_me[q * dl:(q + 1) * dl].sum()) for q in range(p)]
    dev = data.device
    flat = data.reshape((dl * cap,) + data.shape[2:])
    send = flat.index_select(0, torch.from_numpy(
        np.concatenate(send_idx).astype(np.int64)).to(dev))
    recv = torch.empty((sum(out_splits),) + data.shape[2:],
                       dtype=data.dtype, device=dev)
    dist.all_to_all_single(recv, send, out_splits, in_splits,
                           group=mesh.group)
    # block (source i, receiver e) sits at the (i, e)-major prefix sum
    block_off = (np.cumsum(to_me.reshape(-1)) - to_me.reshape(-1)).reshape(
        g, dl)
    copied = 0
    with trace_mod.span("exchange.arena_copy"):
        for e in range(dl):
            idx = np.concatenate([np.arange(block_off[i, e],
                                            block_off[i, e] + to_me[i, e])
                                  for i in range(g)])[:out_cap]
            if len(idx):
                output[e, :len(idx)] = recv.index_select(
                    0, torch.from_numpy(idx.astype(np.int64)).to(dev))
            copied += len(idx)
    _count_copy_out(output, copied)
    return output


def _count_copy_out(output: torch.Tensor, rows: int) -> None:
    """While profiled, add to ``exchange.arena_copy_bytes`` the bytes of
    the ``rows`` received rows copied out into ``output``, each read once
    and written once."""
    if trace_mod.counting():
        row_bytes = math.prod(output.shape[2:]) * output.element_size()
        trace_mod.count("exchange.arena_copy_bytes", rows * 2 * row_bytes)


def _ragged_peer_pointer_table(data: torch.Tensor, arena_bases: Sequence[int],
                               out_cap: int) -> Tuple[List[int], List[int]]:
    """The range launch's bases for contiguous ``data [Dl, cap, W]`` (this
    process's ``Dl`` source shards) and the receive arenas ``arena_bases``
    of the ``P`` processes, each ``[Dl, out_cap, W]``: local source ``i``
    sends from ``src[i]``, ``i * cap*W*itemsize`` bytes past the start of
    ``data``, and global shard ``j`` of ``G = P * Dl`` receives at
    ``dst[j]``, shard ``j % Dl`` of process ``j // Dl``'s arena, ``(j %
    Dl) * out_cap*W*itemsize`` bytes past its base (the receiver's
    capacity, the same in every process). Raises past ``MAX_SHARDS``
    shards."""
    dl, cap, w = data.shape
    g = dl * len(arena_bases)
    if g > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards (the kernel's "
                         f"pointer table), got {g}")
    item = data.element_size()
    src0 = data.data_ptr()
    return ([src0 + i * cap * w * item for i in range(dl)],
            [arena_bases[j // dl] + (j % dl) * out_cap * w * item
             for j in range(g)])


def _launch_range(data: torch.Tensor, mat: torch.Tensor, book: torch.Tensor,
                  src: Sequence[int], dst: Sequence[int], src_begin: int,
                  out_cap: int) -> None:
    """One range launch over sources ``[src_begin, src_begin + len(src))``
    of ``len(dst)``, with the given bases, on the current stream; raises
    if it did not launch."""
    lib = _library()
    bases = _fill_bases(src, dst)
    _, cap, w = data.shape
    stream = torch._C._cuda_getCurrentRawStream(data.get_device())
    err = lib.ragged_all_to_all_launch_range(
        ctypes.addressof(bases), len(dst), src_begin, len(src),
        mat.data_ptr(), book.data_ptr(), cap, out_cap, w, stream)
    if err != 0:
        raise RuntimeError("ragged_all_to_all range launch failed: "
                           + lib.ring_all_to_all_error_string(err).decode())


def _agree(mesh, cap: int, out_cap: int, w: int, m: np.ndarray) -> None:
    """Every process's ``cap``, ``out_cap``, ``W`` and count matrix, in one
    all-gather over the control group (the exchange's opening barrier):
    raises on every process alike unless they agree, and unless each
    source's counts fit in its ``cap`` rows (the copy-out reads each
    receiver's prefix, so it must hold no unwritten row)."""
    mine = torch.tensor([cap, out_cap, w, zlib.crc32(m.tobytes())],
                        dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(mesh.num_processes)]
    dist.all_gather(every, mine, group=mesh.group)
    seen = {tuple(t.tolist()) for t in every}
    if len(seen) != 1:
        raise ValueError(
            "ragged_all_to_all_peers: the processes disagree on (cap, "
            f"out_cap, W, crc32 of the counts): {sorted(seen)}")
    if (np.maximum(m, 0).sum(axis=1) > cap).any():
        raise ValueError(f"ragged_all_to_all_peers: a source sends more "
                         f"than its {cap} rows")


def ragged_all_to_all_peers(data: torch.Tensor, mat: torch.Tensor,
                            output: torch.Tensor, mesh) -> torch.Tensor:
    """Ragged all-to-all across the processes of ``mesh`` (a
    ``GlobalMesh``), written into ``output``.

    ``data: int32[Dl, cap, W]``, this process's source shards (global
    shards ``mesh.first_shard + i``), each grouped by destination;
    ``mat: int32[G, G]``, the whole count matrix (rows by global source),
    the same on every process; ``output: int32[Dl, out_cap, W]``, this
    process's receivers. Returns ``output`` holding what
    ``ragged_all_to_all_plain`` over every process's shards gives for the
    local receivers: each receiver's first ``min(total, out_cap)`` rows,
    grouped by source; rows past that keep their values.

    Collective: every process calls it with the same ``cap``, ``out_cap``,
    ``W`` and ``mat`` (checked; raises on every process alike). On
    ``cuda`` the exchange is fenced by the control group: this process's
    stream synchronised and an all-gather of the shapes (every arena no
    longer read), the arenas grown to ``[Dl, out_cap, W]`` in lockstep,
    this process's range launch into every arena, a stream
    synchronisation and a barrier (every write landed), then the copy of
    its receivers' rows out of its own arena, which the ring shares: no
    arena view leaves the function. A failed IPC open or launch raises;
    no row goes through a collective."""
    global LAUNCHES
    if not data.is_cuda:
        if data.device.type == "cpu":
            return ragged_all_to_all_peers_plain(data, mat, output, mesh)
        raise ValueError(f"ragged_all_to_all_peers runs on cuda or cpu, "
                         f"not {data.device}")
    g, dl, lo = mesh.num_shards, mesh.local_shards, mesh.first_shard
    _check(data, mat, output, g)
    if data.shape[0] != dl:
        raise ValueError(f"data must hold this process's {dl} shards, got "
                         f"{tuple(data.shape)}")
    _, cap, w = data.shape
    out_cap = output.shape[1]
    stream = torch.cuda.current_stream(data.device)
    opened = time.perf_counter_ns()
    stream.synchronize()                 # this process's arena reads done
    m = mat.cpu().numpy()
    _agree(mesh, cap, out_cap, w, m)
    fence_ns = time.perf_counter_ns() - opened
    arena = mesh.arena
    arena.ensure(max(4, dl * out_cap * w * 4))
    if data.numel() and output.numel():
        src, dst = _ragged_peer_pointer_table(data, arena.bases, out_cap)
        _launch_range(data, mat, _book(g, data.device), src, dst, lo,
                      out_cap)
        LAUNCHES += 1
        shape = (dl, g, cap, w, out_cap)
        SHAPES[shape] = SHAPES.get(shape, 0) + 1
    closing = time.perf_counter_ns()
    stream.synchronize()
    dist.barrier(group=mesh.group)       # every process's writes landed
    fence_ns += time.perf_counter_ns() - closing
    if trace_mod.counting():
        trace_mod.count("exchange.fence_ns", fence_ns)
    totals = np.minimum(np.maximum(m, 0)[:, lo:lo + dl].sum(axis=0),
                        out_cap)
    landed = arena.local((dl, out_cap, w))
    with trace_mod.span("exchange.arena_copy"):
        for e in range(dl):
            n = int(totals[e])
            if n:
                output[e, :n].copy_(landed[e, :n])
    _count_copy_out(output, int(totals.sum()))
    return output
