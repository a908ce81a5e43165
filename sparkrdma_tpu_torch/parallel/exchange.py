"""The data plane: size exchange + ragged all-to-all over the virtual mesh.

Port of ``sparkrdma_tpu/parallel/exchange.py``. The JAX functions run per
shard inside ``shard_map``; these run all D shards at once on
``[D, cap, ...]`` tensors (``parallel.mesh``), so a per-shard ``[cap]``
argument there is a ``[D, cap]`` one here and a per-shard scalar result
is a ``[D]`` one. Results are bit-identical to the JAX package's.

1. **Size exchange** — the JAX ``all_gather`` of each shard's
   ``send_counts`` row builds the D x D count matrix; here the caller's
   ``[D, D]`` ``send_counts`` already is that matrix (``mat[j, i]`` = rows
   shard j sends to shard i).
2. **Data exchange** — the received rows, packed grouped by source.

Transports (``impl``):

* ``"ring"`` — per-pair slots moved by the hand-written ring
  all-to-all kernel (``ops.ring_exchange``); pair skew past a slot trips
  the overflow flag. A slot is ``out_capacity // D`` rows unless the
  caller sizes it (``slot_rows``), as the round drivers do from each
  round's largest pair.
* ``"dense"`` — the same slots moved by a swap of the two leading axes
  (the ``lax.all_to_all`` of the JAX package).
* ``"gather"`` — direct compaction of each source's segment, the
  semantics of the JAX ``all_gather`` + mask-compaction oracle.
* ``"native"`` — ``lax.ragged_all_to_all`` in the JAX package, and as
  there the default on the accelerator: each (source, destination) pair
  moves as one contiguous run of rows, with no slots and no pack. On one
  card (a ``VirtualMesh`` or a plain device) the hand-written ragged
  all-to-all kernel (``ops.ragged_exchange``) copies every pair in one
  launch; over a ``GlobalMesh`` each process launches the same kernel's
  range form over its own sources.

Over a ``GlobalMesh`` (several processes, ``parallel/multihost.py``;
``ragged_exchange_global``) each process passes its own ``[Dl, cap,
...]`` shards and ``[Dl, G]`` counts; the ``[G, G]`` count matrix is
all-gathered over the control group (or handed in by a caller that
counted on the host). ``native`` (``auto`` on ``cuda``) and ``ring``
write through CUDA IPC peer pointers into the other processes' receive
arenas (``ops.ragged_exchange.ragged_all_to_all_peers``,
``ops.ring_exchange.ring_all_to_all_peers``), so their rows stay on the
card whether the processes share one card or not; ``dense`` and
``gather`` run the process group's collectives, which on ``cuda`` need a
group whose backend takes cuda tensors (NCCL, one card per rank). On the
CPU every transport runs over the gloo group.

The chunked exchange (``chunked_exchange`` and its builders, at the end)
moves arbitrarily skewed traffic in bounded rounds of at most ``quota``
rows per (source, destination) pair; its ring rounds are the kernel's
second call site.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from sparkrdma_tpu_torch.ops.dest_partition import dest_partition
from sparkrdma_tpu_torch.ops.ragged_exchange import (
    ragged_all_to_all,
    ragged_all_to_all_peers,
)
from sparkrdma_tpu_torch.ops.ring_exchange import (
    ring_all_to_all,
    ring_all_to_all_peers,
    ring_all_to_all_peers_plain,
)
from sparkrdma_tpu_torch.parallel.mesh import GlobalMesh, take_rows
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

# Host-side dispatch tally for the data plane: callers that launch an
# exchange record here so tests can assert that a job's rows crossed the
# mesh.
DATA_PLANE = {"exchanges": 0, "rows": 0}
_DATA_PLANE_LOCK = threading.Lock()

TRANSPORTS = ("ring", "dense", "gather", "native")


def record_exchange(rows: int) -> None:
    """Tally one dispatched exchange moving ``rows`` rows."""
    with _DATA_PLANE_LOCK:
        DATA_PLANE["exchanges"] += 1
        DATA_PLANE["rows"] += int(rows)


def _count_routed(data: torch.Tensor, mat: torch.Tensor) -> None:
    """While profiled, add to ``exchange.bytes`` the bytes an exchange
    routes: the ``mat.sum()`` rows of ``data`` it sends, each read once
    and written once (one small reduction on the device, no sync)."""
    if trace_mod.counting():
        row_bytes = math.prod(data.shape[2:]) * data.element_size()
        trace_mod.count("exchange.bytes", mat, 2 * row_bytes)


def _exclusive_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def _trail(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask [D, N]`` reshaped to broadcast over ``like``'s row axes."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 2))


def spread_index(valid: torch.Tensor, index: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Flat index into a ``[D * width]`` buffer of ``width`` places per
    shard, for a scatter-add of ``[D, N]`` values: a valid entry goes to
    its shard's place ``index``, an invalid one (whose value the caller
    makes zero) to place ``position % width``. Spreading the no-op adds
    keeps them from queueing as atomics on one address."""
    d, n = valid.shape
    dev = valid.device
    spread = torch.arange(n, device=dev) % width
    return (torch.where(valid, index.to(torch.int64), spread)
            + torch.arange(d, device=dev)[:, None] * width)


def receive_buffer(like: torch.Tensor, rows: int) -> torch.Tensor:
    """The port's one receive buffer: zeros ``[D, rows, ...]`` with
    ``like``'s leading axis, row shape, dtype and device, filled under the
    ``exchange.receive_fill`` span. A transport writes each receiver's
    rows from position 0 on; the zeros are what a receiver holds past its
    received total."""
    with trace_mod.span("exchange.receive_fill"):
        return torch.zeros((like.shape[0], rows) + tuple(like.shape[2:]),
                           dtype=like.dtype, device=like.device)


def _slot_fill(data: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, n: int, q: int):
    """Fill fixed per-destination slots: result ``[D, n*q, ...]`` where
    shard d's slot (j, k) holds its row ``starts[d, j] + k`` when
    ``k < counts[d, j]`` and zeros otherwise."""
    cap = data.shape[1]
    slot = torch.arange(n * q, device=data.device)
    dest_of_slot = torch.clamp(slot // q, max=n - 1)
    within = slot - dest_of_slot * q
    src_idx = starts.to(torch.int64)[:, dest_of_slot] + within
    valid = within < counts[:, dest_of_slot]
    picked = take_rows(
        data, torch.where(valid, torch.clamp(src_idx, max=cap - 1), 0))
    picked.masked_fill_(~_trail(valid, picked), 0)
    return picked, valid, dest_of_slot, within


def _pack_by_source(blocks: torch.Tensor, recv_counts: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
    """Compact per-source slot blocks ``[D, n, q, ...]`` into
    ``base``-shaped packed rows grouped by source (``recv_counts[d, j]
    <= q`` rows from source j, in slot order); ``base`` supplies rows
    past each shard's total.

    The JAX version finds each position's source with an ``[out_len, n]``
    compare matrix; ``searchsorted(cum, pos, right=True)`` gives the
    identical index (the number of inclusive prefix sums <= pos) without
    it."""
    d, n, q = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    out_len = base.shape[1]
    rc = recv_counts.to(torch.int64)
    off = _exclusive_cumsum(rc, dim=1)
    cum = torch.cumsum(rc, dim=1)
    pos = torch.arange(out_len, device=base.device).expand(d, out_len)
    src_of_pos = torch.clamp(
        torch.searchsorted(cum, pos.contiguous(), right=True), max=n - 1)
    flat_idx = src_of_pos * q + torch.clamp(
        pos - off.gather(1, src_of_pos), max=q - 1)
    packed = take_rows(blocks.reshape((d, n * q) + blocks.shape[3:]),
                       flat_idx)
    mask = pos < cum[:, -1:]
    return torch.where(_trail(mask, packed), packed, base)


def resolve_impl(device, impl: str = "auto") -> str:
    """``auto`` -> ``native`` on ``cuda`` and ``gather`` on the CPU, as the
    JAX package resolves ``auto`` to ``native`` on a TPU mesh (one
    process or several) and to ``gather`` off it. ``device`` is a
    ``torch.device``, a ``VirtualMesh`` or a ``GlobalMesh``.

    ``native`` is the ragged all-to-all kernel, which moves each pair's
    rows once and needs no slot: in one launch on one card, and over a
    ``GlobalMesh`` as each process's range launch writing through CUDA
    IPC peer pointers. ``ring`` (the slot layout and the ring kernel)
    stays an explicit ask. Over a ``GlobalMesh`` on ``cuda``, ``dense``
    and ``gather`` move device rows with the process group's collectives,
    so they raise where the mesh has no group whose backend takes cuda
    tensors: rows never detour through host memory in a kernel's
    place."""
    if impl != "auto" and impl not in TRANSPORTS:
        raise ValueError(f"unknown exchange impl {impl!r}")
    dev = torch.device(getattr(device, "device", device))
    if impl == "auto":
        return "native" if dev.type == "cuda" else "gather"
    if (isinstance(device, GlobalMesh) and impl in ("dense", "gather")
            and device.data_group is None):
        raise RuntimeError(
            f"impl={impl!r} moves {dev.type} rows with the process group's "
            "collectives, and this mesh has no group whose backend takes "
            f"{dev.type} tensors (the control group is gloo; NCCL needs "
            "one card per rank, and these ranks share one); use "
            "impl='native' or impl='ring', which write through CUDA IPC "
            "peer pointers")
    return impl


def resolve_transport(device, impl: str) -> str:
    """The resolution every step builder shares: ``ring`` passes through
    unprobed (an explicit ask), the rest goes through ``resolve_impl``,
    as in the JAX package."""
    return impl if impl == "ring" else resolve_impl(device, impl)


def ragged_exchange_shard(data: torch.Tensor, send_counts: torch.Tensor,
                          output: Optional[torch.Tensor] = None,
                          impl: str = "auto",
                          slot_rows: Optional[int] = None,
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Ragged all-to-all of every shard at once.

    Args:
      data: ``[D, capacity, ...]`` rows per shard, grouped by destination
        shard in axis order. Rows beyond ``send_counts[d].sum()`` are
        padding and are not sent (each shard's counts sum to at most
        ``capacity``).
      send_counts: ``[D, D]`` — ``send_counts[d, j]`` rows shard d sends
        to shard j.
      output: optional ``[D, out_capacity, ...]`` receive buffer
        (defaults to ``receive_buffer(data, capacity)``); supplies the
        rows past each shard's received total.
      impl: ``native``, ``ring``, ``dense``, ``gather`` or ``auto`` (see
        ``resolve_impl``). Identical results whenever the slots fit.
        ``native`` writes into ``output`` in place and returns it as
        ``received``.
      slot_rows: rows per (source, destination) slot of the slot
        transports (``ring``, ``dense``); defaults to ``out_capacity //
        D``. A caller that knows the largest pair sizes the slot to it,
        and then only the receive capacity can overflow. ``native`` and
        ``gather`` have no slots and ignore it.

    Returns:
      ``(received, recv_counts, recv_offsets, overflowed)``: ``received
      [D, out_capacity, ...]`` packed grouped by source,
      ``recv_counts[d, j]`` rows shard d received from shard j (int32),
      ``recv_offsets`` their exclusive prefix along dim 1, and
      ``overflowed [D]`` bool: shard d's receive exceeded
      ``out_capacity`` OR (slot transports) some pair into d exceeded
      its slot. Where it is set, ``received`` is truncated and the counts
      stay true.
    """
    impl = resolve_impl(data.device, impl)
    mat = send_counts.to(torch.int32)
    n = mat.shape[0]
    if output is None:
        output = receive_buffer(data, data.shape[1])
    q = slot_rows or output.shape[1] // n
    if impl in ("dense", "ring") and q < 1:
        # a zero-row slot can carry nothing; gather handles any capacity
        impl = "gather"
    recv_sizes = mat.t()
    pair_overflow = torch.zeros(n, dtype=torch.bool, device=data.device)
    if impl == "dense":
        received, recv_sizes, pair_overflow = _dense_exchange(
            data, mat, output, q)
    elif impl == "ring":
        received, recv_sizes, pair_overflow = _ring_exchange(
            data, mat, output, q)
    elif impl == "native":
        with trace_mod.span("exchange.transport"):
            received = _native_exchange(data, mat, output)
    else:
        received = _gather_exchange(data, mat, output)
    _count_routed(data, mat)
    overflowed = pair_overflow | (recv_sizes.sum(dim=1) > output.shape[1])
    return (received, recv_sizes.contiguous(),
            _exclusive_cumsum(recv_sizes, dim=1).to(torch.int32),
            overflowed)


def _ring_move_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Move per-destination blocks ``[D, n, q, ...]`` (block ``[d, j]``
    -> shard j) with the ring all-to-all kernel; returns the per-source
    received blocks, same shape. Rows travel as int32 words (the JAX
    version's 128-lane padding is a Mosaic constraint and not needed)."""
    d, n, q = blocks.shape[:3]
    words = blocks.contiguous().reshape(d, n, q, -1).view(torch.int32)
    got = ring_all_to_all(words)
    return got.view(blocks.dtype).reshape(blocks.shape)


def _slot_exchange(data: torch.Tensor, mat: torch.Tensor,
                   output: torch.Tensor, q: int, move):
    """Fixed-slot exchange, shared by ``_dense_exchange`` and
    ``_ring_exchange``, which differ only in ``move`` (the ``[D, D, q,
    ...]`` block transpose): every (src, dst) pair owns ``q`` slot rows.
    Exact whenever no pair exceeds its slot; a pair overflow is the third
    return value, and receive counts are always the TRUE per-source
    counts."""
    n = mat.shape[0]
    with trace_mod.span("exchange.slot_fill"):
        send, _, _, _ = _slot_fill(data, _exclusive_cumsum(mat, dim=1), mat,
                                   n, q)
    with trace_mod.span("exchange.transport"):
        got = move(send.reshape((n, n, q) + data.shape[2:]))
    recv_true = mat.t()
    with trace_mod.span("exchange.pack"):
        received = _pack_by_source(got, torch.clamp(recv_true, max=q),
                                   output)
    return received, recv_true, (recv_true > q).any(dim=1)


def _dense_exchange(data: torch.Tensor, mat: torch.Tensor,
                    output: torch.Tensor, q: int):
    """Fixed slots moved by a swap of the two leading axes (the JAX
    package's ``lax.all_to_all``)."""
    return _slot_exchange(data, mat, output, q, lambda b: b.transpose(0, 1))


def _ring_exchange(data: torch.Tensor, mat: torch.Tensor,
                   output: torch.Tensor, q: int):
    """The same slots, moved by the ring all-to-all kernel."""
    return _slot_exchange(data, mat, output, q, _ring_move_blocks)


def _native_exchange(data: torch.Tensor, mat: torch.Tensor,
                     output: torch.Tensor) -> torch.Tensor:
    """``lax.ragged_all_to_all`` with the offsets the JAX package derives:
    every pair's rows copied once, as int32 words, by the ragged
    all-to-all kernel (its plain version on the CPU), into ``output``
    (a contiguous copy of it if it is not contiguous), which is
    returned."""
    out = output if output.is_contiguous() else output.contiguous()
    if data.numel() == 0 or out.numel() == 0:
        return out
    d, cap = data.shape[0], data.shape[1]
    words = data.contiguous().reshape(d, cap, -1).view(torch.int32)
    ragged_all_to_all(words, mat.contiguous(),
                      out.reshape(d, out.shape[1], -1).view(torch.int32))
    return out


def _gather_exchange(data: torch.Tensor, mat: torch.Tensor,
                     output: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """The JAX oracle gathers every shard's rows and keeps, stably, those
    addressed to it: source j's segment ``[start[j, d], start[j, d] +
    mat[j, d])`` for receiver d, in source order. On one card that is a
    direct compaction, with no D-fold gather and no argsort. ``data``
    holds every source's rows; the receivers are shards ``[lo, lo +
    len(output))`` (all of them on one card)."""
    d, cap = data.shape[0], data.shape[1]
    nr, out_cap = output.shape[0], output.shape[1]
    rc = mat.t().to(torch.int64)[lo:lo + nr]           # [receiver, source]
    start = _exclusive_cumsum(mat.to(torch.int64), dim=1).t()[lo:lo + nr]
    off = _exclusive_cumsum(rc, dim=1)
    cum = torch.cumsum(rc, dim=1)
    pos = torch.arange(out_cap, device=data.device).expand(nr, out_cap)
    src = torch.clamp(torch.searchsorted(cum, pos.contiguous(), right=True),
                      max=d - 1)
    row = torch.clamp(start.gather(1, src) + pos - off.gather(1, src),
                      0, cap - 1)
    flat = (src * cap + row).reshape(-1)
    picked = data.reshape((d * cap,) + data.shape[2:]).index_select(0, flat)
    picked = picked.reshape((nr, out_cap) + data.shape[2:])
    mask = pos < cum[:, -1:]
    return torch.where(_trail(mask, picked), picked, output)


# -- over a GlobalMesh: the exchange across processes -----------------------

def allgather_host(mesh: GlobalMesh, values: np.ndarray) -> np.ndarray:
    """Every process's ``values`` (same shape everywhere) stacked in rank
    order, over the mesh's control group: ``[P, *values.shape]``."""
    local = torch.from_numpy(np.ascontiguousarray(values))
    parts = [torch.empty_like(local) for _ in range(mesh.num_processes)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.stack(parts).numpy()


def global_slot_rows(mat: np.ndarray, out_capacity: int,
                     capacity: int) -> int:
    """Rows per (source, destination) slot of a global slot exchange,
    from the gathered ``[G, G]`` matrix: the receive buffer's even share
    ``out_capacity // G``, or, where a pair carries more, that pair
    rounded up to a power of two and held to ``capacity`` (the most one
    source shard sends), as ``device_plane._slot_rows`` sizes a round.
    Only a receive past ``out_capacity`` can then overflow."""
    g = mat.shape[0]
    even = out_capacity // g
    top = int(mat.max()) if mat.size else 0
    return even if top <= even else min(capacity, bucket_quota(top))


def _native_global(mesh: GlobalMesh, data: torch.Tensor, mat: torch.Tensor,
                   output: torch.Tensor) -> torch.Tensor:
    """``lax.ragged_all_to_all`` across processes: every pair's rows moved
    once, as int32 words, by ``ragged_all_to_all_peers`` (the ragged
    kernel's range launch into every process's arena on ``cuda``, its
    plain version on the CPU), into ``output`` (a contiguous copy of it
    if it is not contiguous), which is returned. Collective, so it
    returns early on no process."""
    out = output if output.is_contiguous() else output.contiguous()
    dl, cap, out_cap = data.shape[0], data.shape[1], out.shape[1]
    row_bytes = math.prod(data.shape[2:]) * data.element_size()
    words = data.contiguous().view(torch.uint8).reshape(
        dl, cap, row_bytes).view(torch.int32)
    ragged_all_to_all_peers(words, mat.contiguous(), out.view(
        torch.uint8).reshape(dl, out_cap, row_bytes).view(torch.int32),
        mesh)
    return out


def ragged_exchange_global(mesh: GlobalMesh, data: torch.Tensor,
                           send_counts: torch.Tensor,
                           output: Optional[torch.Tensor] = None,
                           impl: str = "auto",
                           slot_rows: Optional[int] = None,
                           counts_host: Optional[np.ndarray] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """``ragged_exchange_shard`` across the processes of ``mesh``.
    Collective: every process calls it with its own shards.

    ``data [Dl, capacity, ...]`` are this process's shards (global shards
    ``mesh.first_shard + d``), grouped by destination in global shard
    order; ``send_counts [Dl, G]`` what each sends to each global shard.
    ``counts_host``, when the caller counted on the host, is the whole
    ``[G, G]`` matrix (rows by global source) and spares the all-gather
    of the device counts. ``slot_rows`` defaults to
    ``global_slot_rows``. While profiled, the host nanoseconds of that
    read and all-gather add to the ``exchange.fence_ns`` counter, as the
    native transport's own fences do.

    Returns the JAX package's per-shard results for the local shards:
    ``received [Dl, out_capacity, ...]`` packed by global source,
    ``recv_counts int32[Dl, G]``, their exclusive prefix and
    ``overflowed bool[Dl]``."""
    impl = resolve_impl(mesh, impl)
    g, dl, lo = mesh.num_shards, mesh.local_shards, mesh.first_shard
    if counts_host is None:
        t0 = time.perf_counter_ns()
        local = send_counts.to("cpu", torch.int64).numpy()
        counts_host = allgather_host(mesh, local).reshape(g, g)
        if trace_mod.counting():
            trace_mod.count("exchange.fence_ns", time.perf_counter_ns() - t0)
    mat_host = np.asarray(counts_host, dtype=np.int64).reshape(g, g)
    mat = torch.from_numpy(mat_host.astype(np.int32)).to(data.device)
    if output is None:
        output = receive_buffer(data, data.shape[1])
    recv_true = mat.t()[lo:lo + dl]
    pair_overflow = torch.zeros(dl, dtype=torch.bool, device=data.device)
    q = max(1, slot_rows or global_slot_rows(mat_host, output.shape[1],
                                             data.shape[1]))
    if impl in ("ring", "dense"):
        with trace_mod.span("exchange.slot_fill"):
            send, _, _, _ = _slot_fill(data, _exclusive_cumsum(
                mat[lo:lo + dl], dim=1), mat[lo:lo + dl], g, q)
        blocks = send.reshape((dl, g, q) + data.shape[2:])
        with trace_mod.span("exchange.transport"):
            if impl == "ring":
                words = blocks.contiguous().reshape(dl, g, q, -1).view(
                    torch.int32)
                got = ring_all_to_all_peers(words, mesh).view(
                    blocks.dtype).reshape(blocks.shape)
            else:
                got = ring_all_to_all_peers_plain(blocks, mesh.data_group,
                                                  mesh.num_processes)
        with trace_mod.span("exchange.pack"):
            received = _pack_by_source(got, torch.clamp(recv_true, max=q),
                                       output)
        pair_overflow = (recv_true > q).any(dim=1)
    elif impl == "gather":
        with trace_mod.span("exchange.transport"):
            parts = [torch.empty_like(data)
                     for _ in range(mesh.num_processes)]
            dist.all_gather(parts, data.contiguous(), group=mesh.data_group)
            received = _gather_exchange(torch.cat(parts), mat, output, lo)
    else:
        with trace_mod.span("exchange.transport"):
            received = _native_global(mesh, data, mat, output)
    _count_routed(data, mat[lo:lo + dl])
    overflowed = pair_overflow | (recv_true.sum(dim=1) > output.shape[1])
    return (received, recv_true.contiguous(),
            _exclusive_cumsum(recv_true, dim=1).to(torch.int32),
            overflowed)


def exchange_over(mesh, data: torch.Tensor, send_counts: torch.Tensor,
                  output: Optional[torch.Tensor] = None, impl: str = "auto",
                  slot_rows: Optional[int] = None,
                  counts_host: Optional[np.ndarray] = None):
    """The ragged exchange over ``mesh``: ``ragged_exchange_global`` on a
    ``GlobalMesh``, ``ragged_exchange_shard`` (one card) otherwise."""
    if isinstance(mesh, GlobalMesh):
        return ragged_exchange_global(mesh, data, send_counts, output, impl,
                                      slot_rows, counts_host)
    return ragged_exchange_shard(data, send_counts, output, impl, slot_rows)


def group_by_destination(data: torch.Tensor, dest: torch.Tensor,
                         num_partitions: int,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable per-shard grouping of rows by destination partition.

    ``data [D, cap, ...]``, ``dest [D, cap]`` (int32 or int64); rows with
    ``dest < 0`` or ``dest >= num_partitions`` are padding: they go to
    the end and don't count. Returns ``(grouped_rows, counts int32[D,
    num_partitions])``.

    The order comes from a counting partition of the destinations
    (``ops/dest_partition.py``), not from a sort, and the row gather
    follows it. The counts are copied out of the partition's totals after
    the gather, so the ``exchange.group`` span closes on a kernel of its
    own and its device range covers the gather. While profiled,
    ``exchange.group_bytes`` counts the bytes the grouping must move:
    each destination read and each index written, then the gather's
    (as ``gather.bytes`` counts them)."""
    with trace_mod.span("exchange.group"):
        order, totals = dest_partition(dest, num_partitions)
        grouped = take_rows(data, order)
        counts = totals[:, :num_partitions].clone()
    if trace_mod.counting():
        row_bytes = math.prod(data.shape[2:]) * data.element_size()
        trace_mod.count("exchange.group_bytes", order.numel() * (
            dest.element_size() + 8 + 2 * row_bytes + 8))
    return grouped, counts


def shuffle_shard(data: torch.Tensor, dest: torch.Tensor,
                  output: Optional[torch.Tensor] = None,
                  impl: str = "auto", mesh=None,
                  counts_host: Optional[np.ndarray] = None):
    """Full shuffle step of every shard: group locally by destination
    shard, then ragged-exchange (across processes when ``mesh`` is a
    ``GlobalMesh``). Returns ``(received, recv_counts, recv_offsets,
    overflowed)`` — see ``ragged_exchange_shard``."""
    shards = mesh.num_shards if mesh is not None else data.shape[0]
    grouped, counts = group_by_destination(data, dest, shards)
    return exchange_over(mesh, grouped, counts, output, impl,
                         counts_host=counts_host)


def shuffle_into(rows: torch.Tensor, dest: torch.Tensor, capacity: int,
                 impl: str) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One shuffle of ``rows [D, N, ...]`` to ``dest [D, N]`` (``dest <
    0``: not sent) into a receive buffer of ``capacity`` rows a shard.
    Returns ``(received [D, capacity, ...], valid bool[D, capacity],
    overflowed bool[D])``: ``valid`` marks each shard's received rows,
    which come first."""
    received, recv_counts, _, overflowed = shuffle_shard(
        rows, dest, output=receive_buffer(rows, capacity), impl=impl)
    valid = (torch.arange(capacity, device=rows.device)
             < recv_counts.sum(dim=1, keepdim=True))
    return received, valid, overflowed


@functools.lru_cache(maxsize=64)
def make_shuffle_exchange(mesh, impl: str = "auto", out_factor: int = 1):
    """The all-shard shuffle exchange over ``mesh`` (a ``VirtualMesh`` or
    a ``GlobalMesh``), memoized per ``(mesh, impl, out_factor)`` as the
    JAX function is, so per-job callers share one.

    Returns ``exchange(data [D, capacity, ...], dest [D, capacity]) ->
    (received [D, capacity * out_factor, ...], recv_counts int32[D, D],
    recv_offsets int32[D, D], overflowed bool[D])``; ``overflowed[d]`` is
    shard d's receive-overflow flag (capacity or slot pair): check it
    before trusting ``received``. ``out_factor`` scales each shard's
    receive capacity against its send capacity, since a receiver may net
    more rows than it sent (skew). Over a ``GlobalMesh`` ``D`` is the
    process's ``local_shards``, the counts are ``[Dl, G]``, and
    ``exchange`` takes ``counts_host``, the ``[G, G]`` matrix when the
    caller counted it on the host (``ragged_exchange_global``)."""
    impl = resolve_transport(mesh, impl)
    global_mesh = mesh if isinstance(mesh, GlobalMesh) else None

    def exchange(data: torch.Tensor, dest: torch.Tensor,
                 counts_host: Optional[np.ndarray] = None):
        output = receive_buffer(data, data.shape[1] * out_factor)
        return shuffle_shard(data, dest.reshape(data.shape[:2]), output,
                             impl, global_mesh, counts_host)

    return exchange


# -- the chunked exchange: bounded rounds at any skew -----------------------

def bucket_quota(quota: int) -> int:
    """Round ``quota`` up to the next power of two. In the JAX package this
    is the memoization bucket of the compiled round builders; the port
    compiles nothing, but the bucketed quota is each round's per-pair
    block length and so sets the round count ``chunked_exchange``
    returns."""
    return 1 << max(0, int(quota) - 1).bit_length()


def _chunked_round(grouped: torch.Tensor, counts: torch.Tensor,
                   round_idx: int, quota: int, impl: str,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunked round of every shard: round r moves the slice
    ``[start + r*quota, start + min((r+1)*quota, count))`` of each
    destination segment. ``grouped [D, cap, ...]`` is destination-grouped
    with ``counts[s, d]`` rows from shard s to shard d. Returns this
    round's ``received [D, D*quota, ...]`` packed grouped by source and
    ``recv_counts int32[D, D]`` (``[receiver, source]``)."""
    n = counts.shape[0]
    counts = counts.to(torch.int64)
    lo = torch.clamp(counts, max=round_idx * quota)
    send_counts = torch.minimum(lo + quota, counts) - lo
    with trace_mod.span("chunked.slot_fill"):
        filled, _, _, _ = _slot_fill(
            grouped, _exclusive_cumsum(counts, dim=1) + lo, send_counts, n,
            quota)
    blocks = filled.reshape((n, n, quota) + grouped.shape[2:])
    recv_counts = send_counts.t().to(torch.int32).contiguous()
    if impl == "ring":
        # the send rows already sit in [D, quota] blocks: the ring's fixed
        # block shape IS the quota, so no send-side compaction
        with trace_mod.span("chunked.transport"):
            got = _ring_move_blocks(blocks)
        with trace_mod.span("chunked.pack"):
            received = _pack_by_source(
                got, recv_counts, receive_buffer(filled, filled.shape[1]))
        return received, recv_counts
    # collective transports take a compact destination-grouped send
    # buffer: the slot blocks packed by destination (rows past the total
    # stay zero, as the JAX scatter leaves them)
    with trace_mod.span("chunked.pack"):
        send_buf = _pack_by_source(blocks, send_counts,
                                   torch.zeros_like(filled))
    with trace_mod.span("chunked.transport"):
        # per-pair counts <= quota and the receive capacity is D*quota,
        # so the overflow flag cannot trip and is dropped, as in JAX
        received, recv_counts, _, _ = ragged_exchange_shard(
            send_buf, send_counts, impl=impl)
    return received, recv_counts


def make_chunked_exchange(mesh, quota: int, impl: str = "auto"):
    """Bounded-round ragged exchange for arbitrary skew over ``mesh`` (a
    ``VirtualMesh``). One round moves at most ``bucket_quota(quota)`` rows
    per (source, destination) pair, so a receiver never nets more than
    ``D * quota`` rows per round however skewed the traffic is.

    Returns ``round_fn(grouped, counts, round_idx) -> (received [D,
    D*quota, ...], recv_counts int32[D, D])`` for destination-grouped
    ``grouped [D, cap, ...]`` with ``counts[s, d]`` rows from s to d (as
    ``group_by_destination`` produces), to be driven over
    ``ceil(max(counts) / bucket_quota(quota))`` rounds. The JAX builder is
    memoized to share compiles; this one has nothing to compile."""
    quota = bucket_quota(quota)
    impl = resolve_transport(mesh, impl)

    def round_fn(grouped: torch.Tensor, counts: torch.Tensor,
                 round_idx: int):
        return _chunked_round(grouped, counts, round_idx, quota, impl)

    return round_fn


def _land(acc: torch.Tensor, received: torch.Tensor, counts: torch.Tensor,
          round_idx: int, quota: int) -> None:
    """Land one round's received rows in ``acc [D, cap_out, ...]`` at their
    final source-major place ``base[src] + lo[src] + w``. Each place is
    landed once in the whole exchange and ``acc`` starts zeroed, so adding
    a row into it is the JAX ``set``; a slot past its source's count adds
    a zero row at a spread place (``spread_index``). That drops it without
    the host sync a filter would need, and never writes past the end.
    Integer adds, so exact."""
    n, cap = acc.shape[0], acc.shape[1]
    dev = acc.device
    to_me = counts.t().to(torch.int64)            # [receiver, source]
    base = _exclusive_cumsum(to_me, dim=1)        # source-major layout
    lo = torch.clamp(to_me, max=round_idx * quota)
    rcnt = torch.minimum(lo + quota, to_me) - lo  # received per source now
    off = _exclusive_cumsum(rcnt, dim=1)          # packed positions
    src = torch.arange(n, device=dev).repeat_interleave(quota)
    w = torch.arange(quota, device=dev).repeat(n)
    valid = w < rcnt[:, src]
    rows = take_rows(received, torch.where(valid, off[:, src] + w, 0))
    rows.masked_fill_(~_trail(valid, rows), 0)
    flat = spread_index(valid, base[:, src] + lo[:, src] + w, cap)
    acc.view((n * cap,) + acc.shape[2:]).index_add_(
        0, flat.reshape(-1), rows.reshape((-1,) + rows.shape[2:]))


def _round_acc(grouped: torch.Tensor, counts: torch.Tensor, round_idx: int,
               acc: torch.Tensor, quota: int, impl: str) -> torch.Tensor:
    """One round of the chunked exchange, landed in ``acc``; ``quota`` is
    bucketed and ``impl`` resolved."""
    received, _ = _chunked_round(grouped, counts, round_idx, quota, impl)
    with trace_mod.span("chunked.land"):
        _land(acc, received, counts, round_idx, quota)
    return acc


def make_chunked_exchange_acc(mesh, quota: int, impl: str = "auto"):
    """``make_chunked_exchange`` with a device-resident accumulator: each
    round lands its received rows straight at their final source-major
    place, so the host loop touches no data.

    Returns ``round_acc(grouped, counts, round_idx, acc) -> acc``, which
    updates ``acc [D, cap_out, ...]`` in place (the JAX version donates
    it). ``acc`` must come zeroed and ``cap_out`` must be ``max_d sum_s
    counts[s, d]``, which the caller knows: it has the count matrix."""
    return functools.partial(_round_acc, quota=bucket_quota(quota),
                             impl=resolve_transport(mesh, impl))


def chunked_exchange_resident(mesh, grouped: torch.Tensor,
                              counts: np.ndarray, quota: int,
                              impl: str = "auto",
                              ) -> Tuple[torch.Tensor, np.ndarray, int]:
    """The chunked exchange with its result left on the device.

    ``grouped [D, cap, ...]`` destination-grouped rows on the mesh's
    device, ``counts [D, D]`` host counts (``counts[s, d]`` rows from s
    to d). Returns ``(acc [D, cap_out, ...], recv_totals [D], rounds)``:
    shard d's received rows are ``acc[d, :recv_totals[d]]``, grouped by
    source in each source's original order.

    The rounds run back to back with no host synchronisation. (The JAX
    driver synchronises every round on XLA:CPU, where a collective parks
    its host thread in a rendezvous; on one card there is no rendezvous.)
    """
    n = mesh.num_shards
    quota = bucket_quota(quota)
    counts_host = np.asarray(counts, dtype=np.int64).reshape(n, n)
    num_rounds = max(1, -(-int(counts_host.max()) // quota))
    recv_totals = counts_host.sum(axis=0)
    cap_out = max(1, int(recv_totals.max()))
    impl = resolve_transport(mesh, impl)
    counts_d = torch.from_numpy(counts_host).to(mesh.device)
    # an accumulator, not a receive buffer: every round adds into it, so
    # all of it must start zero
    acc = torch.zeros((n, cap_out) + tuple(grouped.shape[2:]),
                      dtype=grouped.dtype, device=mesh.device)
    for r in range(num_rounds):
        _round_acc(grouped, counts_d, r, acc, quota, impl)
    record_exchange(int(counts_host.sum()))
    return acc, recv_totals, num_rounds


def chunked_exchange(mesh, grouped: np.ndarray, counts: np.ndarray,
                     quota: int, impl: str = "auto",
                     ) -> Tuple[List[np.ndarray], int]:
    """Host driver of the chunked exchange: ``grouped`` is the JAX
    package's global ``[D*cap, ...]`` array of 4-byte words, sharded on
    axis 0 and destination-grouped per shard, ``counts [D, D]``. Returns
    ``(received_rows_per_shard, rounds)``: each shard's rows grouped by
    source, in the source's original within-destination order (the
    ``ragged_exchange_shard`` contract). ``quota`` is bucketed up to the
    next power of two (``bucket_quota``). The rows cross to the device
    once and back once, one copy per shard at the end."""
    acc, recv_totals, rounds = chunked_exchange_resident(
        mesh, rows_from_numpy(grouped, mesh), counts, quota, impl)
    results = [acc[d, :int(recv_totals[d])].cpu().numpy().view(
        grouped.dtype) for d in range(mesh.num_shards)]
    return results, rounds
