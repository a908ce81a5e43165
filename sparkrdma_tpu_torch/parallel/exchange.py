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

* ``"ring"`` — fixed per-pair slots moved by the hand-written ring
  all-to-all kernel (``ops.ring_exchange``); pair skew past a slot trips
  the overflow flag.
* ``"dense"`` — the same slots moved by a swap of the two leading axes
  (the ``lax.all_to_all`` of the JAX package).
* ``"gather"`` — direct compaction of each source's segment, the
  semantics of the JAX ``all_gather`` + mask-compaction oracle.
* ``"native"`` — ``lax.ragged_all_to_all`` in the JAX package. It has no
  single-card meaning and waits for the multi-process port; asking for it
  raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from sparkrdma_tpu_torch.ops.ring_exchange import ring_all_to_all
from sparkrdma_tpu_torch.parallel.mesh import take_rows

# Host-side dispatch tally for the data plane: callers that launch an
# exchange record here so tests can assert that a job's rows crossed the
# mesh.
DATA_PLANE = {"exchanges": 0, "rows": 0}
_DATA_PLANE_LOCK = threading.Lock()

TRANSPORTS = ("ring", "dense", "gather")


def record_exchange(rows: int) -> None:
    """Tally one dispatched exchange moving ``rows`` rows."""
    with _DATA_PLANE_LOCK:
        DATA_PLANE["exchanges"] += 1
        DATA_PLANE["rows"] += int(rows)


def _exclusive_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def _trail(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask [D, N]`` reshaped to broadcast over ``like``'s row axes."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 2))


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
    """``auto`` -> ``ring`` on ``cuda`` and ``gather`` on the CPU (as the
    JAX package resolves ``auto`` to ``gather`` off the TPU). ``device``
    is a ``torch.device`` or a ``VirtualMesh``.

    On one card every transport is a device-local copy; ``ring`` is the
    one with a kernel of its own, so it is the card's default. ``native``
    (``lax.ragged_all_to_all``) has no single-card meaning and raises
    ``NotImplementedError`` until the multi-process port."""
    if impl == "native":
        raise NotImplementedError(
            "impl='native' is lax.ragged_all_to_all across devices; it has "
            "no single-card meaning and waits for the multi-process port")
    if impl != "auto":
        if impl not in TRANSPORTS:
            raise ValueError(f"unknown exchange impl {impl!r}")
        return impl
    dev = torch.device(getattr(device, "device", device))
    return "ring" if dev.type == "cuda" else "gather"


def resolve_transport(device, impl: str) -> str:
    """The resolution every step builder shares. The JAX package passes
    ring transports through unprobed and probes the rest; with no
    compiler probe on one card this is ``resolve_impl``."""
    return resolve_impl(device, impl)


def ragged_exchange_shard(data: torch.Tensor, send_counts: torch.Tensor,
                          output: Optional[torch.Tensor] = None,
                          impl: str = "auto",
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
        (defaults to zeros shaped like ``data``); supplies the rows past
        each shard's received total.
      impl: ``ring``, ``dense``, ``gather`` or ``auto`` (see
        ``resolve_impl``). Identical results whenever the slots fit.

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
        output = torch.zeros_like(data)
    if impl in ("dense", "ring") and output.shape[1] < n:
        # q = out_cap // D would be zero: no slot can carry even one row;
        # gather handles any capacity
        impl = "gather"
    recv_sizes = mat.t()
    pair_overflow = torch.zeros(n, dtype=torch.bool, device=data.device)
    if impl == "dense":
        received, recv_sizes, pair_overflow = _dense_exchange(
            data, mat, output)
    elif impl == "ring":
        received, recv_sizes, pair_overflow = _ring_exchange(
            data, mat, output)
    else:
        received = _gather_exchange(data, mat, output)
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
                   output: torch.Tensor, move):
    """Fixed-slot exchange, shared by ``_dense_exchange`` and
    ``_ring_exchange``, which differ only in ``move`` (the ``[D, D, q,
    ...]`` block transpose): every (src, dst) pair owns ``q =
    out_capacity // D`` slot rows. Exact whenever no pair exceeds its
    slot; a pair overflow is the third return value, and receive counts
    are always the TRUE per-source counts."""
    n = mat.shape[0]
    q = output.shape[1] // n
    with record_function("exchange.slot_fill"):
        send, _, _, _ = _slot_fill(data, _exclusive_cumsum(mat, dim=1), mat,
                                   n, q)
    with record_function("exchange.transport"):
        got = move(send.reshape((n, n, q) + data.shape[2:]))
    recv_true = mat.t()
    with record_function("exchange.pack"):
        received = _pack_by_source(got, torch.clamp(recv_true, max=q),
                                   output)
    return received, recv_true, (recv_true > q).any(dim=1)


def _dense_exchange(data: torch.Tensor, mat: torch.Tensor,
                    output: torch.Tensor):
    """Fixed slots moved by a swap of the two leading axes (the JAX
    package's ``lax.all_to_all``)."""
    return _slot_exchange(data, mat, output, lambda b: b.transpose(0, 1))


def _ring_exchange(data: torch.Tensor, mat: torch.Tensor,
                   output: torch.Tensor):
    """The same slots, moved by the ring all-to-all kernel."""
    return _slot_exchange(data, mat, output, _ring_move_blocks)


def _gather_exchange(data: torch.Tensor, mat: torch.Tensor,
                     output: torch.Tensor) -> torch.Tensor:
    """The JAX oracle gathers every shard's rows and keeps, stably, those
    addressed to it: source j's segment ``[start[j, d], start[j, d] +
    mat[j, d])`` for receiver d, in source order. On one card that is a
    direct compaction, with no D-fold gather and no argsort."""
    d, cap = data.shape[0], data.shape[1]
    out_cap = output.shape[1]
    rc = mat.t().to(torch.int64)                       # [receiver, source]
    start = _exclusive_cumsum(mat.to(torch.int64), dim=1).t()
    off = _exclusive_cumsum(rc, dim=1)
    cum = torch.cumsum(rc, dim=1)
    pos = torch.arange(out_cap, device=data.device).expand(d, out_cap)
    src = torch.clamp(torch.searchsorted(cum, pos.contiguous(), right=True),
                      max=d - 1)
    row = torch.clamp(start.gather(1, src) + pos - off.gather(1, src),
                      0, cap - 1)
    flat = (src * cap + row).reshape(-1)
    picked = data.reshape((d * cap,) + data.shape[2:]).index_select(0, flat)
    picked = picked.reshape((d, out_cap) + data.shape[2:])
    mask = pos < cum[:, -1:]
    return torch.where(_trail(mask, picked), picked, output)


def group_by_destination(data: torch.Tensor, dest: torch.Tensor,
                         num_partitions: int,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable per-shard grouping of rows by destination partition.

    ``data [D, cap, ...]``, ``dest [D, cap]``; rows with ``dest < 0`` or
    ``dest >= num_partitions`` are padding: they sort to the end and
    don't count. Returns ``(grouped_rows, counts int32[D,
    num_partitions])``."""
    dest = dest.to(torch.int64)
    dest = torch.where((dest < 0) | (dest >= num_partitions),
                       num_partitions, dest)
    _, order = torch.sort(dest, dim=1, stable=True)
    grouped = take_rows(data, order)
    counts = torch.zeros((dest.shape[0], num_partitions + 1),
                         dtype=torch.int64, device=dest.device)
    counts.scatter_add_(1, dest, torch.ones_like(dest))
    return grouped, counts[:, :num_partitions].to(torch.int32)


def shuffle_shard(data: torch.Tensor, dest: torch.Tensor,
                  output: Optional[torch.Tensor] = None,
                  impl: str = "auto"):
    """Full shuffle step of every shard: group locally by destination
    shard, then ragged-exchange. Returns ``(received, recv_counts,
    recv_offsets, overflowed)`` — see ``ragged_exchange_shard``."""
    grouped, counts = group_by_destination(data, dest, data.shape[0])
    return ragged_exchange_shard(grouped, counts, output, impl)
