"""ALS's normal equations for one shard's entities, the Gram of
``models/als.py::solve_item_factors`` (its ``als.gram`` span).

``normal_equations(local_key, other, rating, fixed, entities)`` takes the
shard's rows as three columns: ``local_key`` int64 ``[N]`` (each row's
entity in ``[0, entities)``, as ``searchsorted`` gives it), ``other``
int32 ``[N]`` (the other side's id) and ``rating`` float32 ``[N]`` (both
may be strided views of the received rows), and ``fixed`` float32 ``[M,
k]``, the other side's factors. It returns ``(ata float32 [entities, k,
k], atr float32 [entities, k], counts int32 [entities])``: per entity the
sum of ``f f^T`` and of ``rating * f`` over its rows (``f = fixed[other]``)
and its rows (MLlib's ``n_e``); zeros for an entity with no row.

A CUDA tensor always reaches the kernel ``normal_equations_launch`` in
``csrc/normal_equations.cu`` (its header says what bounds it and how the
design follows: the rows ordered by entity on the card, each entity's
rows summed in registers a piece of at most ``PIECE_ROWS`` rows a warp,
the pieces added in order; no outer product written, no float atomic),
or an exception. A CPU tensor takes ``normal_equations_plain``: the
chunked ``index_add_`` sums the port computed before, the arithmetic the
JAX package's parity tests hold. ``LAUNCHES`` counts the calls that
launch the kernel, one a call with rows; ``piece_plan`` is the kernel's
cut of the rows into pieces, in PyTorch, for the tests.

While profiled a call counts ``als.gram_split``: the entities whose rows
take more than one piece (on the card from the kernel's scan, with no
sync).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from sparkrdma_tpu_torch.ops._build import bind
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import to_u64

LAUNCHES = 0
_KERNEL = "normal_equations"

PIECE_ROWS = 2048            # kPieceRows in csrc/normal_equations.cu
MAX_RANK = 16                # kMaxRank
MAX_ROWS = 2**31 - 1         # kMaxRows
MAX_ENTITIES = 2**30 - 1     # kMaxEntities
# the plain version's rows a chunk: bounds its [CH, k, k] outer products
CHUNK_ROWS = 1 << 20
# csrc/normal_equations.cu's extern "C" functions: name -> (argtypes,
# restype)
SIGNATURES = {
    "normal_equations_launch": (
        (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p),
        ctypes.c_int),
    "normal_equations_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}


def entries(rank: int) -> int:
    """The sums a piece keeps: the lower triangle of ``f f^T`` and ``A^T
    r``."""
    return rank * (rank + 1) // 2 + rank


def max_pieces(rows: int, entities: int) -> int:
    """The most pieces ``rows`` rows over ``entities`` entities make: each
    entity with rows adds at most one piece beyond ``rows / PIECE_ROWS``."""
    return entities + -(-rows // PIECE_ROWS)


def piece_plan(offsets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """The kernel's pieces from the CSR ``offsets [E + 1]`` (entity e's rows
    are ``[offsets[e], offsets[e + 1])``): ``(entity, first, rows)`` int64
    ``[pieces]`` in piece order, entity e's rows cut into
    ``ceil(n_e / PIECE_ROWS)`` runs of ``PIECE_ROWS`` rows, the last
    shorter; an entity with no row has none."""
    offsets = offsets.to(torch.int64)
    counts = offsets[1:] - offsets[:-1]
    pieces = (counts + PIECE_ROWS - 1) // PIECE_ROWS
    entity = torch.repeat_interleave(
        torch.arange(counts.numel(), device=offsets.device), pieces)
    start = torch.cumsum(pieces, 0) - pieces
    first = offsets[entity] + (
        torch.arange(entity.numel(), device=offsets.device)
        - start[entity]) * PIECE_ROWS
    return entity, first, torch.clamp(offsets[entity + 1] - first,
                                      max=PIECE_ROWS)


def normal_equations_plain(local_key: torch.Tensor, other: torch.Tensor,
                           rating: torch.Tensor, fixed: torch.Tensor,
                           entities: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The kernel's function in plain PyTorch: in chunks of at most
    ``CHUNK_ROWS`` rows, the other side's factors gathered, their outer
    products written out and summed by ``index_add_`` into a zeroed
    buffer, which is then added to the running total (a running float32
    total summed into directly stagnates once it dwarfs its terms); the
    counts by ``bincount``."""
    k = fixed.shape[1]
    dev = local_key.device
    others = to_u64(other)
    ata = torch.zeros((entities, k, k), dtype=torch.float32, device=dev)
    atr = torch.zeros((entities, k), dtype=torch.float32, device=dev)
    rows = local_key.shape[0]
    ch = min(CHUNK_ROWS, 1 << max(10, (max(rows, 1) - 1).bit_length()))
    for lo in range(0, rows, ch):
        u = fixed.index_select(0, others[lo:lo + ch])
        li = local_key[lo:lo + ch]
        r = rating[lo:lo + ch]
        ata += torch.zeros_like(ata).index_add_(
            0, li, u[:, :, None] * u[:, None, :])
        atr += torch.zeros_like(atr).index_add_(0, li, u * r[:, None])
    counts = torch.bincount(local_key, minlength=entities).to(torch.int32)
    return ata, atr, counts


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    return bind(_KERNEL, SIGNATURES)


def _check(local_key: torch.Tensor, other: torch.Tensor,
           rating: torch.Tensor, fixed: torch.Tensor, entities: int) -> None:
    """What the kernel takes, or raise."""
    rows = local_key.shape[0] if local_key.dim() == 1 else -1
    if local_key.dtype != torch.int64 or rows < 0:
        raise TypeError(f"local_key must be int64 [N], got {local_key.dtype} "
                        f"{tuple(local_key.shape)}")
    if other.dtype != torch.int32 or tuple(other.shape) != (rows,):
        raise TypeError(f"other must be int32 [{rows}], got {other.dtype} "
                        f"{tuple(other.shape)}")
    if rating.dtype != torch.float32 or tuple(rating.shape) != (rows,):
        raise TypeError(f"rating must be float32 [{rows}], got "
                        f"{rating.dtype} {tuple(rating.shape)}")
    if fixed.dtype != torch.float32 or fixed.dim() != 2:
        raise TypeError(f"fixed must be float32 [M, k], got {fixed.dtype} "
                        f"{tuple(fixed.shape)}")
    if not 1 <= fixed.shape[1] <= MAX_RANK:
        raise ValueError(f"normal_equations takes ranks 1 to {MAX_RANK}, "
                         f"got {fixed.shape[1]}")
    if rows > MAX_ROWS or not 1 <= entities <= MAX_ENTITIES:
        raise ValueError(f"normal_equations takes at most {MAX_ROWS} rows "
                         f"and 1 to {MAX_ENTITIES} entities, got {rows} "
                         f"and {entities}")
    if fixed.shape[0] >= 2**32 - 1:
        raise ValueError(f"fixed has {fixed.shape[0]} rows; ids are u32")
    device = local_key.device
    if any(t.device != device for t in (other, rating, fixed)):
        raise ValueError("normal_equations' tensors must lie on one device")


def _launch(local_key: torch.Tensor, other: torch.Tensor,
            rating: torch.Tensor, fixed: torch.Tensor, entities: int
            ) -> Dict[str, torch.Tensor]:
    """The kernel's launch on the current stream: its outputs and its
    scratch by name (``ata``, ``atr``, ``counts``, ``offsets``,
    ``piece_start``, ``plan``, ``state``)."""
    global LAUNCHES
    rows, k = local_key.shape[0], fixed.shape[1]
    dev = local_key.device
    local_key = local_key.contiguous()
    fixed = fixed.contiguous()
    if fixed.data_ptr() % 16:
        fixed = fixed.clone()
    pieces = max_pieces(rows, entities)
    ints = torch.empty(rows + 3 * entities + 2 + pieces, dtype=torch.int32,
                       device=dev)
    counts, offsets, row_rank, piece_start, plan = torch.split(
        ints, [entities, entities + 1, rows, entities + 1, pieces])
    out = {"ata": torch.empty((entities, k, k), dtype=torch.float32,
                              device=dev),
           "atr": torch.empty((entities, k), dtype=torch.float32,
                              device=dev),
           "counts": counts, "offsets": offsets, "piece_start": piece_start,
           "plan": plan,
           "state": torch.empty(1, dtype=torch.int64, device=dev)}
    pairs = torch.empty(rows, dtype=torch.int64, device=dev)
    partial = torch.empty((pieces, entries(k)), dtype=torch.float32,
                          device=dev)
    lib = _library()
    err = lib.normal_equations_launch(
        local_key.data_ptr(), rows, other.data_ptr(), other.stride(0),
        rating.data_ptr(), rating.stride(0), fixed.data_ptr(),
        fixed.shape[0], k, entities, counts.data_ptr(), offsets.data_ptr(),
        row_rank.data_ptr(), piece_start.data_ptr(), plan.data_ptr(), pieces,
        pairs.data_ptr(), partial.data_ptr(), out["ata"].data_ptr(),
        out["atr"].data_ptr(), out["state"].data_ptr(),
        torch._C._cuda_getCurrentRawStream(local_key.get_device()))
    if err != 0:
        raise RuntimeError("normal_equations launch failed: "
                           + lib.normal_equations_error_string(err).decode())
    LAUNCHES += 1
    return out


def normal_equations(local_key: torch.Tensor, other: torch.Tensor,
                     rating: torch.Tensor, fixed: torch.Tensor, entities: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ata, atr, counts)``; see the module's docstring. On the card it
    launches on the current stream and reads nothing back."""
    if not local_key.is_cuda:
        if local_key.device.type != "cpu":
            raise ValueError(f"normal_equations runs on cuda or cpu, not "
                             f"{local_key.device}")
        ata, atr, counts = normal_equations_plain(local_key, other, rating,
                                                  fixed, entities)
        if trace_mod.counting():
            trace_mod.count("als.gram_split", counts > PIECE_ROWS)
        return ata, atr, counts
    _check(local_key, other, rating, fixed, entities)
    if local_key.shape[0] == 0:
        k = fixed.shape[1]
        return (torch.zeros((entities, k, k), dtype=torch.float32,
                            device=local_key.device),
                torch.zeros((entities, k), dtype=torch.float32,
                            device=local_key.device),
                torch.zeros(entities, dtype=torch.int32,
                            device=local_key.device))
    out = _launch(local_key, other, rating, fixed, entities)
    if trace_mod.counting():
        trace_mod.count("als.gram_split", out["state"])
    return out["ata"], out["atr"], out["counts"]
