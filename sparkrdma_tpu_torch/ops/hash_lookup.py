"""Unique-key lookup of the query plans' joins, on the rows' own u32 key
words: q95's dimension rounds and returns semi-join, q64's pair joins,
date join and ``cs_ui`` semi-join, and the star join's two lookups.

``hash_lookup(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid,
bound)`` takes each side's key as a tuple of one or two int32 ``[D, N]``
views (most significant word first; strided views of the received rows,
or ``low_word`` of an int64 tensor), the dimension side's attribute words
(or None) and each side's valid mask (or None: every row). A row takes
part where it is valid and its key is a key: a two-word key only where
its high word lies below ``HIGH_LIMIT`` (a dead row's PAD item word is
not one), a one-word key only where it is not ``NO_KEY``. Each probe of
shard d is answered by shard d's dimension row of equal key, the lowest
row where several are. Returns ``(attr int64 [D, P] or None, found bool
[D, P], overflowed bool [D])``; ``overflowed`` is set where more than
``bound`` dimension rows take part (the caller's bound from shapes: the
rows the dimension side sent, or a tighter one it knows), and the step
ORs it into its own.

A CUDA tensor always reaches the kernel ``hash_lookup_launch`` in
``csrc/hash_lookup.cu`` (its header says what bounds it and how the
design follows: a hash build over the live dimension rows and a probe of
the live probes, with no sort), or an exception. A CPU tensor takes
``hash_lookup_plain``: ``ops/sort.py``'s ``lookup_unique``, the stable
sort and binary search that the JAX package's ``_lookup`` computes, on
the keys the callers formed before (the int64 composite ``pair64`` of
two words, the zero-extended word of one). The two agree on ``found``
everywhere and on ``attr`` where found; where not found the kernel
gives 0 and the search its neighbour's attribute, which no caller reads.
``LAUNCHES`` counts the calls that launch the kernel.

Every call opens the ``lookup.unique`` span around its lookup. While
profiled it counts ``lookup.probes`` (probes that take part) and
``lookup.found`` (those found) on the device, with no sync. The state it
zeroes (on the CPU, the keys it forms) comes before the span and the flag
it reads after, so a caller's span around the call starts and ends on
work of its own and its device range covers this one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from sparkrdma_tpu_torch.ops._build import bind
from sparkrdma_tpu_torch.ops.sort import lookup_unique
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import SENTINEL, SENTINEL64, to_u64

LAUNCHES = 0
_KERNEL = "hash_lookup"

HIGH_LIMIT = (1 << 31) - 1   # kHighLimit in csrc/hash_lookup.cu
NO_KEY = 0xFFFFFFFF          # kNoKey
MAX_ROWS = 0xFFFFFFFE        # kMaxRows: a side's D * N
MAX_SHARDS = 65535           # the grid's second dimension
MIN_SLOTS = 256
# csrc/hash_lookup.cu's extern "C" functions: name -> (argtypes, restype)
_VIEW = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong)
SIGNATURES = {
    "hash_lookup_launch": (
        _VIEW + _VIEW + (ctypes.c_void_p,) + _VIEW
        + (ctypes.c_longlong, ctypes.c_longlong) + _VIEW + _VIEW
        + (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p),
        ctypes.c_int),
    "hash_lookup_error_string": ((ctypes.c_int,), ctypes.c_char_p),
}


def low_word(values: torch.Tensor) -> torch.Tensor:
    """The low u32 words of int64 ``values [D, N]`` (u32 values or their
    ``SENTINEL``) as an int32 view, with no copy: a one-word key."""
    if values.dtype != torch.int64 or values.stride(-1) != 1:
        raise ValueError("low_word takes int64 values contiguous along "
                         "their last axis")
    return values.view(torch.int32)[..., 0::2]


def pair64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The exact int64 composite ``hi << 32 | lo`` of two u32 words;
    ``SENTINEL64`` where ``hi`` is not below ``HIGH_LIMIT`` (a dead row's
    PAD item word): the plain version's two-word key."""
    high = to_u64(hi)
    return torch.where(high < HIGH_LIMIT, (high << 32) | to_u64(lo),
                       SENTINEL64)


def table_slots(bound: int) -> int:
    """The kernel's table size for ``bound`` live dimension rows: the
    power of two at least twice it (at most half full), ``MIN_SLOTS`` at
    the least."""
    return max(MIN_SLOTS, 1 << max(0, 2 * bound - 1).bit_length())


def _keys(keys: Sequence[torch.Tensor], valid: Optional[torch.Tensor]
          ) -> Tuple[torch.Tensor, int]:
    """The plain version's keys of one side and its "no row" key: the
    int64 composite of two words, or one word zero-extended, with the
    rows not ``valid`` set to the sentinel."""
    if len(keys) == 2:
        wide, sentinel = pair64(*keys), SENTINEL64
    else:
        wide, sentinel = to_u64(keys[0]), SENTINEL
    if valid is not None:
        wide = torch.where(valid, wide, sentinel)
    return wide, sentinel


def _sides(dim_keys: Sequence[torch.Tensor],
           dim_valid: Optional[torch.Tensor],
           probe_keys: Sequence[torch.Tensor],
           probe_valid: Optional[torch.Tensor]) -> tuple:
    """Each side's keys for the plain version, formed once, and the masks
    of the rows that take part: ``(dim_keys, dim_valid, dim_taking,
    probes, probe_taking)``. A probe's key is its ``_keys``; a dimension
    row's is ``pair64`` of two words, or its one word as it is
    (``lookup_unique``'s u32-word form, 0xFFFFFFFF its sentinel), which
    ``lookup_unique`` masks by ``dim_valid`` itself."""
    probes, sentinel = _keys(probe_keys, probe_valid)
    if len(dim_keys) == 2:
        dk = pair64(*dim_keys)
        dim_taking = dk != SENTINEL64
    else:
        dk = dim_keys[0]
        dim_taking = dk != -1            # NO_KEY as an int32 word
    if dim_valid is None:
        dim_valid = torch.ones(dk.shape, dtype=torch.bool, device=dk.device)
    else:
        dim_taking &= dim_valid
    return dk, dim_valid, dim_taking, probes, probes != sentinel


def _search(dk: torch.Tensor, dim_valid: torch.Tensor,
            dim_attr: torch.Tensor, probes: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lookup_unique`` on the keys of ``_sides``: ``(attr, found)``."""
    if dk.shape[1] == 0:      # nothing to find (and to sort)
        found = torch.zeros(probes.shape, dtype=torch.bool,
                            device=probes.device)
        return torch.zeros(found.shape, dtype=torch.int64,
                           device=found.device), found
    return lookup_unique(dk, dim_valid, dim_attr, probes)


def hash_lookup_plain(dim_keys: Sequence[torch.Tensor],
                      dim_valid: Optional[torch.Tensor],
                      dim_attr: Optional[torch.Tensor],
                      probe_keys: Sequence[torch.Tensor],
                      probe_valid: Optional[torch.Tensor]
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(attr, found)`` of the lookup in plain PyTorch: ``lookup_unique``
    on the keys of ``_sides`` (a probe it does not find takes its
    neighbour's attribute)."""
    dk, dv, _, probes, _ = _sides(dim_keys, dim_valid, probe_keys,
                                  probe_valid)
    attr, found = _search(dk, dv, dim_keys[-1] if dim_attr is None
                          else dim_attr, probes)
    return (None if dim_attr is None else attr), found


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    return bind(_KERNEL, SIGNATURES)


def _check_side(keys: Sequence[torch.Tensor], valid: Optional[torch.Tensor],
                what: str) -> Tuple[int, int]:
    """A side's ``(D, N)``, or raise."""
    if len(keys) not in (1, 2):
        raise ValueError(f"{what} keys are one or two words, got "
                         f"{len(keys)}")
    shape = tuple(keys[0].shape)
    for k in keys:
        if k.dtype != torch.int32 or k.dim() != 2:
            raise TypeError(f"{what} key words must be int32 [D, N], got "
                            f"{k.dtype} {tuple(k.shape)}")
        if tuple(k.shape) != shape:
            raise ValueError(f"{what} key words differ in shape")
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != shape):
        raise ValueError(f"{what} valid must be bool {shape}")
    return shape


def _check(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid,
           bound: int) -> None:
    """What the kernel takes, or raise."""
    d, m = _check_side(dim_keys, dim_valid, "dimension")
    dp, _ = _check_side(probe_keys, probe_valid, "probe")
    if len(dim_keys) != len(probe_keys):
        raise ValueError("dimension and probe keys differ in words")
    if dp != d:
        raise ValueError(f"dimension and probe sides differ in shards: "
                         f"{d} and {dp}")
    if dim_attr is not None and (dim_attr.dtype != torch.int32
                                 or tuple(dim_attr.shape) != (d, m)):
        raise TypeError(f"dim_attr must be int32 {(d, m)}")
    device = probe_keys[0].device
    if any(t is not None and t.device != device
           for t in (*dim_keys, dim_valid, dim_attr, *probe_keys,
                     probe_valid)):
        raise ValueError("hash_lookup's tensors must lie on one device")
    if d > MAX_SHARDS or d * m > MAX_ROWS:
        raise ValueError(f"hash_lookup takes at most {MAX_SHARDS} shards "
                         f"and {MAX_ROWS} dimension rows, got [{d}, {m}]")
    if bound < 0:
        raise ValueError(f"bound must be >= 0, got {bound}")


def _view(words: Optional[torch.Tensor]) -> tuple:
    if words is None:
        return (None, 0, 0)
    return (words.data_ptr(), words.stride(0), words.stride(1))


def hash_lookup(dim_keys: Sequence[torch.Tensor],
                dim_valid: Optional[torch.Tensor],
                dim_attr: Optional[torch.Tensor],
                probe_keys: Sequence[torch.Tensor],
                probe_valid: Optional[torch.Tensor], bound: int
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                           torch.Tensor]:
    """``(attr, found, overflowed)``; see the module's docstring. On the
    card it launches on the current stream and reads nothing back."""
    global LAUNCHES
    device = probe_keys[0].device
    d, p = probe_keys[0].shape
    if not probe_keys[0].is_cuda:
        if device.type != "cpu":
            raise ValueError(f"hash_lookup runs on cuda or cpu, not {device}")
        dk, dv, taking, probes, probing = _sides(dim_keys, dim_valid,
                                                 probe_keys, probe_valid)
        with trace_mod.span("lookup.unique"):
            attr, found = _search(dk, dv, dim_keys[-1] if dim_attr is None
                                  else dim_attr, probes)
            if trace_mod.counting():
                trace_mod.count("lookup.probes", probing)
                trace_mod.count("lookup.found", found)
        return ((None if dim_attr is None else attr), found,
                (taking.sum() > bound).expand(d))
    _check(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid, bound)
    m = dim_keys[0].shape[1]
    slots = table_slots(bound)
    dim_valid = None if dim_valid is None else dim_valid.contiguous()
    probe_valid = None if probe_valid is None else probe_valid.contiguous()
    table = torch.empty((slots, 2), dtype=torch.int64, device=device)
    found = torch.empty((d, p), dtype=torch.bool, device=device)
    attr = (None if dim_attr is None
            else torch.empty((d, p), dtype=torch.int64, device=device))
    # rows taking part, the overflow flag, probes taking part, probes found
    state = torch.zeros(4, dtype=torch.int64, device=device)
    with trace_mod.span("lookup.unique"):
        counting = trace_mod.counting()
        lib = _library()
        words = len(dim_keys)
        err = lib.hash_lookup_launch(
            *_view(dim_keys[0] if words == 2 else None),
            *_view(dim_keys[-1]),
            None if dim_valid is None else dim_valid.data_ptr(),
            *_view(dim_attr), d, m,
            *_view(probe_keys[0] if words == 2 else None),
            *_view(probe_keys[-1]),
            None if probe_valid is None else probe_valid.data_ptr(), p,
            words, table.data_ptr(), slots, bound, state.data_ptr(),
            int(counting), found.data_ptr(),
            None if attr is None else attr.data_ptr(),
            torch._C._cuda_getCurrentRawStream(probe_keys[0].get_device()))
        if err != 0:
            raise RuntimeError("hash_lookup launch failed: "
                               + lib.hash_lookup_error_string(err).decode())
        LAUNCHES += 1
        if counting:
            trace_mod.count("lookup.probes", state[2])
            trace_mod.count("lookup.found", state[3])
    return attr, found, (state[1] != 0).expand(d)
