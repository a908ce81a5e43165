"""Unsigned 32-bit words in PyTorch, and the numpy <-> mesh state carry.

The JAX package works in ``uint32`` throughout. PyTorch's CPU build
lacks ``searchsorted``, ``<``, ``index_select`` and ``gather`` for
``torch.uint32`` (``sort`` and ``.view(torch.int32)`` work), so the port
uses one convention everywhere:

* rows travel as **int32 bit patterns** (the same 4 bytes as the u32);
* keys are compared as zero-extended **int64** (``to_u64``);
* the sentinel ``0xFFFFFFFF`` is int64 ``SENTINEL`` in comparisons and
  the bit pattern ``-1`` when written back into a row (``to_bits``);
* a key of two words (q64's pair keys) is an int64 composite whose
  "no row" key is ``SENTINEL64``, beyond every composite.

A shuffle system has no weights: its carried state is the row data
(and the splitters, which are a pure function of D). ``rows_from_numpy``
and ``rows_to_numpy`` move rows between the JAX package's global layout
``u32[D*cap, W]`` and the port's mesh layout ``int32[D, cap, W]``, so
both packages compute on identical input. ``shards_from_numpy`` and
``shards_to_numpy`` do the same for state of any dtype, such as
PageRank's float32 ranks and out-degrees (``f32[V]`` sharded on its
leading axis in the JAX package, ``[D, V/D]`` here). Float payloads
inside rows ride as their bits: ``.view(torch.int32)`` on the way in and
``.view(torch.float32)`` on the way out, never a value cast.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF  # as a zero-extended int64 key: sorts after every u32
# the "no row" key of 64-bit composite keys (two u32 words, the high one
# below 2**31 - 1), where 0xFFFFFFFF is a real key: the int64 maximum
SENTINEL64 = (1 << 63) - 1


def to_u64(words: torch.Tensor) -> torch.Tensor:
    """u32 values (int32 bit patterns or any integer tensor) as
    zero-extended int64, for ordered comparison and arithmetic."""
    return words.to(torch.int64) & MASK


def to_bits(values: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` as int32 bit patterns (two's
    complement wrap written out, not left to the cast)."""
    return (((values & MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def from_u64(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Zero-extended int64 u32 values in ``like``'s dtype: int32 bit
    patterns when ``like`` carries its u32 values as int32."""
    return to_bits(values) if like.dtype == torch.int32 else values.to(
        like.dtype)


def shards_from_numpy(values: np.ndarray, mesh) -> torch.Tensor:
    """``[D*n, ...]`` host array -> ``[D, n, ...]`` on the mesh's device,
    dtype kept (shard d holds entries ``[d*n, (d+1)*n)``, the JAX
    package's leading-axis sharding)."""
    values = np.ascontiguousarray(values)
    d = mesh.num_shards
    if values.shape[0] % d:
        raise ValueError(f"{values.shape[0]} rows do not split over {d} "
                         "shards")
    host = torch.from_numpy(values)
    return host.reshape((d, values.shape[0] // d) + values.shape[1:]).to(
        mesh.device)


def shards_to_numpy(shards: torch.Tensor) -> np.ndarray:
    """``[D, n, ...]`` mesh state -> the JAX layout ``[D*n, ...]``."""
    host = shards.detach().to("cpu").contiguous().numpy()
    return host.reshape((-1,) + host.shape[2:])


def rows_from_numpy(rows: np.ndarray, mesh) -> torch.Tensor:
    """``u32[D*cap, W]`` host rows -> ``int32[D, cap, W]`` on the mesh's
    device (shard d holds rows ``[d*cap, (d+1)*cap)``)."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype.itemsize != 4:
        raise TypeError(f"rows must be 4-byte words, got {rows.dtype}")
    return shards_from_numpy(rows.view(np.int32), mesh)


def rows_to_numpy(rows: torch.Tensor) -> np.ndarray:
    """``int32[D, cap, W]`` mesh rows -> the JAX layout ``u32[D*cap, W]``."""
    return shards_to_numpy(rows).view(np.uint32)
