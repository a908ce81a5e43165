"""Unsigned 32-bit words in PyTorch, and the numpy <-> mesh state carry.

The JAX package works in ``uint32`` throughout. PyTorch's CPU build
lacks ``searchsorted``, ``<``, ``index_select`` and ``gather`` for
``torch.uint32`` (``sort`` and ``.view(torch.int32)`` work), so the port
uses one convention everywhere:

* rows travel as **int32 bit patterns** (the same 4 bytes as the u32);
* keys are compared as zero-extended **int64** (``to_u64``);
* the sentinel ``0xFFFFFFFF`` is int64 ``SENTINEL`` in comparisons and
  the bit pattern ``-1`` when written back into a row (``to_bits``).

A shuffle system has no weights: its carried state is the row data
(and the splitters, which are a pure function of D). ``rows_from_numpy``
and ``rows_to_numpy`` move rows between the JAX package's global layout
``u32[D*cap, W]`` and the port's mesh layout ``int32[D, cap, W]``, so
both packages compute on identical input.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF  # as a zero-extended int64 key: sorts after every u32


def to_u64(words: torch.Tensor) -> torch.Tensor:
    """u32 values (int32 bit patterns or any integer tensor) as
    zero-extended int64, for ordered comparison and arithmetic."""
    return words.to(torch.int64) & MASK


def to_bits(values: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` as int32 bit patterns (two's
    complement wrap written out, not left to the cast)."""
    return (((values & MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def rows_from_numpy(rows: np.ndarray, mesh) -> torch.Tensor:
    """``u32[D*cap, W]`` host rows -> ``int32[D, cap, W]`` on the mesh's
    device (shard d holds rows ``[d*cap, (d+1)*cap)``, the JAX package's
    leading-axis sharding)."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype.itemsize != 4:
        raise TypeError(f"rows must be 4-byte words, got {rows.dtype}")
    d = mesh.num_shards
    if rows.shape[0] % d:
        raise ValueError(f"{rows.shape[0]} rows do not split over {d} shards")
    host = torch.from_numpy(rows.view(np.int32))
    return host.reshape((d, rows.shape[0] // d) + rows.shape[1:]).to(
        mesh.device)


def rows_to_numpy(rows: torch.Tensor) -> np.ndarray:
    """``int32[D, cap, W]`` mesh rows -> the JAX layout ``u32[D*cap, W]``."""
    host = rows.detach().to("cpu").contiguous().numpy().view(np.uint32)
    return host.reshape((-1,) + host.shape[2:])
