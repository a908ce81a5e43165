"""Ring all-to-all: the dense per-shard exchange of fixed-size blocks.

Port of ``sparkrdma_tpu/ops/ring_exchange.py``. There the Pallas kernel
``_ring_kernel`` moves each device's ``[D, C, W]`` blocks as a D-1 step
shift-register ring of remote DMAs over ICI. Over the port's virtual
mesh all D shards share one card's memory, so the same function is one
block transpose, done by the CUDA kernel in ``csrc/ring_exchange.cu``
(its header says what bounds it and how the design follows).

``ring_all_to_all`` is the wrapper: a CUDA tensor always reaches the
kernel (or an exception); a CPU tensor takes ``ring_all_to_all_plain``,
the plain PyTorch version that the CPU tests and the on-card comparison
use. ``LAUNCHES`` counts kernel launches, ``SHAPES`` counts them per
block shape ``(D, D, C, W)`` and ``BODIES`` per kernel body (``"tma"``
or ``"ldst"``, chosen per launch by ``body_for``).

A launch passes the D source and D destination bases to the kernel by
value (``_Bases``, a struct in the kernel's parameter block), so it
makes no host-to-device copy and no host tensor, and can be captured
in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

LAUNCHES = 0
SHAPES: Dict[Tuple[int, ...], int] = {}
BODIES: Dict[str, int] = {}
_KERNEL = "ring_exchange"

MAX_SHARDS = 128          # kMaxShards in csrc/ring_exchange.cu
# the TMA body's shape: bytes per tile, tiles in flight per CTA (shared
# memory = TILE_BYTES * STAGES), CTAs per SM of the persistent grid
TMA_TILE_BYTES = 16 << 10
TMA_STAGES = 4
TMA_CTAS_PER_SM = 2


class _Bases(ctypes.Structure):
    """``Bases`` in ``csrc/ring_exchange.cu``: D source then D
    destination device addresses, the rest unused."""
    _fields_ = [("src", ctypes.c_longlong * MAX_SHARDS),
                ("dst", ctypes.c_longlong * MAX_SHARDS)]


_lib: Optional[ctypes.CDLL] = None
_per_thread = threading.local()


def ring_all_to_all_plain(blocks: torch.Tensor) -> torch.Tensor:
    """``out[j, i] = blocks[i, j]``, written as the ring's per-shard
    absorption order: shard ``me`` receives its own block at step 0 and
    the block of the shard ``s`` hops to its left at step ``s``."""
    d = blocks.shape[0]
    out = torch.empty_like(blocks)
    for me in range(d):
        for s in range(d):
            origin = (me - s) % d
            out[me, origin] = blocks[origin, me]
    return out


def _pointer_table(blocks: torch.Tensor, out: torch.Tensor
                   ) -> Tuple[List[int], List[int]]:
    """The kernel's bases for contiguous ``blocks`` and ``out`` of shape
    ``[D, D, C, W]``: shard i sends from ``src[i]`` and receives at
    ``dst[i]``, each ``i * D*C*W*itemsize`` bytes past its tensor's
    start. Raises for more than ``MAX_SHARDS`` shards."""
    d, _, c, w = blocks.shape
    if d > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards (the kernel's "
                         f"pointer table), got {d}")
    shard_bytes = d * c * w * blocks.element_size()
    src0, dst0 = blocks.data_ptr(), out.data_ptr()
    return ([src0 + i * shard_bytes for i in range(d)],
            [dst0 + i * shard_bytes for i in range(d)])


def body_for(src: Sequence[int], dst: Sequence[int], block_bytes: int
             ) -> str:
    """The kernel body a launch takes: ``"tma"`` (bulk copies) when every
    base and the block size are multiples of 16 bytes, else ``"ldst"``
    (loads and stores)."""
    aligned = block_bytes % 16 == 0 and all(
        p % 16 == 0 for bases in (src, dst) for p in bases)
    return "tma" if aligned else "ldst"


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    global _lib
    if _lib is None:
        from sparkrdma_tpu_torch.ops._build import load

        lib = load(_KERNEL)
        lib.ring_all_to_all_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.ring_all_to_all_launch.restype = ctypes.c_int
        lib.ring_all_to_all_max_shards.argtypes = []
        lib.ring_all_to_all_max_shards.restype = ctypes.c_int
        lib.ring_all_to_all_error_string.argtypes = [ctypes.c_int]
        lib.ring_all_to_all_error_string.restype = ctypes.c_char_p
        if lib.ring_all_to_all_max_shards() != MAX_SHARDS:
            raise RuntimeError("csrc/ring_exchange.cu and ring_exchange.py "
                               "disagree on MAX_SHARDS")
        _lib = lib
    return _lib


def _launch(blocks: torch.Tensor, out: torch.Tensor, body: str,
            src: Sequence[int], dst: Sequence[int],
            tile_bytes: int = TMA_TILE_BYTES, stages: int = TMA_STAGES,
            ctas_per_sm: int = TMA_CTAS_PER_SM) -> None:
    lib = _library()
    bases = getattr(_per_thread, "bases", None)
    if bases is None:
        bases = _per_thread.bases = _Bases()
    d = len(src)
    bases.src[:d] = src
    bases.dst[:d] = dst
    block_bytes = blocks.shape[2] * blocks.shape[3] * blocks.element_size()
    # the current stream's raw handle, without the Stream object that
    # torch.cuda.current_stream builds (several µs a launch)
    stream = torch._C._cuda_getCurrentRawStream(blocks.get_device())
    err = lib.ring_all_to_all_launch(
        ctypes.addressof(bases), d, block_bytes, int(body == "tma"),
        tile_bytes, stages, ctas_per_sm, stream)
    if err != 0:
        raise RuntimeError(
            f"ring_all_to_all launch failed ({body} body): "
            + lib.ring_all_to_all_error_string(err).decode())


def ring_all_to_all(blocks: torch.Tensor) -> torch.Tensor:
    """All-to-all of per-destination blocks.

    ``blocks: int32[D, D, C, W]``, row ``[i, j]`` what shard i sends to
    shard j. Returns ``out`` of the same shape with ``out[j, i] =
    blocks[i, j]`` (what ``make_ring_all_to_all`` returns).
    """
    global LAUNCHES
    if not blocks.is_cuda:
        if blocks.device.type == "cpu":
            return ring_all_to_all_plain(blocks)
        raise ValueError(f"ring_all_to_all runs on cuda or cpu, not "
                         f"{blocks.device}")
    if blocks.dtype != torch.int32:
        raise TypeError(f"ring_all_to_all moves int32 words, got "
                        f"{blocks.dtype}")
    if blocks.dim() != 4 or blocks.shape[0] != blocks.shape[1]:
        raise ValueError(f"blocks must be [D, D, C, W], got "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    out = torch.empty_like(blocks)
    src, dst = _pointer_table(blocks, out)
    if blocks.numel() == 0:
        return out
    body = body_for(src, dst, blocks.shape[2] * blocks.shape[3] * 4)
    _launch(blocks, out, body, src, dst)
    LAUNCHES += 1
    shape = tuple(blocks.shape)
    SHAPES[shape] = SHAPES.get(shape, 0) + 1
    BODIES[body] = BODIES.get(body, 0) + 1
    return out
