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
use. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
_KERNEL = "ring_exchange"


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


def _launch(lib: ctypes.CDLL, blocks: torch.Tensor, out: torch.Tensor
            ) -> None:
    d = blocks.shape[0]
    shard_bytes = blocks[0].numel() * blocks.element_size()
    ptrs = [blocks.data_ptr() + i * shard_bytes for i in range(d)] \
        + [out.data_ptr() + j * shard_bytes for j in range(d)]
    # pinned staging: the copy is stream-ordered and does not block the
    # host (a pageable copy would synchronise the stream every launch)
    ptrs_dev = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(
        blocks.device, non_blocking=True)
    block_words = blocks[0, 0].numel()
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    err = lib.ring_all_to_all_launch(ptrs_dev.data_ptr(), d, block_words,
                                     stream)
    if err != 0:
        raise RuntimeError("ring_all_to_all launch failed: "
                           + lib.ring_all_to_all_error_string(err).decode())


def _library() -> ctypes.CDLL:
    from sparkrdma_tpu_torch.ops._build import load

    lib = load(_KERNEL)
    lib.ring_all_to_all_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.ring_all_to_all_launch.restype = ctypes.c_int
    lib.ring_all_to_all_error_string.argtypes = [ctypes.c_int]
    lib.ring_all_to_all_error_string.restype = ctypes.c_char_p
    return lib


def ring_all_to_all(blocks: torch.Tensor) -> torch.Tensor:
    """All-to-all of per-destination blocks.

    ``blocks: int32[D, D, C, W]``, row ``[i, j]`` what shard i sends to
    shard j. Returns ``out`` of the same shape with ``out[j, i] =
    blocks[i, j]`` (what ``make_ring_all_to_all`` returns).
    """
    global LAUNCHES
    if blocks.device.type == "cpu":
        return ring_all_to_all_plain(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"ring_all_to_all runs on cuda or cpu, not "
                         f"{blocks.device}")
    if blocks.dtype != torch.int32:
        raise TypeError(f"ring_all_to_all moves int32 words, got "
                        f"{blocks.dtype}")
    if blocks.dim() != 4 or blocks.shape[0] != blocks.shape[1]:
        raise ValueError(f"blocks must be [D, D, C, W], got "
                         f"{tuple(blocks.shape)}")
    if blocks.shape[0] * blocks.shape[0] > 65535:
        raise ValueError("at most 255 shards (one grid row per pair)")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    out = torch.empty_like(blocks)
    if blocks.numel() == 0:
        return out
    _launch(_library(), blocks, out)
    LAUNCHES += 1
    return out
