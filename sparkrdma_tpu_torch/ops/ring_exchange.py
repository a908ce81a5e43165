"""Ring all-to-all: the dense per-shard exchange of fixed-size blocks.

Port of ``sparkrdma_tpu/ops/ring_exchange.py``. There the Pallas kernel
``_ring_kernel`` moves each device's ``[D, C, W]`` blocks as a D-1 step
shift-register ring of remote DMAs over ICI. Over the port's virtual
mesh all D shards share one card's memory, so the same function is one
block transpose, done by the CUDA kernel in ``csrc/ring_exchange.cu``
(its header says what bounds it and how the design follows): one
load/store body for every launch, whatever the blocks' alignment.

``ring_all_to_all`` is the wrapper: a CUDA tensor always reaches the
kernel (or an exception); a CPU tensor takes ``ring_all_to_all_plain``,
the plain PyTorch version that the CPU tests and the on-card comparison
use. ``LAUNCHES`` counts kernel launches and ``SHAPES`` counts them per
block shape ``(D, D, C, W)``.

A launch passes the D source and D destination bases to the kernel by
value (``_Bases``, a struct in the kernel's parameter block), so it
makes no host-to-device copy and no host tensor, and can be captured
in a CUDA graph.

Across processes (a ``parallel.mesh.GlobalMesh``), ``ring_all_to_all_peers``
is the wrapper: each process launches the kernel over its own source
shards only, and the destination bases are the receive arenas of every
process (``PeerArena``), the peers' opened from CUDA IPC handles. That is
the port's counterpart of the Pallas kernel's remote DMA into a
neighbour's buffer. On the CPU it takes ``ring_all_to_all_peers_plain``,
the same block moves done by the process group's ``all_to_all_single``.
The ragged kernel's cross-process wrapper (``ops/ragged_exchange.py``)
writes into the same arenas. ``PEER`` holds the IPC bookkeeping (arena
growths, the seconds spent opening peers' handles).
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LAUNCHES = 0
SHAPES: Dict[Tuple[int, ...], int] = {}
PEER = {"arena_growths": 0, "ipc_opens": 0, "ipc_open_s": 0.0}
_KERNEL = "ring_exchange"

MAX_SHARDS = 128          # kMaxShards in csrc/ring_exchange.cu
# csrc/ring_exchange.cu's extern "C" functions (the ragged_* launches
# are ops/ragged_exchange.py's): name -> (argtypes, restype); a byte
# buffer (c_char_p) stands for a void pointer
_P = ctypes.POINTER
SIGNATURES = {
    "ring_all_to_all_launch": (
        (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p),
        ctypes.c_int),
    "ring_all_to_all_launch_range": (
        (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_void_p), ctypes.c_int),
    "ragged_all_to_all_launch": (
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p), ctypes.c_int),
    "ragged_all_to_all_launch_range": (
        (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p),
        ctypes.c_int),
    "ring_all_to_all_max_shards": ((), ctypes.c_int),
    "ring_all_to_all_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    "ring_ipc_handle_bytes": ((), ctypes.c_int),
    "ring_ipc_alloc": ((ctypes.c_longlong, _P(ctypes.c_void_p)),
                       ctypes.c_int),
    "ring_ipc_free": ((ctypes.c_void_p,), ctypes.c_int),
    "ring_ipc_export": ((ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                         _P(ctypes.c_longlong)), ctypes.c_int),
    "ring_ipc_open": ((ctypes.c_char_p, _P(ctypes.c_void_p)), ctypes.c_int),
    "ring_ipc_close": ((ctypes.c_void_p,), ctypes.c_int),
}


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


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use."""
    global _lib
    if _lib is None:
        from sparkrdma_tpu_torch.ops._build import load

        lib = load(_KERNEL)
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
        if lib.ring_all_to_all_max_shards() != MAX_SHARDS:
            raise RuntimeError("csrc/ring_exchange.cu and ring_exchange.py "
                               "disagree on MAX_SHARDS")
        _lib = lib
    return _lib


def _fill_bases(src: Sequence[int], dst: Sequence[int]) -> _Bases:
    """This thread's ``_Bases``, holding ``src`` and ``dst`` (the
    launch copies it into the kernel's parameters)."""
    bases = getattr(_per_thread, "bases", None)
    if bases is None:
        bases = _per_thread.bases = _Bases()
    bases.src[:len(src)] = src
    bases.dst[:len(dst)] = dst
    return bases


def _launch(blocks: torch.Tensor, src: Sequence[int], dst: Sequence[int],
            src_begin: Optional[int] = None) -> None:
    """One launch with the given bases: the full launch (``src_begin``
    None, ``len(src) == len(dst)``), or the range launch over sources
    ``[src_begin, src_begin + len(src))`` of ``len(dst)``."""
    lib = _library()
    bases = _fill_bases(src, dst)
    block_bytes = blocks.shape[2] * blocks.shape[3] * blocks.element_size()
    # the current stream's raw handle, without the Stream object that
    # torch.cuda.current_stream builds (several µs a launch)
    stream = torch._C._cuda_getCurrentRawStream(blocks.get_device())
    if src_begin is None:
        err = lib.ring_all_to_all_launch(
            ctypes.addressof(bases), len(src), block_bytes, stream)
    else:
        err = lib.ring_all_to_all_launch_range(
            ctypes.addressof(bases), len(dst), src_begin, len(src),
            block_bytes, stream)
    if err != 0:
        raise RuntimeError("ring_all_to_all launch failed: "
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
    _launch(blocks, src, dst)
    LAUNCHES += 1
    shape = tuple(blocks.shape)
    SHAPES[shape] = SHAPES.get(shape, 0) + 1
    return out


# -- across processes: the range launch into peers' receive arenas ---------

def _peer_pointer_table(blocks: torch.Tensor, arena_bases: Sequence[int]
                        ) -> Tuple[List[int], List[int]]:
    """The range launch's bases for contiguous ``blocks`` of shape ``[Dl,
    G, C, W]`` (this process's ``Dl`` source shards, one block per
    destination) and the receive arenas ``arena_bases`` of the ``P = G /
    Dl`` processes, each ``[Dl, G, C, W]``: local source ``i`` sends from
    ``src[i]``, ``i * G*C*W*itemsize`` bytes past the start of
    ``blocks``, and global shard ``j`` receives at ``dst[j]``, shard ``j
    % Dl`` of process ``j // Dl``'s arena. The kernel adds ``j * block``
    to a source base and ``(s0 + i) * block`` to a destination base.
    Raises past ``MAX_SHARDS`` shards."""
    dl, g, c, w = blocks.shape
    if g > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards (the kernel's "
                         f"pointer table), got {g}")
    if g != dl * len(arena_bases):
        raise ValueError(f"{len(arena_bases)} arenas of {dl} shards do not "
                         f"make {g} destinations")
    shard_bytes = g * c * w * blocks.element_size()
    src0 = blocks.data_ptr()
    return ([src0 + i * shard_bytes for i in range(dl)],
            [arena_bases[j // dl] + (j % dl) * shard_bytes
             for j in range(g)])


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           + _library().ring_all_to_all_error_string(
                               err).decode())


class _DeviceBuffer:
    """``nbytes`` of device memory from ``cudaMalloc`` (outside PyTorch's
    caching allocator), seen by ``torch.as_tensor`` through
    ``__cuda_array_interface__``; freed when the last tensor over it
    goes."""

    def __init__(self, nbytes: int):
        ptr = ctypes.c_void_p()
        _check(_library().ring_ipc_alloc(nbytes, ctypes.byref(ptr)),
               f"cudaMalloc of a {nbytes}-byte receive arena")
        self.ptr = int(ptr.value)
        self.__cuda_array_interface__ = {
            "shape": (nbytes // 4,), "typestr": "<i4",
            "data": (self.ptr, False), "version": 2}

    def __del__(self):
        if _lib is not None:
            _lib.ring_ipc_free(ctypes.c_void_p(self.ptr))


class PeerArena:
    """This process's receive arena and the opened arenas of the other
    processes of ``group`` (rank ``rank`` of ``world``) on ``device``.

    Every process grows its arena in lockstep (callers agree on the size
    from the all-gathered count matrix), exports it and opens its peers'
    once per growth; the opened pointers are cached until the next one.
    A handle that cannot be opened raises."""

    def __init__(self, group, rank: int, world: int, device: torch.device):
        self.group, self.rank, self.world = group, rank, world
        self.device = device
        self.nbytes = 0
        self.bases: List[int] = []
        self._local: Optional[torch.Tensor] = None
        self._opened: List[int] = []

    def _close_peers(self) -> None:
        lib = _library()
        for ptr in self._opened:
            _check(lib.ring_ipc_close(ctypes.c_void_p(ptr)),
                   "cudaIpcCloseMemHandle")
        self._opened = []

    def ensure(self, nbytes: int) -> None:
        """Hold at least ``nbytes`` in every process's arena. Collective
        over ``group`` when it grows: every process must call it with the
        same ``nbytes``."""
        if nbytes <= self.nbytes:
            return
        lib = _library()
        torch.cuda.synchronize(self.device)  # reads of the old arena done
        self._close_peers()
        dist.barrier(group=self.group)       # no peer maps it any more
        self._local = None
        self.bases = []
        size = -(-nbytes // (2 << 20)) * (2 << 20)   # whole 2 MiB pages
        buf = _DeviceBuffer(size)
        self._local = torch.as_tensor(buf, device=self.device)
        handle = ctypes.create_string_buffer(lib.ring_ipc_handle_bytes())
        offset = ctypes.c_longlong()
        _check(lib.ring_ipc_export(ctypes.c_void_p(buf.ptr),
                                   ctypes.c_void_p(buf.ptr), handle,
                                   ctypes.byref(offset)),
               "cudaIpcGetMemHandle")
        shared: List[Optional[tuple]] = [None] * self.world
        dist.all_gather_object(shared, (handle.raw, offset.value),
                               group=self.group)
        t0 = time.perf_counter()
        bases = []
        for peer, (raw, off) in enumerate(shared):
            if peer == self.rank:
                bases.append(buf.ptr)
                continue
            ptr = ctypes.c_void_p()
            _check(lib.ring_ipc_open(raw, ctypes.byref(ptr)),
                   f"cudaIpcOpenMemHandle of process {peer}'s arena")
            self._opened.append(int(ptr.value))
            bases.append(int(ptr.value) + off)
        PEER["ipc_open_s"] += time.perf_counter() - t0
        PEER["ipc_opens"] += len(self._opened)
        PEER["arena_growths"] += 1
        self.bases = bases
        self.nbytes = size

    def local(self, shape) -> torch.Tensor:
        """This process's arena as an int32 tensor of ``shape``."""
        n = 1
        for s in shape:
            n *= s
        return self._local[:n].view(shape)

    def close(self) -> None:
        """Unmap the peers' arenas and drop this one (collective)."""
        if self.nbytes:
            torch.cuda.synchronize(self.device)
            self._close_peers()
            dist.barrier(group=self.group)
        self._local = None
        self.bases = []
        self.nbytes = 0


def ring_all_to_all_peers_plain(blocks: torch.Tensor, group,
                                num_processes: int) -> torch.Tensor:
    """The cross-process move in plain PyTorch: ``blocks [Dl, G, C,
    ...]`` (this process's ``Dl`` source shards, block ``[i, j]`` bound
    for global shard ``j``) -> ``out [Dl, G, C, ...]``, ``out[e, i]`` the
    block global source ``i`` sent to this process's shard ``e``: one
    equal-split ``all_to_all_single`` over ``group``."""
    dl, g = blocks.shape[:2]
    rest = tuple(blocks.shape[2:])
    send = blocks.reshape((dl, num_processes, dl) + rest).transpose(
        0, 1).contiguous()              # [dest process, src, dest local]
    recv = torch.empty_like(send)       # [src process, src, dest local]
    dist.all_to_all_single(recv, send, group=group)
    perm = (2, 0, 1) + tuple(range(3, recv.dim()))
    return recv.permute(perm).reshape((dl, g) + rest)


def ring_all_to_all_peers(blocks: torch.Tensor, mesh) -> torch.Tensor:
    """All-to-all of per-destination blocks across the processes of
    ``mesh`` (a ``GlobalMesh``): ``blocks: int32[Dl, G, C, W]``, this
    process's source shards. Returns ``[Dl, G, C, W]`` with ``out[e, i]``
    the block global shard ``i`` sent to local shard ``e``.

    On ``cuda`` the result is a view of the mesh's receive arena, valid
    until the next exchange over the mesh. Collective: every process of
    the mesh calls it with the same shape. The exchange is fenced by the
    control group: a barrier before the launch (every arena allocated
    and no longer read), the launch over this process's sources into
    every arena, a stream synchronisation and a barrier after it (every
    write landed)."""
    global LAUNCHES
    if not blocks.is_cuda:
        if blocks.device.type == "cpu":
            return ring_all_to_all_peers_plain(blocks, mesh.group,
                                               mesh.num_processes)
        raise ValueError(f"ring_all_to_all_peers runs on cuda or cpu, not "
                         f"{blocks.device}")
    if blocks.dtype != torch.int32:
        raise TypeError(f"ring_all_to_all_peers moves int32 words, got "
                        f"{blocks.dtype}")
    dl, g = mesh.local_shards, mesh.num_shards
    if blocks.dim() != 4 or tuple(blocks.shape[:2]) != (dl, g):
        raise ValueError(f"blocks must be [{dl}, {g}, C, W], got "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    arena = mesh.arena
    arena.ensure(max(4, blocks.numel() * 4))
    out = arena.local(tuple(blocks.shape))
    src, dst = _peer_pointer_table(blocks, arena.bases)
    torch.cuda.current_stream(blocks.device).synchronize()
    dist.barrier(group=mesh.group)
    if blocks.numel():
        _launch(blocks, src, dst, src_begin=mesh.first_shard)
        LAUNCHES += 1
        shape = tuple(blocks.shape)
        SHAPES[shape] = SHAPES.get(shape, 0) + 1
    torch.cuda.current_stream(blocks.device).synchronize()
    dist.barrier(group=mesh.group)
    return out
