"""ctypes bindings for the native runtime shim (``csrc/``).

The reference's equivalent layer is libdisni's JNI binding of libibverbs
(pom.xml:79-96; load-failure handling at java/RdmaNode.java:109-112 — a
missing native library degrades with a clear message rather than crashing).
We keep that behavior: if ``libtpushuffle.so`` is absent or unloadable,
``LIB`` is ``None`` and callers fall back to pure-Python implementations.

Rebuild with ``make -C csrc``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

# the port's own shim, compiled from the checkout's csrc/*.cpp into
# build/ on first import (runtime/shim_build.py)
from sparkrdma_tpu_torch.runtime.shim_build import host_shim_path

_LIB_PATH = str(host_shim_path())


def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        return _bind(lib)
    except (OSError, AttributeError):
        # missing OR stale .so (built before a symbol was added): degrade to
        # pure Python rather than failing package import
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, i64, vp, cp = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p)
    lib.arena_create.argtypes = [u64, u64, ctypes.c_int]
    lib.arena_create.restype = vp
    lib.arena_get.argtypes = [vp, u64]
    lib.arena_get.restype = i64
    lib.arena_put.argtypes = [vp, i64]
    lib.arena_put.restype = ctypes.c_int
    lib.arena_preallocate.argtypes = [vp, u64, u64]
    lib.arena_preallocate.restype = ctypes.c_int
    lib.arena_buf_ptr.argtypes = [vp, i64]
    lib.arena_buf_ptr.restype = vp
    lib.arena_buf_size.argtypes = [vp, i64]
    lib.arena_buf_size.restype = u64
    lib.arena_total_bytes.argtypes = [vp]
    lib.arena_total_bytes.restype = u64
    lib.arena_idle_bytes.argtypes = [vp]
    lib.arena_idle_bytes.restype = u64
    lib.arena_trim.argtypes = [vp, u64]
    lib.arena_trim.restype = None
    lib.arena_stats_json.argtypes = [vp, cp, ctypes.c_int]
    lib.arena_stats_json.restype = ctypes.c_int
    lib.arena_destroy.argtypes = [vp]
    lib.arena_destroy.restype = None
    lib.staging_map_file.argtypes = [cp, ctypes.POINTER(u64)]
    lib.staging_map_file.restype = vp
    lib.staging_unmap.argtypes = [vp]
    lib.staging_unmap.restype = None
    lib.staging_gather.argtypes = [vp, ctypes.POINTER(u64), ctypes.POINTER(u64),
                                   u64, cp, ctypes.c_int]
    lib.staging_gather.restype = i64
    lib.mem_gather.argtypes = [cp, ctypes.POINTER(u64), ctypes.POINTER(u64),
                               u64, cp, ctypes.c_int]
    lib.mem_gather.restype = i64
    # optional symbol: a pre-scatter .so degrades to the numpy scatter
    # fallback (identical run layout), not a disabled native runtime
    if hasattr(lib, "writer_scatter"):
        lib.writer_scatter.argtypes = [ctypes.POINTER(u64), cp, u64, u64,
                                       ctypes.POINTER(i64), ctypes.c_uint32,
                                       cp, ctypes.POINTER(u64), ctypes.c_int]
        lib.writer_scatter.restype = i64
    u16 = ctypes.c_uint16
    lib.bs_create.argtypes = [cp, u16, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.bs_create.restype = vp
    lib.bs_port.argtypes = [vp]
    lib.bs_port.restype = u16
    # optional symbol: a pre-CRC .so must degrade to unchecksummed native
    # responses (BlockServer.set_checksum warns), not disable the whole
    # native runtime the way a missing REQUIRED symbol does
    if hasattr(lib, "bs_set_checksum"):
        lib.bs_set_checksum.argtypes = [vp, ctypes.c_int]
        lib.bs_set_checksum.restype = None
    # optional symbols: the one-sided serve path (zero-copy responses,
    # registration-on-demand region pool, CRC-reuse tables). A pre-serve-
    # path .so degrades to its eager-mmap copy behavior; the Python
    # control plane guards each call with has_serve_path().
    if hasattr(lib, "bs_set_zero_copy"):
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.bs_set_zero_copy.argtypes = [vp, ctypes.c_int]
        lib.bs_set_zero_copy.restype = None
        lib.bs_set_region_budget.argtypes = [vp, u64]
        lib.bs_set_region_budget.restype = None
        lib.bs_set_file_crcs.argtypes = [vp, ctypes.c_uint32,
                                         ctypes.POINTER(u64), u32p, u32p,
                                         ctypes.c_uint32]
        lib.bs_set_file_crcs.restype = ctypes.c_int
        for fn in ("bs_mapped_bytes", "bs_peak_mapped_bytes",
                   "bs_registered_bytes", "bs_remaps",
                   "bs_zero_copy_blocks", "bs_crc_reused",
                   "bs_pin_events"):
            getattr(lib, fn).argtypes = [vp]
            getattr(lib, fn).restype = u64
    lib.bs_register_file.argtypes = [vp, ctypes.c_uint32, cp]
    lib.bs_register_file.restype = ctypes.c_int
    # optional symbols: tenant-tagged registration + fair-share serving
    # (multi-tenant DRR request queue). A pre-tenancy .so degrades to
    # FIFO serving under tenant 0.
    if hasattr(lib, "bs_set_fair"):
        lib.bs_register_file2.argtypes = [vp, ctypes.c_uint32, cp,
                                          ctypes.c_uint32]
        lib.bs_register_file2.restype = ctypes.c_int
        lib.bs_set_fair.argtypes = [vp, ctypes.c_int, u64]
        lib.bs_set_fair.restype = None
        lib.bs_fair_queued.argtypes = [vp]
        lib.bs_fair_queued.restype = u64
    # optional symbols: the native client fetch engine (doorbell-batched
    # vectored reads scattered straight into BufferPool lease memory,
    # CRC trailers verified in C). A pre-client .so degrades to the
    # Python fetcher; callers guard with has_fetch_client().
    if hasattr(lib, "fc_create"):
        lib.fc_create.argtypes = []
        lib.fc_create.restype = vp
        lib.fc_io_uring.argtypes = [vp]
        lib.fc_io_uring.restype = ctypes.c_int
        lib.fc_connect.argtypes = [vp, cp, u16, ctypes.c_int, ctypes.c_int]
        lib.fc_connect.restype = i64
        lib.fc_submit.argtypes = [vp, i64, u64, ctypes.c_uint32, cp,
                                  ctypes.c_uint32, vp, u64]
        lib.fc_submit.restype = ctypes.c_int
        lib.fc_submit_raw.argtypes = [vp, i64, u64, cp, u64, vp, u64]
        lib.fc_submit_raw.restype = ctypes.c_int
        lib.fc_flush.argtypes = [vp]
        lib.fc_flush.restype = ctypes.c_int
        lib.fc_poll.argtypes = [vp, ctypes.c_int, vp, ctypes.c_int]
        lib.fc_poll.restype = ctypes.c_int
        lib.fc_pending.argtypes = [vp, i64]
        lib.fc_pending.restype = i64
        lib.fc_conn_alive.argtypes = [vp, i64]
        lib.fc_conn_alive.restype = ctypes.c_int
        for fn in ("fc_flush_count", "fc_writev_count", "fc_frames_sent",
                   "fc_conns_killed"):
            getattr(lib, fn).argtypes = [vp]
            getattr(lib, fn).restype = u64
        lib.fc_close.argtypes = [vp, i64]
        lib.fc_close.restype = None
        lib.fc_destroy.argtypes = [vp]
        lib.fc_destroy.restype = None
    lib.bs_unregister_file.argtypes = [vp, ctypes.c_uint32]
    lib.bs_unregister_file.restype = ctypes.c_int
    lib.bs_bytes_served.argtypes = [vp]
    lib.bs_bytes_served.restype = u64
    lib.bs_requests_served.argtypes = [vp]
    lib.bs_requests_served.restype = u64
    lib.bs_stop.argtypes = [vp]
    lib.bs_stop.restype = None
    return lib


LIB = _load()


def available() -> bool:
    return LIB is not None


def has_writer_scatter() -> bool:
    """True when the loaded .so exports the streaming write-path scatter
    kernel (csrc/writer.cpp) — older checked-in builds predate it."""
    return LIB is not None and hasattr(LIB, "writer_scatter")


def has_serve_path() -> bool:
    """True when the loaded .so exports the one-sided serve path (zero-
    copy responses, registered-region pool, CRC reuse) — older builds
    degrade to eager-mmap copy serving."""
    return LIB is not None and hasattr(LIB, "bs_set_zero_copy")


def has_fetch_client() -> bool:
    """True when the loaded .so exports the native client fetch engine
    (csrc/fetchclient.cpp: doorbell-batched vectored reads into lease
    memory) — older builds keep the pure-Python fetcher."""
    return LIB is not None and hasattr(LIB, "fc_create")


def has_fair_serving() -> bool:
    """True when the loaded .so exports tenant-tagged registration and
    the DRR fair-share request queue — older builds serve FIFO under
    tenant 0."""
    return LIB is not None and hasattr(LIB, "bs_set_fair")
