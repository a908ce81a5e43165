"""Python control plane over the native block server (``csrc/blockserver.cpp``).

The executor's data-serving path without Python in it: epoll workers in
the shared library serve FetchBlocks frames by zero-copy ``sendmsg`` from
a lease-accounted pool of registered regions. This wrapper is deliberately
a THIN CONTROL PLANE — register/unregister/verify and gauges only; no
request ever routes through it (the Python serve loop in
``parallel/endpoints.py`` survives solely as the no-native fallback,
parity-gated by ``tests/test_serve_path.py``):

* **register/unregister** — hand (token -> path) mappings to the native
  pool. Registration is on-demand (NP-RDMA-style): the native side
  validates the file but maps it at first serve, LRU-unmapping under
  ``registered_region_budget`` pressure and remapping as serves return.
  Unregister is pin-safe: an in-flight serve holds a refcount pin, so the
  munmap defers to the last unpin — never under a live gather.
* **verify attestation** — forward at-rest sidecar / merge-ledger CRC
  ranges (``register_file(crc_ranges=...)``) so CRC-trailer serves whose
  blocks tile attested ranges reuse the committed CRCs (zero-copy with
  checksums on) instead of recomputing per serve.
* **gauges** — ``stats()`` surfaces the pool the way ``BufferPool.
  leased_bytes`` surfaces host staging memory: registered vs mapped
  bytes, remaps, pins, zero-copy blocks, CRC reuses. ``trace_serve()``
  emits the deltas as trace instants (``serve.pin`` / ``serve.zero_copy``
  / ``serve.remap``).

Peers discover the port through ``ShuffleManagerId.block_port`` and fetch
over a plain pipelined connection (same wire protocol as the Python path,
so the fetcher is transport-agnostic).
"""

from __future__ import annotations

import ctypes
import logging
import socket
import threading
from typing import Optional, Sequence, Tuple

from sparkrdma_tpu_torch.runtime import native

log = logging.getLogger(__name__)

#: stats()/trace_serve() keys backed by native pool counters
_POOL_COUNTERS = (
    ("mapped_bytes", "bs_mapped_bytes"),
    ("peak_mapped_bytes", "bs_peak_mapped_bytes"),
    ("registered_bytes", "bs_registered_bytes"),
    ("remaps", "bs_remaps"),
    ("zero_copy_blocks", "bs_zero_copy_blocks"),
    ("crc_reused", "bs_crc_reused"),
    ("pin_events", "bs_pin_events"),
)


class BlockServer:
    """Owns one native server instance; thread-safe.

    ``host`` bounds the network exposure of the (unauthenticated) data
    port: it defaults to loopback and should be set to the control-plane
    host for multi-host deployments, which must firewall the port — the
    reference's verbs listener binds its one host the same way
    (java/RdmaNode.java:74-88). Connections are sharded round-robin over
    ``threads`` epoll workers, optionally pinned to ``cpus``
    (java/RdmaNode.java:222-279, java/RdmaThread.java:46-48 analogue).
    """

    def __init__(self, port: int = 0, host: str = "",
                 threads: int = 1, cpus: Sequence[int] = (),
                 checksum: bool = False, region_budget: int = 0,
                 zero_copy: bool = True, tracer=None):
        if not native.available():
            raise RuntimeError("native runtime not built (make -C csrc)")
        addr = socket.gethostbyname(host) if host else ""
        cpu_arr = (ctypes.c_int * len(cpus))(*cpus) if cpus else None
        self._h = native.LIB.bs_create(addr.encode(), port, max(1, threads),
                                       cpu_arr, len(cpus))
        if not self._h:
            raise OSError(f"block server failed to bind {addr or 'loopback'}"
                          f":{port}")
        self._lock = threading.Lock()
        self._stopped = False
        self._tracer = tracer
        self._traced = {k: 0 for k, _ in _POOL_COUNTERS}  # last trace_serve
        if checksum:
            self.set_checksum(True)
        if not zero_copy:
            self.set_zero_copy(False)
        if region_budget:
            self.set_region_budget(region_budget)

    def set_checksum(self, enabled: bool) -> None:
        """Per-block CRC32 response trailers (FLAG_CRC32), matching the
        Python serving path — what lets a client isolate a corrupt
        sub-range of a vectored response to one block/map. Requires a
        .so built with ``bs_set_checksum``; a stale library degrades to
        unchecksummed responses (clients verify only when the flag is
        present)."""
        with self._lock:
            if self._stopped:
                return
            fn = getattr(native.LIB, "bs_set_checksum", None)
            if fn is None:  # pre-CRC .so
                log.warning("libtpushuffle.so predates bs_set_checksum; "
                            "native responses stay unchecksummed "
                            "(rebuild with make -C csrc)")
                return
            fn(self._h, int(enabled))

    def set_zero_copy(self, enabled: bool) -> None:
        """Toggle the zero-copy serve fast path (``serve_zero_copy``).
        Off = every block pays the copy fallback — the regression escape
        hatch and the serve bench's memcpy baseline. Responses are
        byte-identical either way."""
        with self._lock:
            if self._stopped or not native.has_serve_path():
                return
            native.LIB.bs_set_zero_copy(self._h, int(enabled))

    def set_region_budget(self, budget_bytes: int) -> None:
        """Mapped-bytes budget of the registered-region pool
        (``registered_region_budget``); 0 = unbounded. Past it the
        least-recently-served unpinned mappings unmap (LRU) and remap on
        demand — serves stay correct, they just pay a remap."""
        with self._lock:
            if self._stopped or not native.has_serve_path():
                if budget_bytes and not native.has_serve_path():
                    log.warning("libtpushuffle.so predates the registered-"
                                "region pool; registered_region_budget is "
                                "ignored (rebuild with make -C csrc)")
                return
            native.LIB.bs_set_region_budget(self._h, int(budget_bytes))

    @property
    def port(self) -> int:
        with self._lock:
            if self._stopped:
                return 0
            return int(native.LIB.bs_port(self._h))

    def set_fair(self, enabled: bool, quantum_bytes: int = 0) -> None:
        """Deficit-round-robin fair-share serving (``fair_share_serving``
        / ``fair_share_quantum_bytes``): requests queue per owning
        tenant of the requested token and dispatch by byte-cost DRR. A
        pre-tenancy .so degrades to FIFO serving (warned once)."""
        with self._lock:
            if self._stopped:
                return
            if not native.has_fair_serving():
                if enabled:
                    log.warning("libtpushuffle.so predates fair-share "
                                "serving; native responses stay FIFO "
                                "(rebuild with make -C csrc)")
                return
            native.LIB.bs_set_fair(self._h, int(enabled),
                                   int(quantum_bytes))

    def fair_queued(self) -> int:
        """Requests ever deferred through the fair-share DRR queues
        (0 with fair serving off or a pre-tenancy .so)."""
        with self._lock:
            if self._stopped or not native.has_fair_serving():
                return 0
            return int(native.LIB.bs_fair_queued(self._h))

    def register_file(self, token: int, path: str,
                      crc_ranges: Optional[Sequence[Tuple[int, int, int]]]
                      = None, tenant: int = 0) -> None:
        """Register ``path`` for serving under ``token`` (validated now,
        mapped at first serve) owned by ``tenant`` (keys fair-share
        queueing and budget-eviction shares). ``crc_ranges`` — optional
        attested ``(offset, length, crc32)`` ranges from the at-rest
        sidecar or the merge ledger — lets CRC-trailer serves over
        aligned blocks reuse the committed CRCs instead of
        recomputing."""
        # chaos hook: an mmap-open failure here surfaces as an OSError at
        # commit/recover time (the write-failure path owns it) instead of
        # a silently unservable token
        from sparkrdma_tpu_torch.parallel import faults as fault_mod
        fault_mod.storage_check("mmap_open", path)
        with self._lock:
            if self._stopped:
                return
            if tenant and native.has_fair_serving():
                rc = native.LIB.bs_register_file2(self._h, token,
                                                  path.encode(),
                                                  int(tenant))
            else:
                rc = native.LIB.bs_register_file(self._h, token,
                                                 path.encode())
            if rc != 0:
                raise OSError(f"block server could not map {path}")
            if crc_ranges and native.has_serve_path():
                n = len(crc_ranges)
                offs = (ctypes.c_uint64 * n)(*(int(o) for o, _, _ in
                                               crc_ranges))
                lens = (ctypes.c_uint32 * n)(*(int(ln) for _, ln, _ in
                                               crc_ranges))
                crcs = (ctypes.c_uint32 * n)(
                    *((int(c) & 0xFFFFFFFF) for _, _, c in crc_ranges))
                native.LIB.bs_set_file_crcs(self._h, token, offs, lens,
                                            crcs, n)

    def unregister_file(self, token: int) -> None:
        """Withdraw a token. New requests answer UNKNOWN immediately; the
        native side defers the munmap until in-flight serve pins drain,
        so this is safe during an in-flight vectored serve (what lets
        ``resolver._quarantine`` demote a corrupt output without racing
        its own readers)."""
        with self._lock:
            if not self._stopped:
                native.LIB.bs_unregister_file(self._h, token)

    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        if self._stopped:
            out = {"bytes_served": 0, "requests_served": 0}
            out.update({k: 0 for k, _ in _POOL_COUNTERS})
            return out
        out = {
            "bytes_served": int(native.LIB.bs_bytes_served(self._h)),
            "requests_served": int(native.LIB.bs_requests_served(self._h)),
        }
        for key, sym in _POOL_COUNTERS:
            out[key] = (int(getattr(native.LIB, sym)(self._h))
                        if native.has_serve_path() else 0)
        return out

    def trace_serve(self) -> dict:
        """Emit the registered-region pool's activity since the last call
        as trace instants and return the snapshot. ``serve.pin`` carries
        pin events + the mapped/registered gauges, ``serve.zero_copy``
        the blocks served without a copy (CRC reuses included), and
        ``serve.remap`` fires only when LRU pressure actually caused
        remaps — the budget-below-working-set audit trail."""
        with self._lock:
            snap = self._stats_locked()
            tracer = self._tracer
            if tracer is None:
                return snap
            delta = {k: snap[k] - self._traced.get(k, 0)
                     for k, _ in _POOL_COUNTERS}
            for k, _ in _POOL_COUNTERS:
                self._traced[k] = snap[k]
        tracer.instant("serve.pin", "serve",
                       pins=delta["pin_events"],
                       mapped_bytes=snap["mapped_bytes"],
                       registered_bytes=snap["registered_bytes"])
        tracer.instant("serve.zero_copy", "serve",
                       blocks=delta["zero_copy_blocks"],
                       crc_reused=delta["crc_reused"])
        if delta["remaps"]:
            tracer.instant("serve.remap", "serve", remaps=delta["remaps"],
                           mapped_bytes=snap["mapped_bytes"])
        return snap

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            native.LIB.bs_stop(self._h)
            self._h = None


def maybe_create(conf, host: str = "", tracer=None) -> Optional[BlockServer]:
    """A server when the native runtime is built and enabled; else None.

    ``host`` is the control-plane bind host: the data port never listens
    wider than the control plane does.
    """
    if conf.use_cpp_runtime and native.available():
        cpus = []
        for part in str(conf.block_server_cpus).split(","):
            part = part.strip()
            if part.isdigit():
                cpus.append(int(part))
            elif part:
                log.warning("block_server_cpus: ignoring unparseable token "
                            "%r (expected a comma-separated core list)", part)
        try:
            srv = BlockServer(host=host, threads=conf.block_server_threads,
                              cpus=cpus, checksum=conf.fetch_checksum,
                              region_budget=conf.registered_region_budget,
                              zero_copy=conf.serve_zero_copy,
                              tracer=tracer)
            srv.set_fair(conf.fair_share_serving,
                         conf.fair_share_quantum_bytes)
            return srv
        except (OSError, socket.gaierror) as e:
            log.warning("native block server unavailable, serving via the "
                        "control path instead: %s", e)
            return None
    return None
