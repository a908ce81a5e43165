"""Deterministic fault injection for the control-plane transport AND the
storage dataplane.

The chaos harness the hardened failure path is tested with: a
:class:`FaultInjector` wraps a live :class:`ConnectionCache` (and every
``Connection`` it mints) and injects seeded, scenario-scripted faults at
the exact layers real failures enter — the dial, the send, and the
receive dispatch — so every failure mode the fetch path must survive
(connect refusal, mid-stream disconnect, response delay, payload
bit-flips, blackhole/partition) is reproducible in-process over plain
sockets.

Its sibling :class:`StorageFaultInjector` does the same for the disk
half of the dataplane: the writer's spill/merge writes, the resolver's
rename-commit and index/sidecar writes, mmap-opens, and serve-time
reads all consult cheap module-level hook points
(:func:`storage_check` / :func:`storage_write_cap` /
:func:`storage_corrupt` — no-ops until an injector is installed) so
``ENOSPC``, ``EIO``, torn/short writes, slow-disk stalls, and at-rest
corruption are reproducible on the production code paths. The serving
path has no server CPU to notice a bad block (the committed file is
mmap'd and served one-sided, PAPER §0), so integrity and fencing live
in the data and commit protocol — this injector is how that protocol
is proven.

Faults match on ``(kind, peer, message type, direction)`` with
``after``/``times`` windows and an optional per-match probability drawn
from the injector's seeded RNG, so probabilistic scenarios replay
exactly from their seed (``scripts/run_chaos.sh`` prints the seed of a
failing sweep for replay). The shim leaves everything above it untouched
— endpoints, fetcher, recovery — which is the point: the failure path
under test is the production one, not a mock of it.

The reference has no equivalent; its fault story was never testable
below "kill a JVM and watch Spark recompute" (SURVEY §7 hard part #4).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Type

from sparkrdma_tpu_torch.parallel.transport import (
    Connection,
    ConnectionCache,
    TransportError,
)

log = logging.getLogger(__name__)

Addr = Tuple[str, int]

# Fault kinds.
REFUSE_CONNECT = "refuse_connect"  # the dial raises ConnectionRefusedError
DISCONNECT = "disconnect"          # the connection closes when the match
#                                    fires (recv: response lost + whole
#                                    window failed; send: reset mid-send)
DELAY = "delay"                    # hold the matched message delay_s on
#                                    the delivering/sending thread
CORRUPT = "corrupt"                # flip bits of the matched message's
#                                    payload attribute before delivery
BLACKHOLE = "blackhole"            # drop the matched message silently
#                                    (partition: the requester's deadline
#                                    or heartbeat owns detection)

KINDS = (REFUSE_CONNECT, DISCONNECT, DELAY, CORRUPT, BLACKHOLE)


@dataclass
class Fault:
    """One scripted fault. Matching is AND across the set criteria;
    unset criteria match anything. ``after`` skips the first N matches
    (arm the fault mid-run), ``times`` bounds firings (a burst),
    ``prob`` gates each firing on the injector's seeded RNG."""

    kind: str
    peer: Optional[Addr] = None
    msg_type: Optional[Type] = None   # ignored by refuse_connect
    on: str = "recv"                  # "recv" | "send" (non-connect kinds)
    after: int = 0
    times: Optional[int] = None
    prob: float = 1.0
    delay_s: float = 0.0              # DELAY
    flip_bits: int = 1                # CORRUPT
    attr: str = "data"                # CORRUPT: message field to mutate
    seen: int = 0                     # matches observed (post-filter)
    fired: int = 0                    # faults actually injected

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Seeded chaos shim over one or more ``ConnectionCache``s.

    Thread-safe: connection reader threads, fetch threads, and the
    heartbeat monitor all consult the same fault table. ``install`` is
    reversible per cache (``uninstall``); connections already wrapped
    stay wrapped until closed, which chaos tests do anyway.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self._lock = threading.RLock()
        self._faults: List[Fault] = []
        self._installed: List[Tuple[ConnectionCache, Callable]] = []
        self.fired: Dict[str, int] = {}

    # -- scripting -------------------------------------------------------

    def add(self, kind: str, **kw) -> Fault:
        fault = Fault(kind, **kw)
        with self._lock:
            self._faults.append(fault)
        return fault

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()

    def fired_count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is not None:
                return self.fired.get(kind, 0)
            return sum(self.fired.values())

    # -- installation ----------------------------------------------------

    def install(self, cache: ConnectionCache) -> None:
        """Shadow the cache's per-attempt ``_dial`` (connect faults) and
        its ``_connect`` (to wrap each minted ``Connection``'s send and
        dispatch). Idempotent per cache."""
        with self._lock:
            if any(c is cache for c, _ in self._installed):
                return

            orig_dial = cache._dial
            orig_connect = cache._connect

            def dial(addr, timeout, _orig=orig_dial):
                if self._match(REFUSE_CONNECT, peer=addr) is not None:
                    raise ConnectionRefusedError(
                        f"fault injection: connect to {addr} refused")
                return _orig(addr, timeout)

            def connect(addr, _orig=orig_connect):
                conn = _orig(addr)
                self._wrap_conn(conn, addr)
                return conn

            orig_get = cache.get

            def get(host, port, _orig=orig_get):
                # ensure-wrap on every lookup (idempotent): a dial that
                # was already in flight when install() ran — prewarm
                # threads race exactly this way — inserts its connection
                # past both the connect shim and the snapshot below
                conn = _orig(host, port)
                self._wrap_conn(conn, (host, port))
                return conn

            # instance attributes shadow the class methods; _connect's
            # internal self._dial lookup resolves to the shim
            cache._dial = dial
            cache._connect = connect
            cache.get = get

            def restore(cache=cache):
                cache.__dict__.pop("_dial", None)
                cache.__dict__.pop("_connect", None)
                cache.__dict__.pop("get", None)

            self._installed.append((cache, restore))
            # connections minted before install get wrapped too, so a
            # mid-run install sees pre-warmed/cached peers
            with cache._lock:
                existing = list(cache._conns.items())
        for addr, conn in existing:
            self._wrap_conn(conn, addr)

    def install_endpoint(self, endpoint) -> None:
        """Convenience: shim an endpoint's client-side connection cache
        (covers fetches, heartbeats, and driver traffic it originates)."""
        self.install(endpoint._clients)

    def uninstall(self) -> None:
        with self._lock:
            installed, self._installed = self._installed, []
        for _cache, restore in installed:
            restore()

    # -- fault application -----------------------------------------------

    def _wrap_conn(self, conn: Connection, addr: Addr) -> None:
        if getattr(conn, "_fault_wrapped", False):
            return
        conn._fault_wrapped = True
        orig_dispatch = conn._dispatch
        orig_send = conn.send

        def dispatch(msg, _orig=orig_dispatch, _addr=addr):
            fault = self._match(DELAY, peer=_addr, msg=msg, on="recv")
            if fault is not None:
                # on the reader thread on purpose: later messages on this
                # connection stall behind the delay, exactly like a
                # congested or GC-pausing peer — the window the
                # claim-back-race tests pin open
                time.sleep(fault.delay_s)
            if self._match(BLACKHOLE, peer=_addr, msg=msg,
                           on="recv") is not None:
                log.debug("fault injection: blackholed %s from %s",
                          type(msg).__name__, _addr)
                return
            fault = self._match(CORRUPT, peer=_addr, msg=msg, on="recv")
            if fault is not None:
                self._corrupt(msg, fault)
            if self._match(DISCONNECT, peer=_addr, msg=msg,
                           on="recv") is not None:
                log.debug("fault injection: disconnect from %s before "
                          "delivering %s", _addr, type(msg).__name__)
                conn.close()
                return
            _orig(msg)

        def send(msg, _orig=orig_send, _addr=addr):
            fault = self._match(DELAY, peer=_addr, msg=msg, on="send")
            if fault is not None:
                time.sleep(fault.delay_s)
            if self._match(BLACKHOLE, peer=_addr, msg=msg,
                           on="send") is not None:
                return  # peer never sees it; the deadline owns the rest
            if self._match(DISCONNECT, peer=_addr, msg=msg,
                           on="send") is not None:
                conn.close()
                raise TransportError(
                    f"{conn.name}: fault injection: reset mid-send")
            _orig(msg)

        conn._dispatch = dispatch
        conn.send = send

    def _corrupt(self, msg, fault: Fault) -> None:
        data = getattr(msg, fault.attr, None)
        if not data:
            return
        buf = bytearray(data)
        for _ in range(max(1, fault.flip_bits)):
            with self._lock:
                i = self.rng.randrange(len(buf))
                bit = 1 << self.rng.randrange(8)
            buf[i] ^= bit
        setattr(msg, fault.attr, bytes(buf))
        log.debug("fault injection: flipped %d bit(s) in %s.%s",
                  max(1, fault.flip_bits), type(msg).__name__, fault.attr)

    def _match(self, kind: str, peer: Addr, msg=None,
               on: str = "recv") -> Optional[Fault]:
        with self._lock:
            for fault in self._faults:
                if fault.kind != kind:
                    continue
                if kind != REFUSE_CONNECT and fault.on != on:
                    continue
                if fault.peer is not None and fault.peer != peer:
                    continue
                if (fault.msg_type is not None
                        and not isinstance(msg, fault.msg_type)):
                    continue
                fault.seen += 1
                if fault.seen <= fault.after:
                    continue
                if fault.times is not None and fault.fired >= fault.times:
                    continue
                if fault.prob < 1.0 and self.rng.random() >= fault.prob:
                    continue
                fault.fired += 1
                self.fired[kind] = self.fired.get(kind, 0) + 1
                return fault
        return None


# -- storage faults -------------------------------------------------------

# Storage fault kinds.
ENOSPC = "enospc"              # the op raises OSError(ENOSPC)
EIO = "eio"                    # the op raises OSError(EIO)
TORN_WRITE = "torn_write"      # the write lands SHORT (torn_bytes of it)
#                                then raises OSError(EIO) — the crash
#                                window a rename-commit must mask
SLOW_DISK = "slow_disk"        # hold the op delay_s on the calling thread
CORRUPT_AT_REST = "corrupt_at_rest"  # flip bits in the target file AFTER
#                                the op completes (bit-rot of committed
#                                bytes; the CRC sidecar owns detection)

STORAGE_KINDS = (ENOSPC, EIO, TORN_WRITE, SLOW_DISK, CORRUPT_AT_REST)

# Hook-point op names (the layers real disk failures enter):
#   spill_write   writer background spill file writes
#   merge_write   writer close()-time merge into the data tmp
#   commit        resolver rename-commit of the data file (also the
#                 corrupt-at-rest hook: fires on the COMMITTED file)
#   index_write   resolver index/sidecar durability writes
#   mmap_open     SpillFile/block-server mapping of a committed file
#   serve_read    resolver serve-time block reads


@dataclass
class StorageFault:
    """One scripted storage fault. Matching is AND across set criteria
    (op name, path substring); ``after``/``times``/``prob`` behave as on
    :class:`Fault`."""

    kind: str
    op: Optional[str] = None          # None matches any op
    path_substr: Optional[str] = None
    after: int = 0
    times: Optional[int] = None
    prob: float = 1.0
    delay_s: float = 0.0              # SLOW_DISK
    torn_bytes: int = 64              # TORN_WRITE: bytes that land
    flip_bits: int = 1                # CORRUPT_AT_REST
    seen: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in STORAGE_KINDS:
            raise ValueError(f"unknown storage fault kind {self.kind!r}")


class StorageFaultInjector:
    """Seeded chaos shim over the storage dataplane.

    Installed process-globally (``install()``/``uninstall()``): the
    writer, resolver, and block server consult the module hook on every
    guarded file op, which is a single ``is None`` check when no
    injector is active. Same ``after``/``times``/``prob`` windows and
    seeded RNG as the transport injector, so a failing
    ``scripts/run_chaos.sh CHAOS_DISK=1`` sweep replays from its seed.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self._lock = threading.RLock()
        self._faults: List[StorageFault] = []
        self.fired: Dict[str, int] = {}

    # -- scripting -------------------------------------------------------

    def add(self, kind: str, **kw) -> StorageFault:
        fault = StorageFault(kind, **kw)
        with self._lock:
            self._faults.append(fault)
        return fault

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()

    def fired_count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is not None:
                return self.fired.get(kind, 0)
            return sum(self.fired.values())

    # -- installation ----------------------------------------------------

    def install(self) -> None:
        global _STORAGE
        _STORAGE = self

    def uninstall(self) -> None:
        global _STORAGE
        if _STORAGE is self:
            _STORAGE = None

    # -- fault application (called from the module hooks) ----------------

    def check(self, op: str, path: str) -> None:
        """Raise/stall for error-kind faults matching ``(op, path)``."""
        import errno

        fault = self._match(SLOW_DISK, op, path)
        if fault is not None:
            time.sleep(fault.delay_s)
        fault = self._match(ENOSPC, op, path)
        if fault is not None:
            raise OSError(errno.ENOSPC,
                          f"fault injection: no space ({op})", path)
        fault = self._match(EIO, op, path)
        if fault is not None:
            raise OSError(errno.EIO, f"fault injection: I/O error ({op})",
                          path)

    def write_cap(self, op: str, path: str, nbytes: int) -> Optional[int]:
        """TORN_WRITE: how many of ``nbytes`` should actually land before
        the write fails (None = no fault, write everything)."""
        fault = self._match(TORN_WRITE, op, path)
        if fault is None:
            return None
        return max(0, min(fault.torn_bytes, nbytes - 1))

    def corrupt(self, op: str, path: str) -> bool:
        """CORRUPT_AT_REST: flip seeded bits in ``path`` in place (the
        sidecar was already written from the clean bytes — this is rot
        AFTER commit). Returns True if a fault fired."""
        fault = self._match(CORRUPT_AT_REST, op, path)
        if fault is None:
            return False
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        if size == 0:
            return False
        with open(path, "r+b") as f:
            for _ in range(max(1, fault.flip_bits)):
                with self._lock:
                    pos = self.rng.randrange(size)
                    bit = 1 << self.rng.randrange(8)
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ bit]))
        log.debug("fault injection: flipped %d bit(s) at rest in %s",
                  max(1, fault.flip_bits), path)
        return True

    def _match(self, kind: str, op: str, path: str) -> Optional[StorageFault]:
        with self._lock:
            for fault in self._faults:
                if fault.kind != kind:
                    continue
                if fault.op is not None and fault.op != op:
                    continue
                if (fault.path_substr is not None
                        and fault.path_substr not in path):
                    continue
                fault.seen += 1
                if fault.seen <= fault.after:
                    continue
                if fault.times is not None and fault.fired >= fault.times:
                    continue
                if fault.prob < 1.0 and self.rng.random() >= fault.prob:
                    continue
                fault.fired += 1
                self.fired[kind] = self.fired.get(kind, 0) + 1
                return fault
        return None


# Process-global storage injector (None = no chaos, hooks are no-ops).
_STORAGE: Optional[StorageFaultInjector] = None


def storage_check(op: str, path: str) -> None:
    """Production hook: raise/stall if a storage fault matches. A single
    attribute load + ``is None`` test when no injector is installed."""
    inj = _STORAGE
    if inj is not None:
        inj.check(op, path)


def storage_write_cap(op: str, path: str, nbytes: int) -> Optional[int]:
    """Production hook for torn/short writes: bytes to land before
    failing, or None for a full write."""
    inj = _STORAGE
    if inj is not None:
        return inj.write_cap(op, path, nbytes)
    return None


def storage_corrupt(op: str, path: str) -> None:
    """Production hook: flip bits at rest in ``path`` if a
    CORRUPT_AT_REST fault matches (no-op otherwise)."""
    inj = _STORAGE
    if inj is not None:
        inj.corrupt(op, path)


# -- blob-store faults ----------------------------------------------------

# Blob fault kinds (the cold tier's failure surface — shuffle/cold_tier.py).
BLOB_UNAVAILABLE = "unavailable"       # the op raises OSError (store down)
BLOB_SLOW = "slow"                     # hold the op delay_s on the caller
TORN_UPLOAD = "torn_upload"            # the put lands SHORT (torn_bytes)
#                                        then errors — must never become
#                                        visible (the atomicity contract)
BLOB_CORRUPT = "corrupt_at_rest"       # flip bits in the stored blob AFTER
#                                        the put commits (rot; the entry
#                                        CRC owns detection on restore)
QUOTA_EXHAUSTED = "quota_exhausted"    # the put raises OSError(EDQUOT)

BLOB_KINDS = (BLOB_UNAVAILABLE, BLOB_SLOW, TORN_UPLOAD, BLOB_CORRUPT,
              QUOTA_EXHAUSTED)

# Hook-point op names (the blob contract's four verbs):
#   put     TieringService uploads (segments + drain rows)
#   get     reducer-side restores
#   list    reap/GC prefix scans
#   delete  tombstone reaps


@dataclass
class BlobFault:
    """One scripted blob-store fault. Matching is AND across set
    criteria (op name, key substring); ``after``/``times``/``prob``
    behave as on :class:`Fault`."""

    kind: str
    op: Optional[str] = None          # None matches any op
    key_substr: Optional[str] = None
    after: int = 0
    times: Optional[int] = None
    prob: float = 1.0
    delay_s: float = 0.0              # BLOB_SLOW
    torn_bytes: int = 64              # TORN_UPLOAD: bytes that land
    flip_bits: int = 1                # BLOB_CORRUPT
    seen: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in BLOB_KINDS:
            raise ValueError(f"unknown blob fault kind {self.kind!r}")


class BlobFaultInjector:
    """Seeded chaos shim over the blob store, sibling of
    :class:`StorageFaultInjector`: installed process-globally, the
    :class:`~sparkrdma_tpu_torch.shuffle.cold_tier.FSBlobStore` consults the
    module hooks on every put/get/list/delete — a single ``is None``
    check when no injector is active. Same ``after``/``times``/``prob``
    windows and seeded RNG, so a failing
    ``scripts/run_chaos.sh CHAOS_COLD=1`` sweep replays from its seed."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self._lock = threading.RLock()
        self._faults: List[BlobFault] = []
        self.fired: Dict[str, int] = {}

    # -- scripting -------------------------------------------------------

    def add(self, kind: str, **kw) -> BlobFault:
        fault = BlobFault(kind, **kw)
        with self._lock:
            self._faults.append(fault)
        return fault

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()

    def fired_count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is not None:
                return self.fired.get(kind, 0)
            return sum(self.fired.values())

    # -- installation ----------------------------------------------------

    def install(self) -> None:
        global _BLOB
        _BLOB = self

    def uninstall(self) -> None:
        global _BLOB
        if _BLOB is self:
            _BLOB = None

    # -- fault application (called from the module hooks) ----------------

    def check(self, op: str, key: str) -> None:
        """Raise/stall for error-kind faults matching ``(op, key)``."""
        import errno

        fault = self._match(BLOB_SLOW, op, key)
        if fault is not None:
            time.sleep(fault.delay_s)
        fault = self._match(BLOB_UNAVAILABLE, op, key)
        if fault is not None:
            raise OSError(errno.EIO,
                          f"fault injection: blob store unavailable ({op})",
                          key)
        fault = self._match(QUOTA_EXHAUSTED, op, key)
        if fault is not None:
            raise OSError(errno.EDQUOT,
                          f"fault injection: blob quota exhausted ({op})",
                          key)

    def write_cap(self, op: str, key: str, nbytes: int) -> Optional[int]:
        """TORN_UPLOAD: how many of ``nbytes`` should land before the
        put fails (None = no fault, write everything)."""
        fault = self._match(TORN_UPLOAD, op, key)
        if fault is None:
            return None
        return max(0, min(fault.torn_bytes, nbytes - 1))

    def corrupt(self, op: str, path: str) -> bool:
        """BLOB_CORRUPT: flip seeded bits in the committed blob file in
        place (rot AFTER the put — the published CRC covers the clean
        bytes, so restore-time verification owns detection). Returns
        True if a fault fired."""
        fault = self._match(BLOB_CORRUPT, op, path)
        if fault is None:
            return False
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        if size == 0:
            return False
        with open(path, "r+b") as f:
            for _ in range(max(1, fault.flip_bits)):
                with self._lock:
                    pos = self.rng.randrange(size)
                    bit = 1 << self.rng.randrange(8)
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ bit]))
        log.debug("fault injection: flipped %d bit(s) in blob %s",
                  max(1, fault.flip_bits), path)
        return True

    def _match(self, kind: str, op: str, key: str) -> Optional[BlobFault]:
        with self._lock:
            for fault in self._faults:
                if fault.kind != kind:
                    continue
                if fault.op is not None and fault.op != op:
                    continue
                if (fault.key_substr is not None
                        and fault.key_substr not in key):
                    continue
                fault.seen += 1
                if fault.seen <= fault.after:
                    continue
                if fault.times is not None and fault.fired >= fault.times:
                    continue
                if fault.prob < 1.0 and self.rng.random() >= fault.prob:
                    continue
                fault.fired += 1
                self.fired[kind] = self.fired.get(kind, 0) + 1
                return fault
        return None


# Process-global blob injector (None = no chaos, hooks are no-ops).
_BLOB: Optional[BlobFaultInjector] = None


def blob_check(op: str, key: str) -> None:
    """Production hook: raise/stall if a blob fault matches. A single
    attribute load + ``is None`` test when no injector is installed."""
    inj = _BLOB
    if inj is not None:
        inj.check(op, key)


def blob_write_cap(op: str, key: str, nbytes: int) -> Optional[int]:
    """Production hook for torn uploads: bytes to land before failing,
    or None for a full write."""
    inj = _BLOB
    if inj is not None:
        return inj.write_cap(op, key, nbytes)
    return None


def blob_corrupt(op: str, path: str) -> None:
    """Production hook: flip bits at rest in the committed blob file if
    a BLOB_CORRUPT fault matches (no-op otherwise)."""
    inj = _BLOB
    if inj is not None:
        inj.corrupt(op, path)
