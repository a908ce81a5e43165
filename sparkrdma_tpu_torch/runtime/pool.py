"""Host staging-buffer pool.

Re-design of the reference's pinned-MR pool (java/RdmaBufferManager.java):

* power-of-two bins with a minimum block size (RdmaBufferManager.java:93,
  147-161) — requests round up to the bin size;
* ``preallocate`` carving many buffers out of few large regions
  (RdmaBufferManager.java:124-135);
* LRU trim when idle bytes exceed 90% of the budget, down to 65%
  (RdmaBufferManager.java:169-211);
* allocation stats for the stop-time dump (RdmaBufferManager.java:217-231);
* refcounted multi-view leases — one pool buffer serving several logical
  blocks (java/RdmaRegisteredBuffer.java:28-87, used to land one
  scatter-READ of many blocks in a single registration).

Backed by the C++ arena (``csrc/arena.cpp``) when built; a pure-Python
fallback with identical semantics keeps the framework importable anywhere.
Buffer **tokens** (small ints) name pool buffers in MapTaskOutput entries —
the role (address, lkey) pairs play in the reference.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, Optional

import numpy as np

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.runtime import native


def _round_up_pow2(size: int, min_block: int) -> int:
    b = min_block
    while b < size:
        b <<= 1
    return b


class PoolBuffer:
    """One leased pool buffer. ``view`` is a writable numpy uint8 view.
    ``tenant`` is who the lease is charged to (tenancy.DEFAULT_TENANT
    for every pre-tenancy caller)."""

    __slots__ = ("token", "size", "view", "tenant", "_pool", "_freed",
                 "_free_lock")

    def __init__(self, token: int, size: int, view: np.ndarray,
                 pool: "BufferPool", tenant: int = 0):
        self.token = token
        self.size = size
        self.view = view
        self.tenant = tenant
        self._pool = pool
        self._freed = False
        self._free_lock = threading.Lock()

    def free(self) -> None:
        # Race-safe, not merely idempotent: lease releases can arrive
        # from a fetch engine thread and the consumer simultaneously —
        # exactly one caller may return the token or the arena serves
        # the same buffer to two tenants.
        with self._free_lock:
            if self._freed:
                return
            self._freed = True
        self._pool._release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()


class RegisteredBuffer:
    """Refcounted lease that bump-allocates block views from one PoolBuffer.

    Reference: java/RdmaRegisteredBuffer.java:28-87 — many blocks land in one
    registered region; the region returns to the pool on last release.
    """

    def __init__(self, pool: "BufferPool", size: int, tenant: int = 0):
        self._buf = pool.get(size, tenant=tenant)
        self._offset = 0
        self._refs = 1  # creator's reference
        self._lock = threading.Lock()

    @property
    def token(self) -> int:
        return self._buf.token

    def retain(self) -> None:
        with self._lock:
            self._refs += 1

    def release(self) -> None:
        with self._lock:
            assert self._refs > 0, \
                "RegisteredBuffer over-released (refcount underflow)"
            self._refs -= 1
            last = self._refs == 0
        if last:
            self._buf.free()

    def slice(self, length: int) -> np.ndarray:
        """Bump-allocate the next `length` bytes (RdmaRegisteredBuffer.java:72-87)."""
        with self._lock:
            if self._offset + length > self._buf.size:
                raise ValueError("registered buffer exhausted")
            view = self._buf.view[self._offset:self._offset + length]
            self._offset += length
            self._refs += 1
        return view


class _PyArena:
    """Pure-Python fallback arena with the same bin/trim semantics."""

    def __init__(self, max_alloc: int, min_block: int, zero_on_get: bool):
        self.max_alloc = max_alloc
        self.min_block = min_block
        self.zero_on_get = zero_on_get
        self._bufs: Dict[int, np.ndarray] = {}
        self._free: Dict[int, list] = {}  # bin_size -> [tokens]
        self._sizes: Dict[int, int] = {}
        self._carved: set = set()
        self._seq: Dict[int, float] = {}
        self._next = 0
        self.total_bytes = 0
        self.idle_bytes = 0
        self.stats: Dict[int, Dict[str, int]] = {}

    def _stat(self, size: int) -> Dict[str, int]:
        return self.stats.setdefault(size, {"gets": 0, "puts": 0, "fresh": 0, "trimmed": 0})

    def get(self, size: int) -> int:
        b = _round_up_pow2(max(size, 1), self.min_block)
        self._stat(b)["gets"] += 1
        free = self._free.get(b)
        if free:
            token = free.pop()
            self.idle_bytes -= b
            if self.zero_on_get:
                self._bufs[token][:] = 0
            return token
        token = self._next
        self._next += 1
        self._bufs[token] = np.zeros(b, dtype=np.uint8)
        self._sizes[token] = b
        self.total_bytes += b
        self._stat(b)["fresh"] += 1
        return token

    def put(self, token: int) -> None:
        b = self._sizes[token]
        self._free.setdefault(b, []).append(token)
        self._seq[token] = time.monotonic()
        self.idle_bytes += b
        self._stat(b)["puts"] += 1
        if self.idle_bytes > self.max_alloc * 9 // 10:
            self.trim(self.max_alloc * 65 // 100)

    def preallocate(self, size: int, count: int) -> None:
        b = _round_up_pow2(max(size, 1), self.min_block)
        for _ in range(count):
            token = self._next
            self._next += 1
            self._bufs[token] = np.zeros(b, dtype=np.uint8)
            self._sizes[token] = b
            self._carved.add(token)
            self._free.setdefault(b, []).append(token)
            self._seq[token] = time.monotonic()
            self.total_bytes += b
            self.idle_bytes += b

    def trim(self, target_idle: int) -> None:
        idle = sorted(
            (t for free in self._free.values() for t in free if t not in self._carved),
            key=lambda t: self._seq.get(t, 0.0),
        )
        for token in idle:
            if self.idle_bytes <= target_idle:
                break
            b = self._sizes[token]
            self._free[b].remove(token)
            del self._bufs[token]
            del self._sizes[token]
            self.idle_bytes -= b
            self.total_bytes -= b
            self._stat(b)["trimmed"] += 1

    def view(self, token: int) -> np.ndarray:
        return self._bufs[token]

    def size(self, token: int) -> int:
        return self._sizes[token]

    def stats_dict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "idle_bytes": self.idle_bytes,
            "bins": [dict(size=s, **st) for s, st in sorted(self.stats.items())],
        }

    def destroy(self) -> None:
        self._bufs.clear()
        self._free.clear()


class BufferPool:
    """Public pool API; picks the C++ arena when available."""

    def __init__(self, conf: Optional[TpuShuffleConf] = None, zero_on_get: bool = False):
        conf = conf or TpuShuffleConf()
        self.min_block = _round_up_pow2(conf.min_block_size, 256)
        self._use_native = bool(conf.use_cpp_runtime and native.available())
        self._lock = threading.Lock()
        self._stopped = False
        # leased-bytes gauge: what's checked out right now (bin sizes).
        # The write dataplane's run buffers and the read side's vectored
        # leases both show up here, so "who is holding the pool" is one
        # property read instead of a guess.
        self._leased_bytes = 0
        self._peak_leased_bytes = 0
        # per-tenant lease ledger (shuffle/tenancy.py): quota 0 =
        # unbounded, so single-tenant deployments pay one dict update
        from sparkrdma_tpu_torch.shuffle.tenancy import TenantLedger
        self._tenant_leases = TenantLedger("pool", conf.tenant_pool_quota)
        if self._use_native:
            self._h = native.LIB.arena_create(
                conf.max_buffer_allocation_size, self.min_block, int(zero_on_get))
        else:
            self._py = _PyArena(conf.max_buffer_allocation_size, self.min_block, zero_on_get)
        for size, count in conf.prealloc_spec().items():
            self.preallocate(size, count)

    @property
    def is_native(self) -> bool:
        return self._use_native

    def get(self, size: int, tenant: int = 0) -> PoolBuffer:
        # Quota check BEFORE the arena allocation: a tenant over its
        # lease quota raises TenantQuotaError without consuming arena
        # memory (bin-size accounting, same as the leased gauge) — the
        # caller sheds that tenant's work instead of OOMing the pool
        # every co-hosted tenant shares. The charge is conservative
        # (requested size rounded to the bin) and re-trued below.
        bin_est = _round_up_pow2(max(size, 1), self.min_block)
        # analysis: leak-ok(the lease transfers to the PoolBuffer on success; _release repays at free)
        self._tenant_leases.charge(tenant, bin_est)
        try:
            return self._get_charged(size, tenant, bin_est)
        except BaseException:
            self._tenant_leases.release(tenant, bin_est)
            raise

    def _get_charged(self, size: int, tenant: int, bin_est: int) -> PoolBuffer:
        # self._lock guards handle lifetime against concurrent stop(); the
        # arena's own mutex guards its internal state.
        with self._lock:
            if self._stopped:
                raise RuntimeError("pool is stopped")
            if self._use_native:
                token = native.LIB.arena_get(self._h, max(size, 1))
                if token < 0:
                    raise MemoryError(f"arena allocation of {size} bytes failed")
                bin_size = native.LIB.arena_buf_size(self._h, token)
                ptr = native.LIB.arena_buf_ptr(self._h, token)
                raw = (ctypes.c_uint8 * bin_size).from_address(ptr)
                view = np.frombuffer(raw, dtype=np.uint8)
            else:
                token = self._py.get(size)
                bin_size = self._py.size(token)
                view = self._py.view(token)
            self._leased_bytes += int(bin_size)
            self._peak_leased_bytes = max(self._peak_leased_bytes,
                                          self._leased_bytes)
        if int(bin_size) != bin_est:  # defensive: arenas bin identically
            self._tenant_leases.release(tenant, bin_est)
            # analysis: leak-ok(re-true of the estimate; the corrected lease transfers to the PoolBuffer below)
            self._tenant_leases.charge(tenant, int(bin_size))
        return PoolBuffer(int(token), int(bin_size), view, self, tenant)

    def get_registered(self, size: int, tenant: int = 0) -> RegisteredBuffer:
        return RegisteredBuffer(self, size, tenant=tenant)

    def _release(self, buf: PoolBuffer) -> None:
        with self._lock:
            if self._stopped:
                return  # late frees after stop() are inert (views dangle)
            if self._use_native:
                rc = native.LIB.arena_put(self._h, buf.token)
                if rc != 0:
                    raise RuntimeError(f"arena_put({buf.token}) failed: {rc}")
            else:
                self._py.put(buf.token)
            self._leased_bytes -= buf.size
        self._tenant_leases.release(buf.tenant, buf.size)

    def tenant_leased_bytes(self, tenant: int) -> int:
        """Bytes currently checked out by one tenant (bin sizes)."""
        return self._tenant_leases.usage(tenant)

    def preallocate(self, size: int, count: int) -> None:
        with self._lock:
            if self._stopped:
                raise RuntimeError("pool is stopped")
            if self._use_native:
                rc = native.LIB.arena_preallocate(self._h, size, count)
                if rc != 0:
                    raise MemoryError("preallocation failed")
            else:
                self._py.preallocate(size, count)

    def trim(self, target_idle: int = 0) -> None:
        with self._lock:
            if self._stopped:
                return
            if self._use_native:
                native.LIB.arena_trim(self._h, target_idle)
            else:
                self._py.trim(target_idle)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            if self._stopped:
                return 0
            if self._use_native:
                return native.LIB.arena_total_bytes(self._h)
            return self._py.total_bytes

    @property
    def leased_bytes(self) -> int:
        """Bytes currently checked out (bin-size accounting)."""
        with self._lock:
            return self._leased_bytes

    @property
    def peak_leased_bytes(self) -> int:
        """High-water mark of :attr:`leased_bytes` over the pool's life."""
        with self._lock:
            return self._peak_leased_bytes

    @property
    def idle_bytes(self) -> int:
        with self._lock:
            if self._stopped:
                return 0
            if self._use_native:
                return native.LIB.arena_idle_bytes(self._h)
            return self._py.idle_bytes

    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        out = self._backend_stats_locked()
        if out:
            out["leased_bytes"] = self._leased_bytes
            out["peak_leased_bytes"] = self._peak_leased_bytes
            tenants = self._tenant_leases.snapshot()
            if tenants:
                out["tenant_leased_bytes"] = tenants
        return out

    def _backend_stats_locked(self) -> dict:
        if self._stopped:
            return {}
        if self._use_native:
            cap = 1 << 16
            out = ctypes.create_string_buffer(cap)
            n = native.LIB.arena_stats_json(self._h, out, cap)
            if n >= cap:
                out = ctypes.create_string_buffer(n + 1)
                native.LIB.arena_stats_json(self._h, out, n + 1)
            import json
            return json.loads(out.value.decode())
        return self._py.stats_dict()

    def stop(self) -> dict:
        """Stats snapshot + teardown (RdmaBufferManager.java:217-231).

        Frees of still-outstanding leases after stop are inert no-ops; their
        views must not be touched (the backing memory is gone on the native
        path).
        """
        with self._lock:
            if self._stopped:
                return {}
            snapshot = self._stats_locked()
            self._stopped = True
            if self._use_native:
                if self._h is not None:
                    native.LIB.arena_destroy(self._h)
                    self._h = None
                self._use_native = False
            else:
                self._py.destroy()
        return snapshot
