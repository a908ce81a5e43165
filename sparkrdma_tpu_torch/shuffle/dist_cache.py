"""Worker-process cache of shuffle bytes: mesh-reduce results and
warm iterative reuse.

Two stores, one byte budget:

* **Mesh-reduce results** (the original role): in distributed mesh mode
  each executor PROCESS enters one global-mesh collective per parent
  shuffle (`engine._dist_mesh_reduce` ships the collective closure;
  `parallel/multihost.py` is the data plane). The rows a process
  receives are ITS partitions — kept here until the shuffle is
  invalidated or unregistered; the worker-side task context serves
  reduce reads from here (falling back to the TCP fetcher for
  partitions another process owns).

* **Warm read ranges** (cross-stage shuffle-output reuse,
  ``warm_read_cache``): a reducer's materialized partition range, keyed
  by the location EPOCH it was read under (shuffle/location_plane.py).
  Iteration N+1 over an unchanged shuffle serves the bytes locally —
  zero RPCs, zero bytes moved — exactly the resident-redistribution-
  state idea of "Memory-efficient array redistribution" (PAPERS.md).
  An epoch bump (re-execution, executor loss) makes every stale entry
  unservable; ``on_epoch`` evicts them eagerly when the push arrives.

Memory is BOUNDED: entries are accounted by payload bytes and whole
shuffles evict least-recently-used once the budget (``configure``, conf
``dist_cache_budget``) is exceeded — a long iterative job reusing
hundreds of shuffles trades cache misses, never an OOM. ``evicted``
counts budget evictions (surfaced via ``stats()``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

_lock = threading.Lock()
# shuffle_id -> partition -> (keys u64[N], payload u8[N, W])   (mesh)
_cache: "OrderedDict[int, Dict[int, Tuple[np.ndarray, np.ndarray]]]" = \
    OrderedDict()
# shuffle_id -> (start, end, map_lo, map_hi) -> (epoch, keys, payload)
# (warm; (map_lo, map_hi) = (-1, -1) for a full-map-range read, so
# pre-planner callers and adaptive split tasks never alias one key)
_ranges: "OrderedDict[int, Dict[Tuple[int, int, int, int], Tuple[int, np.ndarray, np.ndarray]]]" = OrderedDict()
# adaptive reduce planning: the last plan epoch OBSERVED per shuffle —
# a changed plan re-carves the reduce ranges, so warm entries cached
# under the old plan must not serve (on_plan_epoch drops them)
_plan_epochs: Dict[int, int] = {}
plan_invalidations = 0  # warm-range drops caused by plan-epoch changes
# byte accounting per shuffle per store (LRU evicts whole shuffles: the
# unit invalidation works at, so eviction can never leave a half-valid
# shuffle behind)
_bytes: Dict[Tuple[str, int], int] = {}
_budget = 256 << 20
evicted = 0  # budget evictions (NOT invalidations/drops), monotone
# tenancy (shuffle/tenancy.py): shuffle -> owning tenant. Evictions are
# charged to the INSERTING tenant — a cold bulk job filling the cache
# can evict its own LRU shuffles but never another tenant's warm
# iterative ranges. Each tenant is bounded by _tenant_quota (conf
# tenant_cache_quota), or an even share of the budget across tenants
# currently holding bytes; with one tenant (every pre-tenancy caller:
# everything maps to DEFAULT_TENANT) the share IS the budget, so
# single-job behavior is unchanged bit-for-bit.
_tenants: Dict[int, int] = {}
_tenant_quota = 0
cross_tenant_evictions = 0  # must stay 0: regression-tested invariant


def configure(budget_bytes: int, tenant_quota: int = 0) -> None:
    """Set the byte budget (conf ``dist_cache_budget``; 0 disables both
    stores) and the per-tenant cap (conf ``tenant_cache_quota``; 0 =
    even share). Shrinking evicts immediately (admin action: global
    LRU, not charged to any tenant)."""
    global _budget, _tenant_quota
    with _lock:
        _budget = max(0, int(budget_bytes))
        _tenant_quota = max(0, int(tenant_quota))
        _evict_to_budget_locked()


def set_tenant(shuffle_id: int, tenant: int) -> None:
    """Record the shuffle's owning tenant (manager/endpoint teach this
    at registration and on the TenantMapMsg push)."""
    with _lock:
        _tenants[shuffle_id] = int(tenant)


def _tenant_of_locked(shuffle_id: int) -> int:
    return _tenants.get(shuffle_id, 0)


def _active_tenants_locked(including: int) -> int:
    """Distinct tenants holding cached bytes (plus the inserter)."""
    active = {_tenant_of_locked(sid) for _, sid in _bytes}
    active.add(including)
    return len(active)


def _tenant_bytes_locked(tenant: int) -> int:
    return sum(n for (_, sid), n in _bytes.items()
               if _tenant_of_locked(sid) == tenant)


def _tenant_cap_locked(tenant: int) -> int:
    if _tenant_quota:
        return min(_budget, _tenant_quota)
    return _budget // max(1, _active_tenants_locked(tenant))


def _nbytes(*arrays: np.ndarray) -> int:
    return sum(int(a.nbytes) for a in arrays)


def _total_locked() -> int:
    return sum(_bytes.values())


def _evict_to_budget_locked(need: int = 0) -> None:
    """Admin-path eviction (configure shrink): global LRU, any owner."""
    _evict_for_locked(need, None)


def _evict_for_locked(need: int, tenant: Optional[int]) -> bool:
    """Make room for ``need`` more bytes charged to ``tenant``: drop
    least-recently-used shuffles (across both stores, oldest touch
    first) until the need fits BOTH the global budget and the tenant's
    cap. Victims are restricted to the charging tenant (``None`` = any
    owner, the admin/configure path) — eviction is charged to the
    inserter, so one tenant's cold bulk insert can never wipe another
    tenant's warm ranges. Returns False when the need cannot fit (the
    caller rejects the insert; correctness-wise a rejected cache insert
    just costs a re-fetch)."""
    global evicted, cross_tenant_evictions

    def over() -> bool:
        if _total_locked() + need > _budget:
            return True
        return (tenant is not None
                and _tenant_bytes_locked(tenant) + need
                > _tenant_cap_locked(tenant))

    while over():
        # the least-recently-touched ELIGIBLE shuffle per store
        candidates: List[Tuple[str, int]] = []
        for kind, stores in (("mesh", _cache), ("warm", _ranges)):
            for sid in stores:
                if tenant is None or _tenant_of_locked(sid) == tenant:
                    candidates.append((kind, sid))
                    break
        if not candidates:
            return not over()
        # OrderedDict iteration order IS recency order (oldest first);
        # with one candidate per store, evict the one carrying bytes —
        # prefer the warm store (re-fetchable for the price of RPCs)
        # over mesh results (re-entering a collective costs the group)
        kind, sid = max(candidates,
                        key=lambda c: (c[0] == "warm", _bytes.get(c, 0)))
        if tenant is not None and _tenant_of_locked(sid) != tenant:
            cross_tenant_evictions += 1  # defense: must be unreachable
        if kind == "mesh":
            _cache.pop(sid, None)
        else:
            _ranges.pop(sid, None)
        _bytes.pop((kind, sid), None)
        evicted += 1
    return True


# -- mesh-reduce results (distributed mesh mode) -------------------------


def store(shuffle_id: int, device_results: List[tuple]) -> List[int]:
    """Split a collective's per-device results by partition and cache.

    ``device_results``: ``[(keys, payload, partition_ids), ...]`` per
    local mesh device (``run_multihost_mesh_reduce``'s return shape).
    Each partition lives on exactly one device (owner = partition %
    mesh size), so segments never merge across devices. Returns the
    sorted partition ids this process now serves.
    """
    by_part: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    total = 0
    for keys, payload, parts in device_results:
        if not len(keys):
            continue
        order = np.argsort(parts, kind="stable")  # stable: key order
        keys, payload, parts = keys[order], payload[order], parts[order]
        starts = np.flatnonzero(np.r_[True, parts[1:] != parts[:-1]])
        bounds = np.r_[starts, len(parts)]
        for i, s in enumerate(starts):
            seg = slice(int(s), int(bounds[i + 1]))
            k, p = keys[seg].copy(), payload[seg].copy()
            by_part[int(parts[s])] = (k, p)
            total += _nbytes(k, p)
    with _lock:
        tenant = _tenant_of_locked(shuffle_id)
        if total > min(_budget, _tenant_cap_locked(tenant)):
            # a single oversized shuffle can never fit: don't thrash the
            # whole cache out for it (callers fall back to the fetcher)
            _cache.pop(shuffle_id, None)
            _bytes.pop(("mesh", shuffle_id), None)
            return sorted(by_part)
        if not _evict_for_locked(
                total - _bytes.get(("mesh", shuffle_id), 0), tenant):
            # other tenants hold the budget and this tenant has nothing
            # left to evict: reject the insert (callers re-fetch) rather
            # than wipe a sibling tenant's cache
            _cache.pop(shuffle_id, None)
            _bytes.pop(("mesh", shuffle_id), None)
            return sorted(by_part)
        _cache[shuffle_id] = by_part
        _cache.move_to_end(shuffle_id)
        _bytes[("mesh", shuffle_id)] = total
    return sorted(by_part)


def get(shuffle_id: int, partition: int
        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """This process's rows for ``partition``, or None if it does not
    hold that partition (or the shuffle was never reduced here)."""
    with _lock:
        parts = _cache.get(shuffle_id)
        if parts is None:
            return None
        _cache.move_to_end(shuffle_id)
        return parts.get(partition)


def has_shuffle(shuffle_id: int) -> bool:
    with _lock:
        return shuffle_id in _cache


# -- warm read ranges (cross-stage shuffle-output reuse) -----------------


def _range_key(start: int, end: int,
               map_range: Optional[Tuple[int, int]]) -> Tuple[int, int, int, int]:
    lo, hi = map_range if map_range is not None else (-1, -1)
    return (start, end, lo, hi)


def put_range(shuffle_id: int, epoch: int, start: int, end: int,
              keys: np.ndarray, payload: np.ndarray,
              map_range: Optional[Tuple[int, int]] = None) -> bool:
    """Cache one reducer's materialized partition range under the
    location epoch it was read at. ``map_range`` keys a plan-split
    task's map slice (None = the full map space). Returns False when it
    didn't fit."""
    total = _nbytes(keys, payload)
    key = _range_key(start, end, map_range)
    with _lock:
        tenant = _tenant_of_locked(shuffle_id)
        if total > min(_budget, _tenant_cap_locked(tenant)):
            return False
        # detach this shuffle's store first so eviction can't race the
        # update (re-admitted whole below, newest-touched)
        ranges = _ranges.pop(shuffle_id, {})
        orig_prev = _bytes.pop(("warm", shuffle_id), 0)
        prev = orig_prev
        old = ranges.get(key)
        if old is not None:
            prev -= _nbytes(old[1], old[2])
        need = max(0, prev) + total
        if not _evict_for_locked(need, tenant):
            # can't fit without evicting another tenant: restore the
            # detached entries untouched and decline the insert
            if ranges:
                _ranges[shuffle_id] = ranges
                _bytes[("warm", shuffle_id)] = orig_prev
            return False
        ranges[key] = (epoch, keys, payload)
        _ranges[shuffle_id] = ranges
        _bytes[("warm", shuffle_id)] = need
        return True


def get_range(shuffle_id: int, epoch: int, start: int, end: int,
              map_range: Optional[Tuple[int, int]] = None
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The cached (keys, payload) for [start, end) iff stored under
    EXACTLY ``epoch`` — an entry from any other version is dropped on
    sight (a stale location state must never serve bytes)."""
    key = _range_key(start, end, map_range)
    with _lock:
        ranges = _ranges.get(shuffle_id)
        if ranges is None:
            return None
        entry = ranges.get(key)
        if entry is None:
            return None
        stored_epoch, keys, payload = entry
        # analysis: epoch-eq-ok(warm reuse demands exactly the requested epoch; any other vintage is dead bytes)
        if stored_epoch != epoch:
            del ranges[key]
            _bytes[("warm", shuffle_id)] = max(
                0, _bytes.get(("warm", shuffle_id), 0)
                - _nbytes(keys, payload))
            if not ranges:
                _ranges.pop(shuffle_id, None)
                _bytes.pop(("warm", shuffle_id), None)
            return None
        _ranges.move_to_end(shuffle_id)
        return keys, payload


def on_plan_epoch(shuffle_id: int, plan_epoch: int) -> None:
    """A pushed reduce-plan change (shuffle/planner.py): a re-plan (or
    first plan after warm entries were cached plan-less) re-carves the
    reduce ranges, so every warm range of the shuffle cached under a
    DIFFERENT plan epoch is dropped — a re-plan must never serve a
    stale coalesced range. First observation records without dropping
    (nothing was cached under another plan)."""
    global plan_invalidations
    with _lock:
        prev = _plan_epochs.get(shuffle_id)
        _plan_epochs[shuffle_id] = plan_epoch
        # analysis: epoch-eq-ok(idempotent re-delivery check; equality means the same plan, nothing to invalidate)
        if prev is None or prev == plan_epoch:
            return
        ranges = _ranges.pop(shuffle_id, None)
        _bytes.pop(("warm", shuffle_id), None)
        if ranges:
            plan_invalidations += 1


def on_epoch(shuffle_id: int, epoch: int) -> None:
    """A pushed epoch bump: evict entries the new version obsoletes
    (``get_range`` would drop them lazily anyway; eager eviction frees
    the bytes now). A terminal bump (epoch < 0) drops the shuffle from
    BOTH stores — mesh results predate the bump by construction."""
    with _lock:
        if epoch < 0:
            _drop_locked(shuffle_id)
            # terminal: the shuffle id will never cache again under
            # this registration; forget its tenant (re-register
            # re-teaches the mapping)
            _tenants.pop(shuffle_id, None)
            return
        ranges = _ranges.get(shuffle_id)
        if not ranges:
            return
        # analysis: epoch-eq-ok(warm reuse demands exactly the current epoch; every other vintage is stale)
        stale = [k for k, (e, _k, _p) in ranges.items() if e != epoch]
        freed = 0
        for k in stale:
            _e, keys, payload = ranges.pop(k)
            freed += _nbytes(keys, payload)
        if freed:
            _bytes[("warm", shuffle_id)] = max(
                0, _bytes.get(("warm", shuffle_id), 0) - freed)
        if not ranges:
            _ranges.pop(shuffle_id, None)
            _bytes.pop(("warm", shuffle_id), None)


# -- lifecycle -----------------------------------------------------------


def _drop_locked(shuffle_id: int) -> None:
    _cache.pop(shuffle_id, None)
    _ranges.pop(shuffle_id, None)
    _bytes.pop(("mesh", shuffle_id), None)
    _bytes.pop(("warm", shuffle_id), None)
    _plan_epochs.pop(shuffle_id, None)


def drop(shuffle_id: int) -> None:
    """Invalidate on recovery/unregister: stale collective results and
    warm ranges must not serve after a map recomputes."""
    with _lock:
        _drop_locked(shuffle_id)


def stats() -> dict:
    with _lock:
        return {
            "budget": _budget,
            "bytes": _total_locked(),
            "mesh_shuffles": len(_cache),
            "warm_shuffles": len(_ranges),
            "evicted": evicted,
            "plan_invalidations": plan_invalidations,
            "cross_tenant_evictions": cross_tenant_evictions,
            "tenant_bytes": {
                t: _tenant_bytes_locked(t)
                for t in {_tenant_of_locked(sid) for _, sid in _bytes}
            },
        }
