"""The link-cost-aware partition layout of the hierarchical reduce.

A partial copy of ``sparkrdma_tpu/shuffle/planner.py`` holding only
``slice_aligned_partition_map`` (``planner.py:264-320``) and the balance
cap it reads, ``ReducePlanner.BALANCE_FACTOR`` (``planner.py:331``), as
the module constant ``BALANCE_FACTOR``. The full copy of the host plane
replaces it.
"""

from __future__ import annotations

import numpy as np

# locality may not load one slice past this multiple of the even share
BALANCE_FACTOR = 1.5


def slice_aligned_partition_map(part_bytes_by_slice, topology,
                                num_devices: int) -> np.ndarray:
    """The link-cost-aware partition->device layout (``i32[P]``): each
    partition lands in the slice that PRODUCED most of its bytes, so the
    bytes that must cross the slow link are minimized by construction —
    the hierarchical reduce's replacement for the flat ``p % D``
    placement (which interleaves partitions across slices and makes
    ~``1 - sum((|s|/D)^2)`` of every stage's bytes cross-slice no matter
    where they were produced).

    ``part_bytes_by_slice: i64[S, P]`` is the per-slice byte histogram
    (summed by the producing executor's home slice). Greedy,
    deterministic, balanced: partitions place byte-descending into their
    best-producing slice (ties: lower slice) unless that slice's assigned
    bytes already exceed ``BALANCE_FACTOR`` x its devices-proportional
    share — then the least-normalized-loaded slice; within a slice, the
    least-loaded device (ties: fewest partitions, lower id). A flat
    topology reproduces ``p % D`` bit-for-bit."""
    hist = np.asarray(part_bytes_by_slice, dtype=np.int64)
    num_parts = hist.shape[1] if hist.ndim == 2 else 0
    if (topology is None or topology.is_flat or num_devices <= 0
            or hist.ndim != 2):
        return (np.arange(max(0, num_parts), dtype=np.int32)
                % max(1, num_devices))
    n_slices = hist.shape[0]
    totals = hist.sum(axis=0)
    total = int(totals.sum())
    share = np.array([topology.slice_sizes[s] / max(1, num_devices)
                      for s in range(n_slices)])
    cap = BALANCE_FACTOR * total * share
    slice_load = np.zeros(n_slices, dtype=np.int64)
    dev_lo = [topology.slice_bounds(s)[0] for s in range(n_slices)]
    dev_hi = [topology.slice_bounds(s)[1] for s in range(n_slices)]
    dev_load = np.zeros(num_devices, dtype=np.int64)
    dev_count = np.zeros(num_devices, dtype=np.int64)
    out = np.zeros(num_parts, dtype=np.int32)
    order = sorted(range(num_parts), key=lambda p: (-int(totals[p]), p))
    for p in order:
        best = max(range(n_slices),
                   key=lambda s: (int(hist[s, p]), -int(slice_load[s]), -s))
        if total and slice_load[best] >= cap[best]:
            # the producing slice already carries its fair share: spill
            # to the least-normalized-loaded slice
            best = min(range(n_slices),
                       key=lambda s: (slice_load[s] / max(share[s], 1e-9),
                                      s))
        devs = range(dev_lo[best], dev_hi[best])
        d = min(devs, key=lambda i: (int(dev_load[i]), int(dev_count[i]),
                                     i))
        out[p] = d
        slice_load[best] += int(totals[p])
        dev_load[d] += int(totals[p])
        dev_count[d] += 1
    return out
