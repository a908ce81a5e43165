"""Two-level topology: slices joined by a slow link, shards inside a slice
joined by a fast one.

A copy of ``sparkrdma_tpu/parallel/topology.py`` for the port's virtual
mesh. A multi-slice job groups its devices into slices: inside a slice
the fused exchange rides the fast fabric (ICI on a TPU pod, NVLink
between the cards of one host), between slices only a slower link (DCN,
the network between hosts). The cost model
(``parallel.device_plane.select_dataplane``) reads the grouping to
factor a redistribution into intra- and inter-slice moves, and the
hierarchical driver (``run_hierarchical_exchange``) runs them.

* :class:`Topology`: contiguous slice sizes along the exchange axis plus
  per-link bandwidth coefficients (``ici_gbps`` / ``dcn_gbps``, seeded
  from a conf and refinable from a probe with :meth:`Topology.refine`).
  One slice is the degenerate topology: ``is_flat`` is True and every
  consumer reproduces the flat behaviour bit for bit.
* :func:`detect_topology`: the grouping of a mesh. Every shard of a
  ``VirtualMesh`` lives on one card, so it is one flat slice unless the
  ``slice_topology`` conf key slices it virtually.
* :func:`slice_mesh`: the sub-mesh over one slice's shards (memoized).
* ``CROSS_SLICE`` / :func:`record_cross_slice`: the host-side tally of
  bytes that crossed a slice boundary, plus the ``cross_slice_shim`` hook
  a bench installs to charge a modelled cost per residue byte.

Executor slots get the same treatment (:func:`topology_for_slots`,
:meth:`Topology.slice_of_slot`). A conf is any object, read with
``getattr`` (``slice_topology``, ``ici_gbps``, ``dcn_gbps``).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

# Host-side tally of bytes moved ACROSS a slice boundary (the residue the
# hierarchical exchange hands the host). The hierarchical plan's point is
# keeping this below the flat plan's cross-slice traffic.
CROSS_SLICE = {"moves": 0, "bytes": 0}
_CROSS_SLICE_LOCK = threading.Lock()

# Bench hook: a callable charged ``(nbytes)`` at every cross-slice move,
# a no-op until installed (e.g. a sleep modelling the slow link's cost
# per byte, so a single-host run prices the two plans honestly).
cross_slice_shim = None


def record_cross_slice(nbytes: int) -> None:
    """Tally one host-side cross-slice move of ``nbytes`` bytes and
    charge the installed shim (if any)."""
    with _CROSS_SLICE_LOCK:
        CROSS_SLICE["moves"] += 1
        CROSS_SLICE["bytes"] += int(nbytes)
    shim = cross_slice_shim
    if shim is not None:
        shim(int(nbytes))


def cross_slice_snapshot() -> Dict[str, int]:
    with _CROSS_SLICE_LOCK:
        return dict(CROSS_SLICE)


@dataclass(frozen=True)
class Topology:
    """Two-level description of the exchange fabric.

    ``slice_sizes[s]`` is the number of contiguous shards (along the
    exchange axis, in mesh order) slice ``s`` owns; shards inside a slice
    share the fast link, slices the slow one. ``ici_gbps`` / ``dcn_gbps``
    are the per-link bandwidth coefficients in GB/s: seeds that need only
    be relatively right for the cost model to rank plans, refinable from
    a probe (:meth:`refine`)."""

    slice_sizes: Tuple[int, ...]
    ici_gbps: float = 100.0
    dcn_gbps: float = 10.0

    @property
    def num_slices(self) -> int:
        return len(self.slice_sizes)

    @property
    def num_devices(self) -> int:
        return sum(self.slice_sizes)

    @property
    def is_flat(self) -> bool:
        """True for the degenerate single-slice (or empty) topology: one
        fast domain, no seam; consumers reproduce the flat behaviour bit
        for bit."""
        return self.num_slices <= 1

    def slice_of(self, device_pos: int) -> int:
        """The slice owning axis position ``device_pos``."""
        lo = 0
        for s, size in enumerate(self.slice_sizes):
            lo += size
            if device_pos < lo:
                return s
        raise IndexError(f"device position {device_pos} outside the "
                         f"{self.num_devices}-device topology")

    def device_slices(self) -> np.ndarray:
        """``i32[num_devices]``: slice id per axis position (the
        vectorized ``slice_of``, which the hierarchical driver indexes row
        destinations through)."""
        return np.repeat(np.arange(self.num_slices, dtype=np.int32),
                         self.slice_sizes)

    def slice_bounds(self, s: int) -> Tuple[int, int]:
        """``[lo, hi)`` axis positions of slice ``s``."""
        lo = sum(self.slice_sizes[:s])
        return lo, lo + self.slice_sizes[s]

    def slice_of_slot(self, slot: int, num_slots: int) -> int:
        """The home slice of executor slot ``slot`` out of ``num_slots``:
        contiguous slot ranges map onto slices proportionally, so
        co-hosted executors and their slice's devices agree on a home."""
        if num_slots <= 0:
            return 0
        slot = max(0, min(int(slot), num_slots - 1))
        return self.slice_of(min(self.num_devices - 1,
                                 slot * self.num_devices // num_slots))

    def link_seconds(self, intra_bytes: int, inter_bytes: int) -> float:
        """The two-level cost ``intra/ici_bw + inter/dcn_bw`` in seconds
        at the configured coefficients: the score ``select_dataplane``
        ranks candidate plans by."""
        gb = 1 << 30
        return (max(0, intra_bytes) / (self.ici_gbps * gb)
                + max(0, inter_bytes) / (self.dcn_gbps * gb))

    def uniform_inter_fraction(self) -> float:
        """Expected cross-slice traffic fraction when sources and
        destinations are uniform over devices: ``1 - sum((|s|/D)^2)``,
        the cost model's estimate when a stage carries no per-link byte
        decomposition."""
        d = self.num_devices
        if d == 0:
            return 0.0
        return 1.0 - sum((sz / d) ** 2 for sz in self.slice_sizes)

    def refine(self, ici_gbps: Optional[float] = None,
               dcn_gbps: Optional[float] = None) -> "Topology":
        """A copy with probe-measured link coefficients."""
        return replace(self,
                       ici_gbps=self.ici_gbps if ici_gbps is None
                       else float(ici_gbps),
                       dcn_gbps=self.dcn_gbps if dcn_gbps is None
                       else float(dcn_gbps))

    def describe(self) -> dict:
        """Provenance record for bench output."""
        return {"slices": self.num_slices,
                "devices_per_slice": list(self.slice_sizes),
                "ici_gbps": self.ici_gbps, "dcn_gbps": self.dcn_gbps}


def _parse_slice_spec(spec: str, num_devices: int
                      ) -> Optional[Tuple[int, ...]]:
    """Parse the ``slice_topology`` conf value: ``""`` = auto (None),
    ``"N"`` = N equal contiguous slices, ``"a,b,c"`` = explicit sizes
    (must sum to the device count). Invalid specs return None (auto):
    conf values fall back to their default, never raise."""
    spec = (spec or "").strip()
    if not spec:
        return None
    try:
        parts = [int(p) for p in spec.split(",") if p.strip()]
    except ValueError:
        return None
    if not parts or any(p <= 0 for p in parts):
        return None
    if len(parts) == 1:
        n = parts[0]
        if n < 1 or num_devices % n != 0:
            return None
        return tuple([num_devices // n] * n)
    return tuple(parts) if sum(parts) == num_devices else None


def _auto_slice_sizes(devices) -> Tuple[int, ...]:
    """Group axis-ordered devices into contiguous runs by physical slice:
    a device's ``slice_index``, else its ``process_index``. Devices with
    neither (the shards of one card, a ``torch.device``) collapse to one
    slice, the degenerate case."""
    sizes = []
    prev = object()
    for d in devices:
        marker = getattr(d, "slice_index", None)
        if marker is None:
            marker = getattr(d, "process_index", 0)
        if marker != prev:
            sizes.append(0)
            prev = marker
        sizes[-1] += 1
    return tuple(sizes) if sizes else (0,)


def _conf_topology(conf, num_units: int, devices=None) -> Topology:
    """THE conf -> Topology construction every detector shares: parse the
    ``slice_topology`` spec against ``num_units``, fall back to the
    device-marker grouping (when ``devices`` given) or one flat slice, and
    seed the link coefficients."""
    spec = str(getattr(conf, "slice_topology", "") or "")
    sizes = _parse_slice_spec(spec, num_units)
    if sizes is None:
        if devices:
            sizes = _auto_slice_sizes(devices)
        else:
            sizes = (num_units,) if num_units else (0,)
    return Topology(sizes).refine(
        ici_gbps=getattr(conf, "ici_gbps", None),
        dcn_gbps=getattr(conf, "dcn_gbps", None))


def detect_topology(mesh: Optional[VirtualMesh], conf=None) -> Topology:
    """The mesh's two-level topology: the ``slice_topology`` conf key when
    set (virtual slicing), else the grouping of the shards' devices. A
    ``VirtualMesh`` keeps every shard on one card, so that is one flat
    slice. No mesh: the empty degenerate topology."""
    devices = [mesh.device] * mesh.num_shards if mesh is not None else []
    return _conf_topology(conf, len(devices), devices or None)


def host_topology(conf=None) -> Topology:
    """The topology of every CUDA device this process can see (no mesh
    needed), for bench provenance; the empty degenerate topology when
    there is none."""
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    return _conf_topology(conf, len(devices), devices or None)


def topology_for_slots(conf, num_slots: int) -> Topology:
    """The executor-slot view of the topology: ``slice_topology``
    partitions the ``num_slots`` contiguous slots the same way it
    partitions devices; auto (no spec) is flat."""
    return _conf_topology(conf, num_slots)


@functools.lru_cache(maxsize=64)
def _slice_mesh_cached(mesh: VirtualMesh, lo: int, hi: int) -> VirtualMesh:
    return VirtualMesh(hi - lo, mesh.device)


def slice_mesh(mesh: VirtualMesh, topology: Topology, s: int
               ) -> VirtualMesh:
    """The sub-mesh over slice ``s``'s contiguous shards, what the
    intra-slice fused step runs over: ``VirtualMesh(hi - lo)`` on the
    mesh's device, to which the driver hands shards ``lo:hi`` of the
    stage. Memoized per (mesh, bounds), so callers share one object."""
    lo, hi = topology.slice_bounds(s)
    return _slice_mesh_cached(mesh, lo, hi)
