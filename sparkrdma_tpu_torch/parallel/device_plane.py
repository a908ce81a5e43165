"""The exchange dataplane: one interface, two planes, a cost model choosing
per stage, the fused device step and its host drivers.

Port of ``sparkrdma_tpu/parallel/device_plane.py`` over the virtual mesh
(``parallel.mesh``): a ``VirtualMesh`` takes the place of ``(mesh,
axis_name)`` and every step runs all D shards at once on ``[D, cap, W]``
int32 rows, keys compared as zero-extended int64 (``utils.u32``).

* ``Exchange`` (``DeviceExchange``, ``HostExchange``) and
  ``select_dataplane``: the per-stage cost model. Device plane when the
  stage is resident and its bytes fit the memory budget's round sizing,
  host plane otherwise; on a multi-slice ``parallel.topology.Topology``
  the two-level link cost may choose the hierarchical plan.
* ``make_fused_step``: partition + exchange + local sort in one step.
  Each layer runs under a span (``utils.trace.span``): ``fused.local_sort``
  (with ``exchange.group`` inside on the ``dest`` partition),
  ``fused.counts``, ``exchange.receive_fill`` (the receive buffer's
  zero fill), the exchange's own (``exchange.transport``, and
  ``exchange.slot_fill``/``exchange.pack`` on the slot transports) and
  ``fused.receive_sort``; every row gather inside is a ``mesh.take_rows``.
  So a ``torch.profiler`` trace splits the step's device time by layer,
  and with no profiler running the spans cost a flag check.
* ``run_fused_exchange(_rounds)``: the host driver, bounded rounds sized
  from the memory budget (``auto_rows_per_round``), DOUBLE-BUFFERED: round
  ``k+1`` is staged and queued while round ``k``'s step runs on the card
  and its results drain. Each round is one ``exchange.round`` span with
  ``exchange.stage`` inside, each collection one ``exchange.collect``,
  the tournament merge one ``exchange.merge``, each overlapped pair one
  ``exchange.overlap`` instant. A span reaches the driver's tracer and,
  while one records, the torch profiler.
* ``run_hierarchical_exchange``: the two-level driver, per-slice fused
  steps over slice sub-meshes plus the slice-crossing residue charged
  through ``topology.record_cross_slice``; one slice's overflow degrades
  only that slice's rows to host-side serving.

Overflow (a receive past the ``out_factor`` headroom) raises
``OverflowError`` from the flat drivers; degrading a stage to the host
plane is the engine's remedy, not theirs. The drivers size each round's
ring slots from the round's largest (source, destination) pair, counted
on the host (``_slot_rows``), so a pair never overflows its slot: like the
JAX package's ragged transport on the TPU, only a receiver's capacity
bounds a round.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.partition import uniform_splitters
from sparkrdma_tpu_torch.parallel import topology as topology_mod
from sparkrdma_tpu_torch.parallel.exchange import (
    bucket_quota,
    exchange_over,
    group_by_destination,
    record_exchange,
    resolve_transport,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh, take_rows
from sparkrdma_tpu_torch.shuffle.external import merge_runs
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import SENTINEL, to_bits, to_u64

DEVICE_PLANE = "device"
HOST_PLANE = "host"
HIERARCHICAL_PLANE = "hierarchical"


def stage_to_device(arr: np.ndarray, mesh: VirtualMesh) -> torch.Tensor:
    """One host -> device upload of a ``[D*n, ...]`` array as the mesh's
    ``[D, n, ...]`` shards (u32 words as their int32 bits). On the CPU the
    result aliases ``arr`` (``torch.from_numpy``, as the JAX package's
    ``may_alias`` lets a backend do); on ``cuda`` the bytes go through a
    pinned staging buffer and a ``non_blocking`` copy, which PyTorch's
    pinned-memory allocator keeps from reuse until the copy has run."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    n = mesh.num_shards
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not split over {n} shards")
    host = torch.from_numpy(arr).reshape((n, arr.shape[0] // n)
                                         + arr.shape[1:])
    if mesh.device.type == "cpu":
        return host
    return host.pin_memory().to(mesh.device, non_blocking=True)


# one-time latch for the mesh_rows_per_round deprecation: the knob still
# pins round sizes for mixed-version configs, but auto-sizing from the
# device memory budget is the supported path
_rows_knob_warned = False


def warn_mesh_rows_deprecated(source: str = "mesh_rows_per_round") -> None:
    """Emit the one-per-process deprecation warning for the legacy static
    round-size knob; later calls are silent."""
    global _rows_knob_warned
    if _rows_knob_warned:
        return
    _rows_knob_warned = True
    warnings.warn(
        f"{source} is deprecated: rounds auto-size from device_hbm_budget"
        " (docs/CONFIG.md 'Device exchange'); the pinned value is still"
        " honored for mixed-version configs", DeprecationWarning,
        stacklevel=3)


def _footprint_rows(row_bytes: int, out_factor: int) -> int:
    """Conservative per-shard device footprint of one fused round, in row
    multiples: the input buffer + its destination-grouped copy (2 x cap)
    plus the receive buffer + its sorted copy (2 x out_factor x cap). The
    cost model sizes rounds so this fits the budget."""
    return row_bytes * (2 + 2 * out_factor)


@dataclass(frozen=True)
class StageProfile:
    """What the cost model knows about one stage's exchange.

    ``est_bytes``: committed map-output bytes across the stage.
    ``row_bytes``: the device row stride. ``resident``: whether the
    stage's inputs can be staged straight into this process's device
    memory. ``out_factor``: receive headroom the runner will allocate.
    ``intra_bytes`` / ``inter_bytes`` split ``est_bytes`` by link on a
    multi-slice topology (bytes staying in the producing map's home slice
    vs. bytes crossing the seam); ``-1`` = unknown, and the cost model
    falls back to the topology's uniform-destination estimate."""

    est_bytes: int
    row_bytes: int
    resident: bool = True
    out_factor: int = 2
    intra_bytes: int = -1
    inter_bytes: int = -1


@dataclass(frozen=True)
class ExchangePlan:
    """One stage's dataplane decision: which plane, which transport, and
    (device plane) the auto-sized round bound. ``rows_per_round`` 0 = one
    shot; ``reason`` is the cost model's audit trail. ``topology`` rides
    along on HIERARCHICAL plans (the slice bounds the plan was scored
    against; None on flat plans), whose ``impl`` is the RAW transport ask,
    resolved again per sub-mesh."""

    plane: str
    impl: str = ""
    rows_per_round: int = 0
    reason: str = ""
    topology: Optional[topology_mod.Topology] = None


class Exchange:
    """The one interface both dataplanes implement: ``supports`` answers
    "can this plane carry the stage at all", ``plan`` "how would it run"
    (None = it shouldn't). ``select_dataplane`` composes them."""

    name: str = ""

    def supports(self, mesh: Optional[VirtualMesh],
                 profile: StageProfile) -> Tuple[bool, str]:
        raise NotImplementedError

    def plan(self, mesh: Optional[VirtualMesh], profile: StageProfile, *,
             impl: str = "auto",
             hbm_budget: int = 64 << 20) -> Optional[ExchangePlan]:
        raise NotImplementedError


class DeviceExchange(Exchange):
    """The device collective dataplane (fused partition+exchange+sort)."""

    name = DEVICE_PLANE

    def supports(self, mesh, profile):
        if mesh is None:
            return False, "no mesh configured"
        if not profile.resident:
            return False, "stage inputs not resident to this process"
        return True, ""

    def plan(self, mesh, profile, *, impl="auto", hbm_budget=64 << 20):
        ok, _ = self.supports(mesh, profile)
        if not ok:
            return None
        resolved = resolve_transport(mesh, impl)
        n = mesh.num_shards
        rows_cap = auto_rows_per_round(profile.row_bytes, hbm_budget,
                                       profile.out_factor)
        if rows_cap < 1:
            return None  # budget can't hold even one row per shard
        per_dev_rows = -(-max(0, profile.est_bytes)
                         // max(1, profile.row_bytes) // n) or 1
        if per_dev_rows <= rows_cap:
            return ExchangePlan(
                DEVICE_PLANE, resolved, 0,
                f"fits budget one-shot ({per_dev_rows} rows/dev <= "
                f"{rows_cap} cap)")
        return ExchangePlan(
            DEVICE_PLANE, resolved, rows_cap,
            f"chunked: {per_dev_rows} rows/dev over {rows_cap}-row "
            "budget rounds")


class HostExchange(Exchange):
    """The host dataplane (writer -> resolver -> fetcher): always
    available, the fallback plane."""

    name = HOST_PLANE

    def supports(self, mesh, profile):
        return True, ""

    def plan(self, mesh, profile, *, impl="auto", hbm_budget=64 << 20):
        return ExchangePlan(HOST_PLANE, "", 0, "host dataplane")


def auto_rows_per_round(row_bytes: int, hbm_budget: int,
                        out_factor: int = 2) -> int:
    """Rows per shard per fused round that keep the round's footprint
    (input + grouped copy + receive + sorted copy) inside ``hbm_budget``
    bytes."""
    return max(0, int(hbm_budget) // _footprint_rows(max(1, row_bytes),
                                                     max(1, out_factor)))


_PLANES = (DeviceExchange(), HostExchange())


def select_dataplane(mesh: Optional[VirtualMesh], profile: StageProfile, *,
                     impl: str = "auto", hbm_budget: int = 64 << 20,
                     override: str = "auto",
                     topology: Optional[topology_mod.Topology] = None,
                     ) -> ExchangePlan:
    """The per-stage cost model: device plane when the stage is resident
    and its bytes fit the budget's round sizing, host plane otherwise.
    ``override`` ``"device"`` / ``"host"`` forces a plane; ``"auto"`` asks
    the cost model.

    On a MULTI-slice ``topology`` a stage that would ride the device plane
    one-shot is scored by the two-level link cost: the flat exchange
    prices every byte on the slow link, the hierarchical plan keeps the
    intra-slice bulk on the fast one and pays the slow link only for the
    slice-crossing residue (``intra/ici_bw + inter/dcn_bw``). None or a
    single-slice topology reproduces the flat selector bit for bit."""
    if override not in ("auto", DEVICE_PLANE, HOST_PLANE):
        raise ValueError(f"unknown dataplane override {override!r} "
                         "(expected 'auto', 'device' or 'host')")
    if override == HOST_PLANE:
        return ExchangePlan(HOST_PLANE, "", 0, "forced by override")
    device, host = _PLANES
    if override == DEVICE_PLANE:
        ok, why = device.supports(mesh, profile)
        if not ok:
            # forcing a plane that declared itself unable to carry the
            # stage is a caller error
            raise ValueError(f"dataplane override 'device': {why}")
        dev = device.plan(mesh, profile, impl=impl, hbm_budget=hbm_budget)
        if dev is not None:
            return dev
        # supported but the budget can't hold a row: run minimum rounds
        # rather than silently switching planes under an explicit ask
        return ExchangePlan(DEVICE_PLANE, resolve_transport(mesh, impl), 1,
                            "forced by override (budget below one row)")
    dev = device.plan(mesh, profile, impl=impl, hbm_budget=hbm_budget)
    if dev is None:
        return host.plan(mesh, profile, impl=impl, hbm_budget=hbm_budget)
    if (topology is not None and not topology.is_flat
            and dev.rows_per_round == 0):
        # one-shot plans only: the hierarchical driver stages the whole
        # stage host-side; a chunked plan keeps the flat streamed rounds
        est = max(0, profile.est_bytes)
        intra, inter = profile.intra_bytes, profile.inter_bytes
        if intra < 0 or inter < 0:
            inter = int(est * topology.uniform_inter_fraction())
            intra = est - inter
        hier_s = topology.link_seconds(intra, inter)
        flat_s = topology.link_seconds(0, intra + inter)
        if hier_s < flat_s:
            return ExchangePlan(
                HIERARCHICAL_PLANE, impl, 0,
                f"two-level: {topology.num_slices} slices, "
                f"{intra >> 20}MiB intra@{topology.ici_gbps:g}GB/s + "
                f"{inter >> 20}MiB inter@{topology.dcn_gbps:g}GB/s = "
                f"{hier_s:.4f}s vs flat {flat_s:.4f}s",
                topology=topology)
    return dev


# ---------------------------------------------------------------------------
# the fused step: partition + exchange + local sort
# ---------------------------------------------------------------------------

SORT_MODES = ("gather", "multisort", "colsort")


def _stable_order(keys: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Per-shard permutation that sorts ``keys`` (int64 ``[D, N]``, most
    significant first) with ties in original position order: LSD passes,
    one stable sort per key word, least significant first."""
    order = None
    for k in reversed(keys):
        kk = k if order is None else k.gather(1, order)
        _, idx = torch.sort(kk, dim=1, stable=True)
        order = idx if order is None else order.gather(1, idx)
    return order


def _local_sort(rows: torch.Tensor, keys: Tuple[torch.Tensor, ...],
                sort_mode: str, write_back_keys: bool):
    """One per-shard sort of full rows ``[D, N, W]`` by (pre-masked)
    keys, a tuple of int64 ``[D, N]`` key words, most significant first.
    Returns ``(sorted_rows, sorted_keys)`` with ``sorted_keys`` the most
    significant word.

    The JAX package's three ``sort_mode``s are three ways to make XLA
    carry the payload through a sort: ``gather`` sorts (key, iota) and
    gathers rows once, ``multisort`` and ``colsort`` feed the payload
    columns through the sort network. All three give the same stable
    order (ties by arrival). In PyTorch a stable sort of the keys plus one
    row gather IS that order, so the three modes share this one
    implementation; the names stay for parity with the JAX config.

    ``write_back_keys`` overwrites column 0 with the sorted key
    (single-word layouts only), so padding rows show the sentinel."""
    if sort_mode not in SORT_MODES:
        raise ValueError(f"unknown sort_mode {sort_mode!r} "
                         "(expected 'gather', 'multisort' or 'colsort')")
    order = _stable_order(keys)
    # the row gather before the key gather: a span around this sort then
    # ends on a kernel of its own, so its device range covers the
    # ``mesh.take_rows`` one
    sorted_rows = take_rows(rows, order)
    sorted_keys = keys[0].gather(1, order)
    if write_back_keys:
        sorted_rows[:, :, 0] = to_bits(sorted_keys)
    return sorted_rows, sorted_keys


def _row_keys(rows: torch.Tensor, key_words: int):
    """The per-row sort key words (int64 ``[D, N]``), most significant
    first: column 0 for single-word u32 keys, ``(hi=col 1, lo=col 0)``
    for the little-endian packed u64 layout."""
    if key_words == 1:
        return (to_u64(rows[:, :, 0]),)
    return (to_u64(rows[:, :, 1]), to_u64(rows[:, :, 0]))


def make_fused_step(mesh: VirtualMesh, row_words: int, *,
                    out_factor: int = 2, impl: str = "auto",
                    sort_mode: str = "gather", key_words: int = 1,
                    partition: str = "range") -> Callable:
    """Build the fused partition+exchange+local-sort step over ``mesh``
    (a ``VirtualMesh``, or a ``GlobalMesh``: then ``D`` below is the
    process's ``local_shards``, the counts are ``[Dl, G]``, and only the
    exchange crosses processes).

    ``partition`` selects how rows find their destination shard:

    * ``"range"`` — uniform u32 key-range split (TeraSort): ONE key sort
      doubles as the destination grouping, and per-destination counts
      come from D-1 binary searches. ``step(rows)`` with ``rows:
      int32[D, cap, row_words]``, key = column 0.
    * ``"dest"`` — caller-computed destinations: ``step(rows, dest,
      slot_rows=None)`` with ``dest: int[D, cap]``; ``dest < 0`` marks
      padding rows (not sent); ``slot_rows`` sizes the slot transports'
      per-pair slots (``ragged_exchange_shard``). Rows group by
      destination, ride the exchange, and key-sort on the receiving
      shard (``key_words`` 1 = u32 column 0, 2 = u64 packed columns
      [0, 1]).

    Returns ``(sorted_rows [D, cap * out_factor, row_words],
    recv_counts int32[D, D], overflowed bool[D])`` with each shard's rows
    key-sorted, padding at the end (strip with ``recv_counts[d].sum()``).
    ``overflowed[d]`` flags a receive past the ``out_factor`` headroom or
    a slot-pair overflow: results there are truncated and must not be
    trusted.
    """
    if sort_mode not in SORT_MODES:
        # a typo must not silently measure (and mislabel) the gather path
        raise ValueError(f"unknown sort_mode {sort_mode!r} "
                         "(expected 'gather', 'multisort' or 'colsort')")
    if partition not in ("range", "dest"):
        raise ValueError(f"unknown partition {partition!r} "
                         "(expected 'range' or 'dest')")
    if partition == "range" and key_words != 1:
        raise ValueError("range partitioning is defined on single-word "
                         "u32 keys")
    n = mesh.num_shards
    local = mesh.local_shards   # this process's shards (all, on one card)
    impl = resolve_transport(mesh, impl)
    write_back = key_words == 1
    splitters = (uniform_splitters(n, mesh.device) if partition == "range"
                 else None)

    def sort_received(received, total):
        """Key-sort received rows with pads (index >= total) masked to
        the sentinel on every key word so they sort last; stable order
        within equal keys is arrival (source-major) order."""
        idx = torch.arange(received.shape[1], device=received.device)
        pad = idx[None, :] >= total[:, None]
        keys = tuple(k.masked_fill(pad, SENTINEL)
                     for k in _row_keys(received, key_words))
        return _local_sort(received, keys, sort_mode, write_back)[0]

    def exchange_and_sort(grouped, counts, slot_rows=None):
        with trace_mod.span("exchange.receive_fill"):
            output = torch.zeros(
                (local, grouped.shape[1] * out_factor, row_words),
                dtype=grouped.dtype, device=grouped.device)
        received, recv_counts, _, overflowed = exchange_over(
            mesh, grouped, counts, output=output, impl=impl,
            slot_rows=slot_rows)
        with trace_mod.span("fused.receive_sort"):
            sorted_rows = sort_received(received, recv_counts.sum(dim=1))
        return sorted_rows, recv_counts, overflowed

    def no_exchange(rows, valid):
        # single shard: no exchange, one sort is the whole job
        keys = tuple(k.masked_fill(~valid, SENTINEL)
                     for k in _row_keys(rows, key_words))
        sorted_rows, _ = _local_sort(rows, keys, sort_mode, write_back)
        counts = valid.sum(dim=1, dtype=torch.int32).reshape(1, 1)
        return sorted_rows, counts, torch.zeros(1, dtype=torch.bool,
                                                device=rows.device)

    if partition == "range":

        def step(rows: torch.Tensor):
            if n == 1:
                return no_exchange(rows, torch.ones(rows.shape[:2],
                                                    dtype=torch.bool,
                                                    device=rows.device))
            # Local sort by KEY once: range partition is monotonic in
            # key, so key-sorted rows are destination-grouped for free.
            with trace_mod.span("fused.local_sort"):
                grouped, sorted_keys = _local_sort(
                    rows, _row_keys(rows, 1), sort_mode, write_back)
            # per-destination counts: D-1 binary searches on sorted keys
            with trace_mod.span("fused.counts"):
                bounds = torch.searchsorted(
                    sorted_keys, splitters.expand(local, n - 1).contiguous())
                edge = torch.full((local, 1), rows.shape[1],
                                  dtype=bounds.dtype, device=bounds.device)
                bounds = torch.cat([torch.zeros_like(edge), bounds, edge],
                                   dim=1)
                counts = torch.diff(bounds, dim=1).to(torch.int32)
            return exchange_and_sort(grouped, counts)

        return step

    def step(rows: torch.Tensor, dest: torch.Tensor,
             slot_rows: Optional[int] = None):
        dest = dest.reshape(rows.shape[:2])
        if n == 1:
            return no_exchange(rows, dest >= 0)
        with trace_mod.span("fused.local_sort"):
            grouped, counts = group_by_destination(rows, dest, n)
        return exchange_and_sort(grouped, counts, slot_rows)

    return step


# ---------------------------------------------------------------------------
# the overlapped host drivers
# ---------------------------------------------------------------------------

class _RoundIO:
    """Host staging of a driver's rounds on ``device``.

    A round is padded to ``per_round`` rows (zero rows, destination -1
    past the data) and uploaded as ``[shards, cap, W]`` rows and
    ``[shards, cap]`` destinations; its step's results come back as numpy
    arrays. On the CPU the padded host tensors ARE the step's inputs, with
    no copy. On ``cuda`` each of ``slots`` staging
    slots owns pinned upload and download buffers, reused round after
    round: a slot's upload buffers are refilled only after the event
    recorded behind their last ``non_blocking`` upload has completed (a
    refill of a pinned buffer still in flight is a silent race), and
    results come back by ``non_blocking`` copies into the slot's pinned
    download buffers behind an event that ``collect`` waits on. A driver
    collects a slot's round before it uploads the slot's next round."""

    def __init__(self, device: torch.device, slots: int):
        self.cuda = device.type == "cuda"
        self.device = device
        self._up: List[Optional[tuple]] = [None] * slots
        self._down: List[Optional[tuple]] = [None] * slots

    def upload(self, slot: int, chunk: np.ndarray, dchunk: np.ndarray,
               shards: int, per_round: int):
        row_words = chunk.shape[1]
        rows = np.asarray(chunk).view(np.int32)
        k = len(rows)
        if not self.cuda:
            rows_h = torch.zeros((per_round, row_words), dtype=torch.int32)
            dest_h = torch.full((per_round,), -1, dtype=torch.int32)
        else:
            buf = self._up[slot]
            if buf is None or buf[0].shape != (per_round, row_words):
                buf = self._up[slot] = (
                    torch.empty((per_round, row_words), dtype=torch.int32,
                                pin_memory=True),
                    torch.empty((per_round,), dtype=torch.int32,
                                pin_memory=True),
                    torch.cuda.Event())
            else:
                buf[2].synchronize()  # the slot's last upload has landed
            rows_h, dest_h, _ = buf
            rows_h.numpy()[k:] = 0
            dest_h.numpy()[k:] = -1
        rows_h.numpy()[:k] = rows
        dest_h.numpy()[:k] = dchunk
        if self.cuda:
            rows_h = rows_h.to(self.device, non_blocking=True)
            dest_h = dest_h.to(self.device, non_blocking=True)
            buf[2].record()
        return (rows_h.view(shards, per_round // shards, row_words),
                dest_h.view(shards, per_round // shards))

    def download(self, slot: int, result: Tuple[torch.Tensor, ...]):
        """Start bringing a step's ``(rows, counts, overflowed)`` home;
        returns the handle ``collect`` takes."""
        if not self.cuda:
            return result, None
        buf = self._down[slot]
        if buf is None or [t.shape for t in buf] != [t.shape
                                                     for t in result]:
            buf = self._down[slot] = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in result)
        for host, dev in zip(buf, result):
            host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    @staticmethod
    def collect(handle) -> Tuple[np.ndarray, ...]:
        """Wait for a ``download`` and return its arrays (views of the
        slot's buffers, valid until the slot's next round)."""
        tensors, event = handle
        if event is not None:
            event.synchronize()
        return tuple(t.numpy() for t in tensors)


def _slot_rows(dchunk: np.ndarray, shards: int, cap: int,
               out_factor: int) -> int:
    """Rows per (source, destination) slot for one round of ``cap`` rows
    per shard (shard ``s`` holds the round's rows ``[s * cap, (s + 1) *
    cap)``, bound for ``dchunk``'s shards): the receive buffer's even
    share ``cap * out_factor // shards``, or, where a pair of this round
    carries more, that pair rounded up to a power of two and held to
    ``cap``, the most one source shard can send. A committed map output
    is partition-contiguous, so a round's source shard may send all its
    rows to one or two destinations. Counted on the host from the
    round's destinations, with no wait on the card."""
    even = cap * out_factor // shards
    top = 0
    for lo in range(0, len(dchunk), cap):
        d = dchunk[lo:lo + cap]
        d = d[(d >= 0) & (d < shards)]
        if len(d):
            top = max(top, int(np.bincount(d, minlength=shards).max()))
    return even if top <= even else min(cap, bucket_quota(top))


def _runs_into(runs: List[list], lo: int, out: np.ndarray,
               counts: np.ndarray) -> None:
    """Append each shard's received rows (the first ``counts[i].sum()``
    rows of ``out[i]``, key-sorted) to ``runs[lo + i]``. ``.copy()``: a
    view would pin the round's buffer."""
    out = out.reshape(counts.shape[0], -1, out.shape[-1]).view(np.uint32)
    for i, total in enumerate(counts.sum(axis=1).tolist()):
        runs[lo + i].append(out[i][:total].copy())


def _merged(runs: List[list], key_words: int, row_words: int
            ) -> List[np.ndarray]:
    """Each shard's runs merged by key (earlier runs first on ties)."""
    merged = []
    for shard_runs in runs:
        if not shard_runs:
            merged.append(np.zeros((0, row_words), np.uint32))
        elif len(shard_runs) == 1:
            merged.append(shard_runs[0])
        else:
            merged.append(merge_runs([(_run_keys(r, key_words), r)
                                      for r in shard_runs])[1])
    return merged


def run_fused_exchange(mesh: VirtualMesh, rows: np.ndarray,
                       dest: np.ndarray, *, key_words: int = 2,
                       rows_per_round: int = 0, out_factor: int = 2,
                       impl: str = "auto", sort_mode: str = "gather",
                       tracer=None, pipeline_rounds: bool = True,
                       ) -> Tuple[List[np.ndarray], int]:
    """Drive the fused step over fully-materialized arrays: bounded rounds
    of ``rows_per_round`` rows per shard (0 = one shot) through
    ``run_fused_exchange_rounds``. ``rows: u32[N, W]`` (unpadded),
    ``dest: i32[N]`` destination shard per row."""
    n = mesh.num_shards
    row_words = rows.shape[1]
    if len(rows) == 0:
        return [np.zeros((0, row_words), np.uint32) for _ in range(n)], 0
    cap = rows_per_round if rows_per_round > 0 else -(-len(rows) // n)
    per_round = cap * n
    blocks = ((rows[start:start + per_round], dest[start:start + per_round])
              for start in range(0, len(rows), per_round))
    return run_fused_exchange_rounds(
        mesh, blocks, row_words, cap, key_words=key_words,
        out_factor=out_factor, impl=impl, sort_mode=sort_mode,
        tracer=tracer, pipeline_rounds=pipeline_rounds)


def run_fused_exchange_rounds(mesh: VirtualMesh, blocks, row_words: int,
                              rows_per_round: int, *, key_words: int = 2,
                              out_factor: int = 2, impl: str = "auto",
                              sort_mode: str = "gather", tracer=None,
                              pipeline_rounds: bool = True,
                              ) -> Tuple[List[np.ndarray], int]:
    """Drive the fused step over a stream of round blocks: ``blocks``
    yields ``(rows u32[<= rows_per_round * D, row_words], dest i32)`` per
    round, so host staging holds one round (plus the one in flight when
    pipelined) however large the stage. Rounds are DOUBLE-BUFFERED: round
    ``k+1`` is staged and queued on the card before round ``k``'s results
    are collected (``exchange.round`` spans per round, with
    ``exchange.stage`` inside; ``exchange.overlap`` instants when a
    dispatch preceded the previous round's collection; ``exchange.collect``
    and ``exchange.merge`` spans for the host's side).

    Returns ``(per_shard_sorted_rows, rounds)``: shard d's rows key-sorted
    (u64 packed keys when ``key_words == 2``), rounds merged by the
    tournament merge. Each round's slots fit its largest pair
    (``_slot_rows``). Raises ``OverflowError`` on any round's receive
    overflow; the caller (the engine) degrades the stage to the host
    dataplane."""
    tracer = tracer if tracer is not None else trace_mod.NULL
    n = mesh.num_shards
    per_round = max(1, rows_per_round) * n
    step = make_fused_step(mesh, row_words, out_factor=out_factor,
                           impl=impl, sort_mode=sort_mode,
                           key_words=key_words, partition="dest")
    io = _RoundIO(mesh.device, 2)
    runs: List[list] = [[] for _ in range(n)]

    def dispatch(r: int, chunk: np.ndarray, dchunk: np.ndarray):
        """Stage one round and queue its step and its download; nothing
        here waits for the card."""
        q = _slot_rows(dchunk, n, per_round // n, out_factor)
        with trace_mod.span("exchange.round", tracer, round=r,
                            rows=len(chunk), slot_rows=q):
            with trace_mod.span("exchange.stage", tracer, round=r):
                rows_d, dest_d = io.upload(r % 2, chunk, dchunk, n,
                                           per_round)
            handle = io.download(r % 2, step(rows_d, dest_d, q))
        record_exchange(len(chunk))
        return r, handle

    def collect(in_flight) -> None:
        r, handle = in_flight
        with trace_mod.span("exchange.collect", tracer, round=r):
            out, counts, overflowed = io.collect(handle)
            if overflowed.any():
                raise OverflowError(
                    "fused exchange receive overflow: skew exceeds the "
                    "out_factor headroom for this round size; the engine "
                    "degrades the stage to the host dataplane")
            _runs_into(runs, 0, out, counts)

    rounds = 0
    if pipeline_rounds:
        in_flight = None
        for chunk, dchunk in blocks:
            nxt = dispatch(rounds, chunk, dchunk)
            if in_flight is not None:
                tracer.instant("exchange.overlap", "exchange",
                               dispatched=rounds, collecting=rounds - 1)
                collect(in_flight)
            in_flight = nxt
            rounds += 1
        if in_flight is not None:
            collect(in_flight)
    else:
        for chunk, dchunk in blocks:
            collect(dispatch(rounds, chunk, dchunk))
            rounds += 1

    if rounds == 0:
        return [np.zeros((0, row_words), np.uint32) for _ in range(n)], 0
    with trace_mod.span("exchange.merge", tracer, rounds=rounds):
        return _merged(runs, key_words, row_words), rounds


# ---------------------------------------------------------------------------
# the hierarchical (two-level) driver: per-slice steps + slow-link residue
# ---------------------------------------------------------------------------

def _run_keys(r: np.ndarray, key_words: int) -> np.ndarray:
    """Sort/merge keys of shard-row runs: the little-endian packed u64 of
    columns 0-1 (column 1 the high word) for the 2-word layout, column 0
    otherwise; the order ``_row_keys`` sorts by on the card."""
    if key_words == 2:
        return r[:, :2].copy().view(np.uint64).reshape(-1)
    return r[:, 0]


def run_hierarchical_exchange(mesh: VirtualMesh,
                              topology: topology_mod.Topology,
                              rows: np.ndarray, dest: np.ndarray,
                              home_slice: np.ndarray, *,
                              key_words: int = 2, rows_per_round: int = 0,
                              out_factor: int = 2, impl: str = "auto",
                              sort_mode: str = "gather", tracer=None,
                              ) -> Tuple[List[np.ndarray], int]:
    """Drive the factored two-phase redistribution over a multi-slice
    topology: local regroup -> cross-slice move -> local regroup.

    * **Phase 1 (intra)**: every row whose destination shard lives in its
      home slice rides that slice's fused step over the slice sub-mesh
      (``topology.slice_mesh``), in budget-bounded rounds as in the flat
      driver.
    * **Slow-link move**: the slice-crossing residue is tallied and
      charged (``topology.record_cross_slice`` and the installed shim)
      while the phase-1 steps are queued on the card
      (``exchange.overlap``).
    * **Phase 2 (regroup at destination)**: the arrived residue runs the
      destination slice's fused step.

    ``home_slice: i32[N]`` names each row's producing slice; ``dest`` is
    the GLOBAL destination shard per row. Returns the flat drivers'
    contract: per-shard key-sorted rows (runs merged across phases and
    rounds), plus the number of rounds.

    Per-slice degrade: a slice whose receive overflows falls back to
    host-side serving for ITS rows only, byte-identically; the other
    slices stay on the device (``exchange.degrade`` instant with
    ``scope="slice"``)."""
    tracer = tracer if tracer is not None else trace_mod.NULL
    n = mesh.num_shards
    row_words = rows.shape[1]
    if topology is None or topology.is_flat:
        # degenerate single-slice topology: the flat driver IS the plan
        return run_fused_exchange(
            mesh, rows, dest, key_words=key_words,
            rows_per_round=rows_per_round, out_factor=out_factor,
            impl=impl, sort_mode=sort_mode, tracer=tracer)
    dest = np.asarray(dest, dtype=np.int32)
    home = np.asarray(home_slice, dtype=np.int32)
    dest_slice = topology.device_slices()[dest] if len(dest) else dest
    runs: List[list] = [[] for _ in range(n)]
    degraded: set = set()
    rounds = 0
    row_bytes = row_words * 4
    io = _RoundIO(mesh.device, topology.num_slices)

    def host_fallback(s: int, chunk: np.ndarray, dchunk: np.ndarray):
        """Serve one slice-chunk host-side, byte-identically: group by
        destination shard, key-sort each group (the receiving shard's
        sort), append as ordinary runs."""
        lo, hi = topology.slice_bounds(s)
        for d in range(lo, hi):
            sub = chunk[dchunk == d]
            if not len(sub):
                continue
            order = np.argsort(_run_keys(sub, key_words), kind="stable")
            runs[d].append(np.ascontiguousarray(sub[order]))

    def collect(s: int, lo: int, handle) -> None:
        out, counts, overflowed = io.collect(handle)
        if overflowed.any():
            raise OverflowError(
                f"hierarchical exchange receive overflow in slice {s}")
        _runs_into(runs, lo, out, counts)

    def run_phase(per_slice: Dict[int, Tuple[np.ndarray, np.ndarray]],
                  phase: str, dcn_moves=None) -> None:
        """Queue every slice's budget-bounded rounds; charge the
        slow-link residue while round 0's steps are queued; collect with
        per-slice degrade."""
        nonlocal rounds
        sched = []
        for s in sorted(per_slice):
            rs, ds = per_slice[s]
            if not len(rs):
                continue
            lo, hi = topology.slice_bounds(s)
            ns = hi - lo
            cap = rows_per_round if rows_per_round > 0 else -(-len(rs) // ns)
            per_round = max(1, cap) * ns
            step = make_fused_step(
                topology_mod.slice_mesh(mesh, topology, s), row_words,
                out_factor=out_factor, impl=impl, sort_mode=sort_mode,
                key_words=key_words, partition="dest")
            chunks = [(rs[o:o + per_round], ds[o:o + per_round])
                      for o in range(0, len(rs), per_round)]
            sched.append((s, lo, ns, per_round, step, chunks))

        charged = dcn_moves is None

        def charge():
            nonlocal charged
            if charged:
                return
            charged = True
            for (src, dst) in sorted(dcn_moves):
                topology_mod.record_cross_slice(dcn_moves[(src, dst)])

        for r in range(max((len(c[5]) for c in sched), default=0)):
            batch = []
            for s, lo, ns, per_round, step, chunks in sched:
                if r >= len(chunks):
                    continue
                chunk, dchunk = chunks[r]
                if s in degraded:
                    host_fallback(s, chunk, dchunk)
                    continue
                local = dchunk - lo   # slice-local destination shards
                q = _slot_rows(local, ns, per_round // ns, out_factor)
                with trace_mod.span("exchange.round", tracer,
                                    round=rounds, phase=phase, slice=s,
                                    rows=len(chunk), slot_rows=q):
                    with trace_mod.span("exchange.stage", tracer,
                                        round=rounds):
                        rows_d, dest_d = io.upload(s, chunk, local, ns,
                                                   per_round)
                    handle = io.download(s, step(rows_d, dest_d, q))
                record_exchange(len(chunk))
                batch.append((s, lo, chunk, dchunk, handle))
            if batch and not charged:
                # the residue crosses the slow link while the steps
                # above run on the card
                tracer.instant("exchange.overlap", "exchange",
                               dispatched=rounds, collecting=-1,
                               phase=phase)
            charge()
            for s, lo, chunk, dchunk, handle in batch:
                try:
                    with trace_mod.span("exchange.collect", tracer,
                                        round=rounds, slice=s):
                        collect(s, lo, handle)
                except OverflowError:
                    # degrade ONLY this slice's rows to host serving
                    degraded.add(s)
                    tracer.instant("exchange.degrade", "exchange",
                                   scope="slice", slice=s,
                                   reason="overflow")
                    host_fallback(s, chunk, dchunk)
            if batch:
                rounds += 1
        charge()  # a phase with no device rounds still pays its move

    if len(rows):
        intra = dest_slice == home
        phase1 = {}
        phase2 = {}
        dcn_moves: Dict[Tuple[int, int], int] = {}
        for s in range(topology.num_slices):
            m = intra & (home == s)
            phase1[s] = (rows[m], dest[m])
        inter_rows = 0
        for t in range(topology.num_slices):
            segs_r, segs_d = [], []
            for s in range(topology.num_slices):
                if s == t:
                    continue
                m = (home == s) & (dest_slice == t)
                cnt = int(m.sum())
                if not cnt:
                    continue
                dcn_moves[(s, t)] = cnt * row_bytes
                inter_rows += cnt
                segs_r.append(rows[m])
                segs_d.append(dest[m])
            if segs_r:
                phase2[t] = (np.concatenate(segs_r),
                             np.concatenate(segs_d))
        run_phase(phase1, "intra", dcn_moves=dcn_moves)
        run_phase(phase2, "residue")
        tracer.instant("exchange.hierarchical", "exchange",
                       slices=topology.num_slices,
                       intra_rows=int(intra.sum()), inter_rows=inter_rows,
                       cross_slice_bytes=inter_rows * row_bytes,
                       degraded_slices=sorted(degraded))

    with trace_mod.span("exchange.merge", tracer, rounds=rounds):
        return _merged(runs, key_words, row_words), rounds
