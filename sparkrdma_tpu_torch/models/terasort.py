"""TeraSort: the flagship workload, over the virtual mesh.

Port of ``sparkrdma_tpu/models/terasort.py``. One round is ONE fused step
over all D shards (``parallel.device_plane.make_fused_step`` in its range
mode): a key sort that doubles as the destination grouping, the size
exchange and the transport (the ring all-to-all kernel on ``cuda``), and
the receive-side key sort. Rows are ``[N, 1+P]`` u32 matrices (key word +
P payload words) on the host and int32 ``[D, cap, 1+P]`` on the mesh.

The result is globally sorted by (shard order, local order) — the same
contract as TeraSort's output files. ``numpy_terasort`` is the plain
numpy pipeline the results are checked against.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.device_plane import make_fused_step
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.shuffle.external import merge_runs
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, rows_to_numpy


@dataclass(frozen=True)
class TeraSortConfig:
    rows_per_device: int
    payload_words: int = 24  # 4B key word + 24*4B payload = the classic 100B row
    out_factor: int = 2      # receive headroom (uniform keys -> mild skew)
    # How payload follows its key through a local sort. The JAX package
    # has three strategies for XLA ("gather", "multisort", "colsort");
    # they give the same stable order, and in PyTorch all three are a
    # stable key sort plus one row gather (see device_plane._local_sort).
    sort_mode: str = "gather"

    @property
    def row_bytes(self) -> int:
        return 4 * (1 + self.payload_words)


def make_terasort_step(mesh: VirtualMesh, cfg: TeraSortConfig,
                       impl: str = "auto"):
    """The one-round TeraSort step over ``mesh`` (a ``VirtualMesh``, or a
    ``GlobalMesh``: then ``D`` is the process's ``local_shards`` and the
    counts are ``[Dl, G]``).

    Takes ``rows: int32[D, rows_per_device, 1+P]`` (column 0 is the
    key); returns ``(sorted_rows [D, out_cap, 1+P], recv_counts[D, D],
    overflowed[D])`` with rows per shard sorted by key, padding
    (key=0xFFFFFFFF) at the end. ``overflowed[d]`` flags that shard d's
    receive buffer was too small for the skew.
    """
    return make_fused_step(mesh, 1 + cfg.payload_words,
                           out_factor=cfg.out_factor, impl=impl,
                           sort_mode=cfg.sort_mode, key_words=1,
                           partition="range")


def generate_rows(cfg: TeraSortConfig, num_devices: int,
                  seed: int = 0) -> np.ndarray:
    """Uniform random TeraSort input: u32 keys + incompressible payload."""
    rng = np.random.default_rng(seed)
    n = num_devices * cfg.rows_per_device
    return rng.integers(0, 2**32, size=(n, 1 + cfg.payload_words),
                        dtype=np.uint32)


def numpy_terasort(rows: np.ndarray, num_partitions: int) -> np.ndarray:
    """The identical partition/shuffle/sort pipeline in plain numpy."""
    keys = rows[:, 0]
    edges = np.array([(i * (1 << 32)) // num_partitions
                      for i in range(1, num_partitions)], dtype=np.uint64)
    dest = np.searchsorted(edges, keys.astype(np.uint64), side="right")
    order = np.argsort(dest, kind="stable")
    grouped = rows[order]
    counts = np.bincount(dest, minlength=num_partitions)
    out = np.empty_like(grouped)
    start = 0
    for c in counts:
        seg = grouped[start:start + c]
        out[start:start + c] = seg[np.argsort(seg[:, 0], kind="stable")]
        start += c
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_terasort(mesh: VirtualMesh, cfg: TeraSortConfig, impl: str = "auto",
                 seed: int = 0, rows: Optional[np.ndarray] = None,
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Host driver: generate, run one warm-up round and one timed round,
    return ``(sorted_rows u32[D*out_cap, 1+P], counts[D, D],
    step_seconds)``. The timed round runs between two device
    synchronisations."""
    n = mesh.num_shards
    if rows is None:
        rows = generate_rows(cfg, n, seed)
    step = make_terasort_step(mesh, cfg, impl)
    rows_d = rows_from_numpy(rows, mesh)
    step(rows_d)  # warm-up: kernel build and load, allocator pools
    _sync(mesh.device)
    t0 = time.perf_counter()
    out, counts, overflowed = step(rows_d)
    _sync(mesh.device)
    dt = time.perf_counter() - t0
    overflowed = overflowed.cpu().numpy()
    if overflowed.any():
        raise OverflowError(
            "receive buffer overflow: key skew exceeds out_factor headroom "
            f"(shards {np.nonzero(overflowed)[0].tolist()}); "
            "raise TeraSortConfig.out_factor or chunk the round")
    return rows_to_numpy(out), counts.cpu().numpy(), dt


def run_terasort_streamed(mesh: VirtualMesh, cfg: TeraSortConfig,
                          rows: np.ndarray, impl: str = "auto",
                          ) -> Tuple[list, int]:
    """TeraSort a dataset LARGER than one round's capacity: R rounds of
    the one-round step, each bounded to ``rows_per_device`` rows per
    shard, then each shard merges its R key-sorted runs on the host.
    Round r+1 is dispatched before round r is collected, so up to two
    rounds are resident at once.

    Returns ``(per_shard_sorted_rows: [D] list of u32[*, 1+P], rounds)``.
    """
    n = mesh.num_shards
    if len(rows) == 0:
        return [np.zeros((0, rows.shape[1]), rows.dtype)
                for _ in range(n)], 0
    per_round = n * cfg.rows_per_device
    num_rounds = -(-len(rows) // per_round)
    step = make_terasort_step(mesh, cfg, impl)
    # Tail-round padding: pad j is addressed to shard j % n with that
    # shard's range-maximum key, spreading the extra receive load evenly
    # (all-max-key padding would pile onto the last shard and overflow
    # its headroom on valid input). Pads are appended LAST, so the stable
    # sort puts each shard's pads at the very end of its run; the strip
    # is an exact per-shard row count.
    range_max = np.array([((d + 1) << 32) // n - 1 for d in range(n)],
                         dtype=np.uint32)
    # With pads spread evenly a shard receives at most ~rows_per_device
    # real rows (uniform keys) + ~rows_per_device pads, which fits the
    # out_factor >= 2 receive budget; genuine key skew is caught by the
    # overflow flag like any other round.
    if n > 1 and cfg.out_factor < 2 and len(rows) % per_round:
        raise ValueError("streamed terasort with a partial tail round needs "
                         "out_factor >= 2 (pad headroom)")

    runs: list = [[] for _ in range(n)]

    def dispatch(r: int):
        chunk = rows[r * per_round:(r + 1) * per_round]
        pads_for = np.zeros(n, dtype=np.int64)
        tail_pad = per_round - len(chunk)
        if tail_pad:
            pad = np.zeros((tail_pad, rows.shape[1]), rows.dtype)
            dests = np.arange(tail_pad) % n
            pad[:, 0] = range_max[dests]
            np.add.at(pads_for, dests, 1)
            chunk = np.concatenate([chunk, pad])
        return pads_for, step(rows_from_numpy(chunk, mesh))

    def collect(pads_for, results):
        out, counts, overflowed = results
        if overflowed.cpu().numpy().any():
            raise OverflowError("streamed round receive overflow; raise "
                                "out_factor or shrink rows_per_device")
        out = rows_to_numpy(out).reshape(n, -1, rows.shape[1])
        counts = counts.cpu().numpy()
        for d in range(n):
            total = int(counts[d].sum())
            # .copy(): a view would pin the whole padded round buffer
            runs[d].append(out[d][:total - int(pads_for[d])].copy())

    pending = None
    for r in range(num_rounds):
        nxt = dispatch(r)
        if pending is not None:
            collect(*pending)
        pending = nxt
    collect(*pending)

    merged = []
    for d in range(n):
        # R key-sorted runs -> one sorted output; earlier rounds win ties
        _, out = merge_runs([(r[:, 0], r) for r in runs[d]])
        merged.append(out)
    return merged, num_rounds


def verify_terasort(sorted_rows: np.ndarray, counts: np.ndarray,
                    input_rows: np.ndarray, num_devices: int) -> None:
    """Check the global sort contract against the input multiset; raises
    ``AssertionError`` on the first breach."""
    per_dev = sorted_rows.reshape(num_devices, -1, sorted_rows.shape[-1])
    got_keys = []
    prev_max = -1
    for d in range(num_devices):
        total = int(counts[d].sum())
        keys = per_dev[d][:total, 0].astype(np.int64)
        if len(keys):
            if not (np.diff(keys) >= 0).all():
                raise AssertionError(f"device {d} not locally sorted")
            if keys[0] < prev_max:
                raise AssertionError(f"device {d} overlaps previous range")
            prev_max = keys[-1]
        got_keys.append(keys)
    got = np.concatenate(got_keys)
    if len(got) != len(input_rows):
        raise AssertionError("row count mismatch")
    np.testing.assert_array_equal(np.sort(got),
                                  np.sort(input_rows[:, 0].astype(np.int64)))
