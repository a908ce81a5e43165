"""Shuffle join: the TPC-DS q64/q95-style workload.

Port of ``sparkrdma_tpu/models/join.py`` (BASELINE.md config #4). A
distributed equi-join is two shuffles (both sides hash-partitioned on the
join key to the same shards; on ``cuda`` through the ring all-to-all
kernel) followed by a local sort-merge join per shard: co-sort both sides
by key, then count and sum each left row's matches on the right with two
``searchsorted`` boundaries. The step returns per-shard aggregates (match
count and sum of joined measures), the q95-style reduction.

Keys are u32 words compared as zero-extended int64 (``utils.u32``).
The JAX package sums in int32 with x64 off, so its per-shard partial sums
wrap at 2**31. The port sums in int64 and wraps each shard's total to
int32 at the end: every operation on the way is +, - or *, so the result
is the same modulo 2**32, which is JAX's wrap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.partition import hash_partition
from sparkrdma_tpu_torch.parallel.exchange import (
    resolve_transport,
    shuffle_into,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import SENTINEL, rows_from_numpy, to_u64

PAD = SENTINEL  # the padding key 0xFFFFFFFF


@dataclass(frozen=True)
class JoinConfig:
    rows_per_device_left: int
    rows_per_device_right: int
    key_space: int
    out_factor: int = 2


def make_join_step(mesh: VirtualMesh, cfg: JoinConfig, impl: str = "auto"):
    """Hash-shuffle join over ``mesh``.

    ``step(left, right)`` takes ``left: int32[D, L, 2]`` and ``right:
    int32[D, R, 2]`` (key, measure) u32 rows; padding rows use key
    0xFFFFFFFF. Returns ``(match_count int32[D, 1], measure_sum int32[D,
    1], overflowed bool[D])`` where measure_sum adds, over matched pairs,
    left.measure + right.measure: a fixed-shape aggregate standing in for
    the materialized join. The partial sums wrap as the JAX package's
    int32 sums do; callers add the partials on the host."""
    n = mesh.num_shards
    impl = resolve_transport(mesh, impl)

    def exchange_side(rows: torch.Tensor):
        keys = to_u64(rows[..., 0])
        dest = torch.where(keys != PAD, hash_partition(keys, n), -1)
        received, rvalid, overflowed = shuffle_into(
            rows, dest, rows.shape[1] * cfg.out_factor, impl)
        rkeys = torch.where(rvalid, to_u64(received[..., 0]), PAD)
        sorted_keys, order = torch.sort(rkeys, dim=1, stable=True)
        measures = received[..., 1].to(torch.int64).gather(1, order)
        return sorted_keys, measures, overflowed

    def step(left: torch.Tensor, right: torch.Tensor):
        with trace_mod.span("join.exchange"):
            lk, lv, lof = exchange_side(left)
            rk, rv, rof = exchange_side(right)
        with trace_mod.span("join.merge"):
            # right-side prefix sums of measures for O(1) range sums
            rpref = torch.nn.functional.pad(torch.cumsum(rv, dim=1), (1, 0))
            lo = torch.searchsorted(rk, lk, side="left")
            hi = torch.searchsorted(rk, lk, side="right")
            lvalid = lk != PAD
            matches = torch.where(lvalid, hi - lo, 0)
            pair_sum = torch.where(
                lvalid,
                matches * lv + rpref.gather(1, hi) - rpref.gather(1, lo), 0)
            return (matches.sum(dim=1, keepdim=True).to(torch.int32),
                    pair_sum.sum(dim=1, keepdim=True).to(torch.int32),
                    lof | rof)

    return step


def generate_tables(cfg: JoinConfig, num_devices: int, seed: int = 0,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``(left u32[D*L, 2], right u32[D*R, 2])`` (key, measure < 1000), the
    same arrays as the JAX package's generator for the same seed."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, cfg.key_space,
                        size=(num_devices * cfg.rows_per_device_left, 2),
                        dtype=np.uint32)
    right = rng.integers(0, cfg.key_space,
                         size=(num_devices * cfg.rows_per_device_right, 2),
                         dtype=np.uint32)
    left[:, 1] %= 1000
    right[:, 1] %= 1000
    return left, right


def run_join(mesh: VirtualMesh, cfg: JoinConfig, seed: int = 0,
             impl: str = "auto",
             tables: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             ) -> Tuple[int, int]:
    """Returns ``(total_matches, total_pair_measure_sum)``, the sums over
    shards of the step's partials. ``tables`` is a ``generate_tables``
    result (made from ``seed`` when not given). Raises ``OverflowError``
    when a shuffle overflowed its receive headroom."""
    left, right = (tables if tables is not None
                   else generate_tables(cfg, mesh.num_shards, seed))
    step = make_join_step(mesh, cfg, impl)
    counts, sums, overflowed = step(rows_from_numpy(left, mesh),
                                    rows_from_numpy(right, mesh))
    if overflowed.any().item():
        raise OverflowError("join shuffle overflowed receive headroom; "
                            "raise JoinConfig.out_factor")
    return (int(counts.cpu().numpy().astype(np.int64).sum()),
            int(sums.cpu().numpy().astype(np.int64).sum()))


def numpy_join(left: np.ndarray, right: np.ndarray) -> Tuple[int, int]:
    """Host oracle: exact inner-join aggregates in int64. Per key k with
    ``cL``/``cR`` rows and measure sums ``sL``/``sR`` on each side,
    ``matches = sum_k cL*cR`` and ``pair_sum = sum_k sL*cR + cL*sR``: the
    JAX package's per-row loop, vectorised."""
    keys, inv = np.unique(np.concatenate([left[:, 0], right[:, 0]]),
                          return_inverse=True)
    inv = inv.reshape(-1)
    li, ri = inv[:len(left)], inv[len(left):]

    def per_key(idx, vals):
        # float64 weights are exact: every per-key sum is below 2**53
        count = np.bincount(idx, minlength=len(keys)).astype(np.int64)
        total = np.bincount(idx, weights=vals, minlength=len(keys))
        return count, total.astype(np.int64)

    c_l, s_l = per_key(li, left[:, 1])
    c_r, s_r = per_key(ri, right[:, 1])
    return (int((c_l * c_r).sum()),
            int((s_l * c_r + c_l * s_r).sum()))
