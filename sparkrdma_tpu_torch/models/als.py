"""ALS (alternating least squares): the skew stress test.

Port of ``sparkrdma_tpu/models/als.py`` (BASELINE.md config #5, MLlib ALS
over 100M ratings). Item popularity is zipfian, so grouping ratings by
item hammers a few shards; the chunked exchange
(``parallel.exchange.chunked_exchange_resident``) keeps each round's
receive bounded at any skew. On ``cuda`` its rounds move their blocks
with the ring all-to-all kernel.

One half-step (solving item factors from fixed user factors):

1. ratings live user-sharded as ``(item, user, rating bits)`` int32 rows
   (the float32 rating rides as its bits);
2. each shard groups its rows by the owner of the entity being solved
   (entity e lives on shard ``e % D``), on the device, with the same
   stable order as the JAX package's host-side grouping, and the chunked
   exchange moves them there (span ``als.group``, then ``chunked.*``);
3. per entity: the normal equations ``A^T A + reg*I`` and ``A^T r`` over
   its ratings' other-side factors, summed by ``index_add_`` (span
   ``als.gram``), then one batched ``torch.linalg.solve`` (span
   ``als.solve``, around ``als.gram``). The JAX package solves with
   ``jnp.linalg.solve`` outside any Pallas kernel, so the library solve
   is the port of it. With ``ALSConfig.weighted_reg`` the diagonal is
   MLlib's ``reg * n_e`` (ALS-WR, Zhou et al. 2008), ``n_e`` entity e's
   ratings, counted on the device from the rows it received.

Every result stays on the device until the factors are returned. While
profiled, a half-step counts ``als.rounds`` (its chunked rounds),
``als.ratings`` (rows summed into normal equations), ``als.entities``
(entities solved) and ``als.gram_bytes`` (the sums' bytes from shapes:
each row's other-side factor, rating and entity id read, each entity's
``k*k + k`` float32 sums written).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.exchange import (
    chunked_exchange_resident,
    group_by_destination,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, to_u64

_SOLVE_CHUNK = 1 << 20


@dataclass(frozen=True)
class ALSConfig:
    num_users: int
    num_items: int
    rank: int = 8
    reg: float = 0.1
    zipf_a: float = 1.3  # item popularity skew
    # MLlib's regularisation: entity e's diagonal is reg * n_e (its
    # ratings) instead of reg
    weighted_reg: bool = False


def generate_ratings(cfg: ALSConfig, num_devices: int, per_device: int,
                     seed: int = 0) -> np.ndarray:
    """Zipf-skewed ratings ``u32[D*per_device, 3]`` = (item, user,
    rating_bits), user-sharded (device d holds users congruent d mod D).
    The same numbers as the JAX package's generator for the same seed."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((num_devices * per_device, 3), dtype=np.uint32)
    for d in range(num_devices):
        lo = d * per_device
        items = (rng.zipf(cfg.zipf_a, size=per_device) - 1) % cfg.num_items
        users = rng.integers(0, cfg.num_users // num_devices,
                             size=per_device) * num_devices + d
        ratings = rng.uniform(1.0, 5.0, size=per_device).astype(np.float32)
        rows[lo:lo + per_device, 0] = items
        rows[lo:lo + per_device, 1] = users
        rows[lo:lo + per_device, 2] = ratings.view(np.uint32)
    return rows


def solve_item_factors(ratings_for_device: torch.Tensor,
                       user_factors: torch.Tensor, cfg: ALSConfig,
                       items_on_device: torch.Tensor,
                       key_col: int = 0) -> torch.Tensor:
    """Batched normal-equation solve for one shard's entities, on the
    device its tensors lie on.

    ``ratings_for_device``: the shard's post-exchange int32 ``(item, user,
    rating bits)`` rows; ``user_factors``: float32 ``[num_other, k]``
    factors of the fixed side; ``items_on_device``: the sorted int64 ids
    of the entities solved here. ``key_col`` picks the side being SOLVED
    (0 = items from fixed user factors, 1 = users from fixed item
    factors). Returns float32 ``[len(items_on_device), k]``.

    As in the JAX package the entity count is bucketed to a power of two
    (``n_pad``; padded entities see ``reg*I x = 0``, weighted or not) and
    the rows are summed in chunks of at most 2**20, which bounds the
    ``[CH, k, k]`` outer-product transient. The JAX chunks are padded to
    one static shape with rows aimed past ``n_pad`` that ``mode="drop"``
    discards; eager PyTorch needs no static shape, so the last chunk is
    short and no pad row exists.

    Each chunk sums into a zeroed buffer that is then added to the
    running total. Summing every chunk straight into the running float32
    total stagnates once the total dwarfs its terms: a hot item with 25M
    ratings of rank-8 factors lost 5.8% of a diagonal entry that way in a
    float32 simulation, and 0.05% with per-chunk partials. On the card
    ``index_add_`` sums with atomics, in no fixed order. The chunks'
    gathers, outer products and sums are the ``als.gram`` span.

    With ``cfg.weighted_reg`` entity e's diagonal is ``reg * n_e``, its
    rows here counted on the device, as MLlib's ``computeFactors``
    regularises."""
    k = cfg.rank
    dev = ratings_for_device.device
    keys = to_u64(ratings_for_device[:, key_col])
    local_key = torch.searchsorted(items_on_device.to(torch.int64), keys)
    others = to_u64(ratings_for_device[:, 1 - key_col])
    vals = ratings_for_device[:, 2].view(torch.float32)
    n_keys = items_on_device.numel()
    n_pad = 1 << max(4, (n_keys - 1).bit_length())
    ata = torch.zeros((n_pad, k, k), dtype=torch.float32, device=dev)
    atr = torch.zeros((n_pad, k), dtype=torch.float32, device=dev)
    rows = ratings_for_device.shape[0]
    ch = min(_SOLVE_CHUNK, 1 << max(10, (max(rows, 1) - 1).bit_length()))
    with trace_mod.span("als.gram"):
        for lo in range(0, rows, ch):
            u = user_factors.index_select(0, others[lo:lo + ch])
            li = local_key[lo:lo + ch]
            r = vals[lo:lo + ch]
            ata += torch.zeros_like(ata).index_add_(
                0, li, u[:, :, None] * u[:, None, :])
            atr += torch.zeros_like(atr).index_add_(0, li, u * r[:, None])
    reg = cfg.reg
    if cfg.weighted_reg:
        # a padded entity has no row and keeps reg * I
        n_e = torch.bincount(local_key, minlength=n_pad).clamp_(min=1)
        reg = cfg.reg * n_e.to(torch.float32)[:, None, None]
    ata = ata + reg * torch.eye(k, dtype=torch.float32, device=dev)[None]
    return torch.linalg.solve(ata, atr[..., None])[..., 0][:n_keys]


def exchange_ratings(mesh: VirtualMesh,
                     ratings: Union[np.ndarray, torch.Tensor], quota: int,
                     key_col: int = 0, impl: str = "auto",
                     ) -> Tuple[List[torch.Tensor], int]:
    """The half-step's skewed shuffle: group each shard's ratings by the
    owner (``key % D``) of column ``key_col``, stably, and move them with
    the chunked exchange. ``ratings`` is the JAX layout ``u32[D*per, 3]``
    or the mesh layout ``int32[D, per, 3]`` already on ``mesh.device``.
    Returns ``(received, rounds)``: ``received[d]`` is shard d's rows on
    the device, grouped by source shard in each source's order. A row
    whose key column is negative as int32 pads a shard and is not
    sent."""
    n = mesh.num_shards
    rows = (ratings if isinstance(ratings, torch.Tensor)
            else rows_from_numpy(ratings, mesh))
    with trace_mod.span("als.group"):
        keys = rows[..., key_col]
        # ids lie below 2**31: a key negative as int32 marks a pad row,
        # which the grouping leaves behind
        grouped, counts = group_by_destination(
            rows, torch.where(keys < 0, n, to_u64(keys) % n), n)
        counts = counts.cpu().numpy()  # the host driver sizes the rounds
    return chunked_exchange_resident(mesh, grouped, counts, quota, impl)


def als_half_step(mesh: VirtualMesh, cfg: ALSConfig,
                  ratings: Union[np.ndarray, torch.Tensor],
                  user_factors: np.ndarray, quota: int, key_col: int = 0,
                  impl: str = "auto") -> Tuple[np.ndarray, int]:
    """One half-step: skewed shuffle + batched solves.

    ``key_col=0``: solve item factors from fixed user factors (the
    skew-hammered side); ``key_col=1``: solve user factors from fixed
    item factors. ``ratings`` as in ``exchange_ratings``. Returns
    ``(factors float32[num_entities, k], rounds_used)``; an entity with
    no rating gets zeros."""
    num_out = cfg.num_items if key_col == 0 else cfg.num_users
    received, rounds = exchange_ratings(mesh, ratings, quota, key_col, impl)
    fixed = torch.from_numpy(np.ascontiguousarray(
        user_factors, dtype=np.float32)).to(mesh.device)
    factors = torch.zeros((num_out, cfg.rank), dtype=torch.float32,
                          device=mesh.device)
    with trace_mod.span("als.solve"):
        for rows in received:
            if not rows.shape[0]:
                continue
            keys_here = torch.unique(to_u64(rows[:, key_col]))
            factors[keys_here] = solve_item_factors(rows, fixed, cfg,
                                                    keys_here, key_col)
            if trace_mod.counting():
                n, e, k = rows.shape[0], keys_here.numel(), cfg.rank
                trace_mod.count("als.ratings", n)
                trace_mod.count("als.entities", e)
                trace_mod.count("als.gram_bytes",
                                n * (4 * k + 8) + e * 4 * (k * k + k))
    if trace_mod.counting():
        trace_mod.count("als.rounds", rounds)
    return factors.cpu().numpy(), rounds


def rmse(ratings: np.ndarray, user_factors: np.ndarray,
         item_factors: np.ndarray, sample: int = 0) -> float:
    """Root-mean-square prediction error over (a sample of) the ratings."""
    rows = ratings
    if sample and len(rows) > sample:
        rows = rows[np.random.default_rng(0).permutation(len(rows))[:sample]]
    pred = np.sum(user_factors[rows[:, 1].astype(np.int64)]
                  * item_factors[rows[:, 0].astype(np.int64)], axis=1)
    err = pred - rows[:, 2].view(np.float32)
    return float(np.sqrt(np.mean(err * err)))


def run_als(mesh: VirtualMesh, cfg: ALSConfig, ratings: np.ndarray,
            quota: int, iterations: int = 5, seed: int = 0,
            rmse_sample: int = 200_000, impl: str = "auto",
            ) -> Tuple[np.ndarray, np.ndarray, list, int]:
    """The full alternating loop: each iteration solves items from users,
    then users from items (two skewed shuffles per iteration). The
    ratings cross to the device once.

    Returns ``(user_factors, item_factors, rmse_history, total_rounds)``;
    ``rmse_history[0]`` is the error of the random initialisation."""
    rng = np.random.default_rng(seed)
    user_factors = (rng.standard_normal((cfg.num_users, cfg.rank))
                    .astype(np.float32) / np.sqrt(cfg.rank))
    item_factors = np.zeros((cfg.num_items, cfg.rank), np.float32)
    ratings_d = rows_from_numpy(ratings, mesh)
    total_rounds = 0
    history = [rmse(ratings, user_factors, item_factors, rmse_sample)]
    for _ in range(iterations):
        item_factors, r1 = als_half_step(mesh, cfg, ratings_d, user_factors,
                                         quota, key_col=0, impl=impl)
        user_factors, r2 = als_half_step(mesh, cfg, ratings_d, item_factors,
                                         quota, key_col=1, impl=impl)
        total_rounds += r1 + r2
        history.append(rmse(ratings, user_factors, item_factors,
                            rmse_sample))
    return user_factors, item_factors, history, total_rounds


def numpy_als_half_step(ratings: np.ndarray, user_factors: np.ndarray,
                        cfg: ALSConfig,
                        items: Optional[np.ndarray] = None) -> np.ndarray:
    """Host oracle: per-item normal equations in float64, plain numpy.
    ``items`` restricts the solve to those item ids; the rest stay
    zero."""
    if items is not None:
        ratings = ratings[np.isin(ratings[:, 0], items)]
    k = cfg.rank
    item_factors = np.zeros((cfg.num_items, k), dtype=np.float32)
    items = ratings[:, 0].astype(np.int64)
    users = ratings[:, 1].astype(np.int64)
    vals = ratings[:, 2].view(np.float32)
    for i in np.unique(items):
        sel = items == i
        u = user_factors[users[sel]].astype(np.float64)
        ata = u.T @ u + cfg.reg * np.eye(k)
        atr = u.T @ vals[sel].astype(np.float64)
        item_factors[i] = np.linalg.solve(ata, atr).astype(np.float32)
    return item_factors
