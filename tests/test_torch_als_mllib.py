"""MLlib's weighted regularisation in the port's ALS half-steps.

``ALSConfig.weighted_reg`` puts ``reg * n_e`` on entity e's diagonal, as
MLlib's ``ALS.computeFactors`` does (ALS-WR). On seeded ratings of a few
hundred users and items with skewed items, at D = 10 (MLlib's default
blocks) and D = 8, both weighted half-steps equal the benchmark's plain
float64 reference (``benchmarks/reference/als.py``) and a float64 numpy
form of MLlib's equation, entity by entity. With the weighting off the
solve is the parent's arithmetic to the byte; the JAX parity tests of
``test_torch_models.py`` hold it to the JAX package.

Tolerance: the port sums in float32 (by ``index_add_`` on the CPU, by
the normal equations kernel in no fixed order on a card) and solves in
float32; the references in float64. At
these sizes an entity sums at most a few hundred terms, so ``rtol=1e-4``
relative to each factor's norm leaves some 20x room over the readings.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from benchmarks.reference import als as reference
from sparkrdma_tpu_torch.models import als
from sparkrdma_tpu_torch.ops import normal_equations
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import to_u64

USERS, ITEMS, RANK = 300, 120, 6
CFG = als.ALSConfig(num_users=USERS, num_items=ITEMS, rank=RANK, reg=0.1,
                    weighted_reg=True)
RTOL = 1e-4


def _ratings(shards: int, per: int, seed: int) -> torch.Tensor:
    """``int32[shards, per, 3]`` (item, user, star bits): items Zipf-skewed
    (the most-rated a few percent of the ratings), users uniform, stars
    1-5; the last shard's last rows pad (-1)."""
    rng = np.random.default_rng(seed)
    n = shards * per - 3
    ranks = np.minimum(rng.zipf(1.3, size=n) - 1, ITEMS - 1)
    rows = np.full((shards * per, 3), -1, np.int32)
    rows[:n, 0] = rng.permutation(ITEMS)[ranks]
    rows[:n, 1] = rng.integers(0, USERS, size=n)
    rows[:n, 2] = rng.integers(1, 6, size=n).astype(np.float32).view(
        np.int32)
    return torch.from_numpy(rows).reshape(shards, per, 3)


def _unit_factors(n: int, seed: int) -> np.ndarray:
    f = np.random.default_rng(seed).standard_normal((n, RANK))
    return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)


def _mllib(ratings: torch.Tensor, fixed: np.ndarray, key_col: int,
           num_out: int, reg: float) -> np.ndarray:
    """MLlib's equation entity by entity, float64 numpy: ``(sum f f^T +
    reg * n_e * I) x = sum rating * f`` over e's ratings; zero where e has
    none."""
    rows = ratings.reshape(-1, 3).numpy()
    rows = rows[(rows[:, 0] >= 0) & (rows[:, 1] >= 0)]
    out = np.zeros((num_out, fixed.shape[1]))
    for e in np.unique(rows[:, key_col]):
        mine = rows[rows[:, key_col] == e]
        f = fixed[mine[:, 1 - key_col]].astype(np.float64)
        stars = mine[:, 2].view(np.float32).astype(np.float64)
        lhs = f.T @ f + reg * len(mine) * np.eye(fixed.shape[1])
        out[e] = np.linalg.solve(lhs, f.T @ stars)
    return out


def _close(got: np.ndarray, want: np.ndarray) -> None:
    dist = np.linalg.norm(got - want, axis=1)
    norm = np.linalg.norm(want, axis=1)
    assert (norm > 0).any()
    np.testing.assert_array_less(dist, RTOL * np.maximum(norm, 1e-30) + 0.0)


@pytest.mark.parametrize("shards", [10, 8])
@pytest.mark.parametrize("impl", ["gather", "native"])
def test_weighted_half_steps_equal_the_references(shards, impl):
    """Items from unit user factors, then users from those items: each
    half-step of the port against the reference's and MLlib's equation
    from the same fixed side."""
    ratings = _ratings(shards, 400, seed=shards)
    counts = np.bincount(ratings[..., 0].reshape(-1)[
        ratings[..., 0].reshape(-1) >= 0].numpy(), minlength=ITEMS)
    assert counts.max() > 0.03 * counts.sum()  # a hot item
    mesh = VirtualMesh(shards, "cpu")
    users = _unit_factors(USERS, seed=1)
    items, rounds = als.als_half_step(mesh, CFG, ratings, users, quota=64,
                                      key_col=0, impl=impl)
    assert rounds > 1
    for want in (reference.half_step(
                     ratings, torch.from_numpy(users), key_col=0,
                     num_out=ITEMS, reg=CFG.reg).numpy(),
                 _mllib(ratings, users, 0, ITEMS, CFG.reg)):
        _close(items, want)
    again, _ = als.als_half_step(mesh, CFG, ratings, items, quota=64,
                                 key_col=1, impl=impl)
    for want in (reference.half_step(
                     ratings, torch.from_numpy(items), key_col=1,
                     num_out=USERS, reg=CFG.reg).numpy(),
                 _mllib(ratings, items, 1, USERS, CFG.reg)):
        _close(again, want)


def test_weighting_moves_every_entity_rated_more_than_once():
    """``reg * n_e`` against ``reg``: the same where e has one rating,
    apart wherever it has more."""
    ratings = _ratings(10, 200, seed=3)
    users = _unit_factors(USERS, seed=2)
    mesh = VirtualMesh(10, "cpu")
    got = {w: als.als_half_step(mesh, replace(CFG, weighted_reg=w), ratings,
                                users, quota=64, key_col=0)[0]
           for w in (False, True)}
    items = ratings[..., 0].reshape(-1)
    n = np.bincount(items[items >= 0].numpy(), minlength=ITEMS)
    apart = np.abs(got[True] - got[False]).max(axis=1) > 1e-6
    np.testing.assert_array_equal(apart, n > 1)


def _parent_solve(rows, fixed, cfg, keys, key_col):
    """The parent's solve, unweighted: ``A^T A + reg*I`` in chunked float32
    sums, then the batched solve."""
    k = cfg.rank
    local = torch.searchsorted(keys, to_u64(rows[:, key_col]))
    others = to_u64(rows[:, 1 - key_col])
    vals = rows[:, 2].view(torch.float32)
    n_pad = 1 << max(4, (keys.numel() - 1).bit_length())
    ata = torch.zeros((n_pad, k, k))
    atr = torch.zeros((n_pad, k))
    ch = min(normal_equations.CHUNK_ROWS,
             1 << max(10, (max(rows.shape[0], 1) - 1).bit_length()))
    for lo in range(0, rows.shape[0], ch):
        u = fixed.index_select(0, others[lo:lo + ch])
        li = local[lo:lo + ch]
        ata += torch.zeros_like(ata).index_add_(
            0, li, u[:, :, None] * u[:, None, :])
        atr += torch.zeros_like(atr).index_add_(
            0, li, u * vals[lo:lo + ch, None])
    ata = ata + cfg.reg * torch.eye(k)[None]
    return torch.linalg.solve(ata, atr[..., None])[..., 0][:keys.numel()]


@pytest.mark.parametrize("key_col", [0, 1])
def test_unweighted_solve_is_the_parents_to_the_byte(key_col, monkeypatch):
    """With ``weighted_reg`` off, 3000 rows in chunks of 1024: the same
    float32 bytes as the parent's arithmetic."""
    monkeypatch.setattr(normal_equations, "CHUNK_ROWS", 1024)
    rows = _ratings(1, 3003, seed=7)[0, :3000]
    fixed = torch.from_numpy(_unit_factors(USERS if key_col == 0 else ITEMS,
                                           seed=4))
    keys = torch.unique(to_u64(rows[:, key_col]))
    cfg = replace(CFG, weighted_reg=False)
    got = als.solve_item_factors(rows, fixed, cfg, keys, key_col)
    want = _parent_solve(rows, fixed, cfg, keys, key_col)
    assert torch.equal(got, want)


def test_pad_rows_are_not_sent():
    """A row whose key reads negative is padding: no shard receives it,
    and every live row arrives at its key's block."""
    ratings = _ratings(10, 50, seed=9)
    received, _ = als.exchange_ratings(VirtualMesh(10, "cpu"), ratings, 16,
                                       key_col=1)
    assert sum(r.shape[0] for r in received) == 10 * 50 - 3
    for d, rows in enumerate(received):
        assert (rows[:, 1] >= 0).all() and (rows[:, 1] % 10 == d).all()
