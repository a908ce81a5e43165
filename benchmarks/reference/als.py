"""One MLlib ALS iteration in plain PyTorch, in float64, in blocks of rows.

Ratings are ``int32[..., 3]`` rows of (item, user, rating as float32
bits); a row whose item or user reads negative pads a shard and is
skipped. One iteration solves every item from the given user factors,
then every user from those item factors, each entity e as MLlib's
``ALS.computeFactors`` does with ``implicitPrefs`` and ``nonnegative``
off (ALS-WR's weighted regularisation, Zhou et al. 2008):

    x_e = (sum_{r in R(e)} f_r f_r^T + reg * n_e * I)^-1
          * sum_{r in R(e)} rating_r * f_r

with ``n_e`` e's number of ratings and ``f_r`` the other side's factor of
rating r. Every sum and solve is float64 here, with TF32 off.

Departures from MLlib, none of which changes a factor beyond rounding:
- MLlib ships factors between its user and item in- and out-blocks and
  keeps the ratings where they are; the port shuffles the ratings to the
  solving side's block every half-step. The sums are the same.
- MLlib sums its normal equations in double and solves them by Cholesky
  (LAPACK ``dppsv``); here the sums are float64 and the solve is
  ``torch.linalg.solve`` (LU). The port sums in float32.
- An entity with no rating is absent from MLlib's blocks; here its
  factor is zero, as the port leaves it.

The keywords break one guarantee each, for the cell's controls:
``sum_dtype`` sums the normal equations in that precision (the solve
stays float64), ``weighted=False`` puts the unweighted ``reg * I`` in
place, and ``drop_item`` loses every rating of that item in the item
half-step's sums.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 21  # rating rows a block: a [BLOCK, k, k] float64 transient


def half_step(ratings: torch.Tensor, fixed: torch.Tensor, *, key_col: int,
              num_out: int, reg: float, weighted: bool = True,
              sum_dtype: torch.dtype = torch.float64,
              drop_item: int | None = None) -> torch.Tensor:
    """Solve the side in column ``key_col`` (0 items, 1 users) from
    ``fixed``, the other side's factors; float64 ``[num_out, k]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = fixed.shape[1]
    dev = ratings.device
    fixed = fixed.to(device=dev, dtype=torch.float64)
    ata = torch.zeros((num_out, k, k), dtype=sum_dtype, device=dev)
    atr = torch.zeros((num_out, k), dtype=sum_dtype, device=dev)
    count = torch.zeros(num_out, dtype=torch.int64, device=dev)
    flat = ratings.reshape(-1, 3)
    for start in range(0, flat.shape[0], BLOCK):
        rows = flat[start:start + BLOCK]
        live = (rows[:, 0] >= 0) & (rows[:, 1] >= 0)
        if drop_item is not None:
            live &= rows[:, 0] != drop_item
        rows = rows[live]
        key = rows[:, key_col].to(torch.int64)
        f = fixed[rows[:, 1 - key_col].to(torch.int64)]
        rating = rows[:, 2].view(torch.float32).to(torch.float64)
        ata.index_add_(0, key, (f[:, :, None] * f[:, None, :]).to(sum_dtype))
        atr.index_add_(0, key, (f * rating[:, None]).to(sum_dtype))
        count.index_add_(0, key, torch.ones_like(key))
    rated = count > 0
    lam = reg * (count[rated] if weighted else torch.ones_like(count[rated]))
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    lhs = ata[rated].to(torch.float64) + lam.to(torch.float64)[:, None,
                                                              None] * eye
    out = torch.zeros((num_out, k), dtype=torch.float64, device=dev)
    out[rated] = torch.linalg.solve(
        lhs, atr[rated].to(torch.float64)[..., None])[..., 0]
    return out


def most_rated_item(ratings: torch.Tensor, num_items: int) -> int:
    """The item with the most ratings (the lowest id among ties)."""
    items = ratings.reshape(-1, 3)[:, 0]
    counts = torch.bincount(items[items >= 0].to(torch.int64),
                            minlength=num_items)
    return int(torch.argmax(counts))


def iteration(ratings: torch.Tensor, user_factors: torch.Tensor, *,
              num_users: int, num_items: int, reg: float,
              weighted: bool = True, sum_dtype: torch.dtype = torch.float64,
              drop_top_item: bool = False,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Items from ``user_factors``, then users from those items: float64
    ``(item_factors [num_items, k], user_factors [num_users, k])``.
    ``drop_top_item`` loses the most-rated item's ratings once, in the
    item half-step."""
    drop = most_rated_item(ratings, num_items) if drop_top_item else None
    items = half_step(ratings, user_factors, key_col=0, num_out=num_items,
                      reg=reg, weighted=weighted, sum_dtype=sum_dtype,
                      drop_item=drop)
    users = half_step(ratings, items, key_col=1, num_out=num_users, reg=reg,
                      weighted=weighted, sum_dtype=sum_dtype)
    return items, users
