"""MLlib ALS iterations: the port's ``als_half_step``, items then users,
over the Netflix Prize's counts.

The ratings are drawn once on the device from the seed: users and items
by bounded Zipf laws over their popularity ranks (the configuration's
exponents), each rank given its id by a seeded permutation, and stars
uniform over 1-5. Row i lies on shard ``i // rows_per_shard``, an input
split that knows no block; the last shard's tail is padded with rows of
-1. Four sets of initial user factors follow MLlib's ``initialize`` (a
Gaussian vector scaled to unit norm); job i starts from set ``i % 4``.

A job is one MLlib iteration: the item half-step from the set's user
factors, then the user half-step from those items, each the port's
``als_half_step`` (the shuffle by the solving side's block ``e % 10``,
the normal equations with MLlib's weighted ``reg * n_e``, the batched
solve). Both factor matrices come back to the host.

Two jobs, drawn from the seed among the first 16 of the window, are held
to ``reference/als.py``'s float64 iteration from the same initial
factors: an entity is wrong when its factor's distance from the
reference's exceeds ``ERR_LIMIT`` times the reference's norm.
``ERR_LIMIT`` is 2e-4. The program's largest readings at full size on
an H100 80GB HBM3 (700 W), over 20 seeds, were 5.1e-6 for an item and
2.2e-6 for a user: float32 sums of up to ~232,000 ratings an item, with
per-chunk partials, and a batched float32 solve that the weighted
diagonal keeps well conditioned. The limit leaves ~39 times that, and
lies below the error of every entity whose normal equations are summed
in bfloat16 (unit roundoff 2**-9; 1.5-1.9 at worst on the same card).

The controls put the reference in the program's place with one guarantee
broken (``CONTROLS``); ``control=True`` takes the first. All three on a
few seeds:

    python -m benchmarks.jobs.als --seconds 3 --seed 1 2 3
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmarks.reference import als as reference

ERR_LIMIT = 2e-4
INIT_SETS = 4
SAMPLED, AMONG = 2, 16
DRAW_BLOCK = 1 << 24  # ratings drawn at a time
# reference keywords of each control: the normal equations summed in
# bfloat16, the parent's unweighted reg * I, the most-rated item's
# ratings lost once
CONTROLS = {"bf16_sums": {"sum_dtype": torch.bfloat16},
            "unweighted_reg": {"weighted": False},
            "top_item_dropped": {"drop_top_item": True}}


def input_bytes(cfg: dict) -> int:
    """The ratings' int32 words and the user factors handed in a job."""
    return cfg["ratings"] * 3 * 4 + cfg["users"] * cfg["rank"] * 4


def exchange_bytes(cfg: dict) -> int:
    """The job's two shuffles route every rating once each, a 12-byte row
    read once and written once."""
    return 2 * cfg["ratings"] * 12 * 2


def gram_bytes(cfg: dict) -> int:
    """``als.gram_bytes`` a job when every user and item has a rating:
    each half-step reads each rating's other-side factor, rating and
    entity id and writes each entity's ``k*k + k`` float32 sums."""
    k = cfg["rank"]
    return (2 * cfg["ratings"] * (4 * k + 8)
            + (cfg["users"] + cfg["items"]) * 4 * (k * k + k))


def _zipf_ranks(n: int, exponent: float, size: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """``size`` int64 ranks in [0, n) with P(rank r) ~ (r + 1)**-exponent,
    by the inverse of the law's cumulative sum."""
    weights = torch.arange(1, n + 1, dtype=torch.float64,
                           device=device).pow_(-exponent)
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(size, dtype=torch.float64, generator=gen, device=device)
    return torch.searchsorted(cdf, u).clamp_(max=n - 1)


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """``ratings`` int32 ``[shards, rows_per_shard, 3]`` on ``device`` and
    ``inits``, ``INIT_SETS`` float32 numpy user factor sets."""
    device = torch.device(device)
    d, per, n = cfg["shards"], cfg["rows_per_shard"], cfg["ratings"]
    if d * per < n or d * (per - 1) >= n:
        raise ValueError(f"{d} x {per} rows do not hold {n} ratings")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    user_id = torch.randperm(cfg["users"], generator=gen, device=device)
    item_id = torch.randperm(cfg["items"], generator=gen, device=device)
    rows = torch.full((d * per, 3), -1, dtype=torch.int32, device=device)
    for lo in range(0, n, DRAW_BLOCK):
        size = min(DRAW_BLOCK, n - lo)
        block = rows[lo:lo + size]
        block[:, 0] = item_id[_zipf_ranks(cfg["items"], cfg["item_zipf"],
                                          size, gen, device)]
        block[:, 1] = user_id[_zipf_ranks(cfg["users"], cfg["user_zipf"],
                                          size, gen, device)]
        stars = torch.randint(1, 6, (size,), generator=gen, device=device)
        block[:, 2] = stars.to(torch.float32).view(torch.int32)
    inits = []
    for _ in range(INIT_SETS):
        f = torch.randn((cfg["users"], cfg["rank"]), dtype=torch.float64,
                        generator=gen, device=device)
        f /= torch.linalg.vector_norm(f, dim=1, keepdim=True)
        inits.append(f.to(torch.float32).cpu().numpy())
    return {"ratings": rows.reshape(d, per, 3), "inits": inits}


def _port_step(cfg: dict, device):
    from sparkrdma_tpu_torch.models.als import ALSConfig, als_half_step
    from sparkrdma_tpu_torch.parallel.exchange import resolve_transport
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    mesh = VirtualMesh(cfg["shards"], device)
    port = ALSConfig(num_users=cfg["users"], num_items=cfg["items"],
                     rank=cfg["rank"], reg=cfg["reg"],
                     weighted_reg=cfg["reg_weighted_by_count"])

    def step(ratings, users):
        items, _ = als_half_step(mesh, port, ratings, users, cfg["quota"],
                                 key_col=0)
        users, _ = als_half_step(mesh, port, ratings, items, cfg["quota"],
                                 key_col=1)
        return items, users

    return step, resolve_transport(mesh, "auto")


def _reference(cfg: dict, ratings: torch.Tensor, users: np.ndarray,
               **broken):
    """The reference's float64 (items, users) from the user factors
    ``users``; ``broken`` as ``CONTROLS``' keywords."""
    return reference.iteration(
        ratings, torch.from_numpy(users), num_users=cfg["users"],
        num_items=cfg["items"], reg=cfg["reg"],
        **{"weighted": cfg["reg_weighted_by_count"], **broken})


def _control_step(cfg: dict, kind: str):
    """The reference in the program's place, one guarantee broken."""
    def step(ratings, users):
        return tuple(f.to(torch.float32).cpu().numpy() for f in _reference(
            cfg, ratings, users, **CONTROLS[kind]))
    return step


def relative_errors(got: np.ndarray, want: torch.Tensor) -> torch.Tensor:
    """Each entity's ``|got - want| / |want|`` (2-norms; an entity the
    reference leaves at zero reads its absolute distance)."""
    got = torch.from_numpy(got).to(want.device, torch.float64)
    dist = torch.linalg.vector_norm(got - want, dim=1)
    norm = torch.linalg.vector_norm(want, dim=1)
    return torch.where(norm > 0, dist / torch.where(norm > 0, norm, 1.0),
                       dist)


class Cell:
    """One run's ALS: the ratings, the initial factor sets, the entry, and
    the two sampled jobs' factors. ``control`` is False, True (the first
    control) or a control's name."""

    def __init__(self, cfg: dict, work: dict, seed: int, device,
                 control=False):
        self.cfg = cfg
        if control:
            kind = next(iter(CONTROLS)) if control is True else control
            self.step, self.transport = _control_step(cfg, kind), "control"
        else:
            self.step, self.transport = _port_step(cfg, device)
        self.inputs = make_inputs(cfg, seed, device)
        self.sampled = sorted(random.Random(seed).sample(range(AMONG),
                                                         SAMPLED))
        # the harness submits jobs in index order from the first warm-up
        self._next = -work["warmup_jobs"]

    def submit(self):
        index, self._next = self._next, self._next + 1
        init = index % INIT_SETS
        items, users = self.step(self.inputs["ratings"],
                                 self.inputs["inits"][init])
        return index, init, items, users

    @staticmethod
    def fetch(result):
        """The factors are on the host when the step returns."""
        return None

    def finish(self, index: int, result, host) -> dict:
        submitted, init, items, users = result
        record = {"index": submitted, "overflowed": False}
        if submitted in self.sampled:
            record.update(init=init, items=items, users=users)
        return record

    def kept_bytes(self) -> int:
        return 0

    def release(self) -> None:
        self.step = None

    def check(self, records: list) -> dict:
        cfg, ratings = self.cfg, self.inputs["ratings"]
        kept = {r["index"]: r for r in records if "items" in r}
        wrong, worst = 0, {"items": 0.0, "users": 0.0}
        for index in self.sampled:
            if index not in kept:
                continue
            record = kept[index]
            want = dict(zip(("items", "users"), _reference(
                cfg, ratings, self.inputs["inits"][record["init"]])))
            for side, factors in want.items():
                err = relative_errors(record[side], factors)
                wrong += int((err > ERR_LIMIT).sum())
                worst[side] = max(worst[side], float(err.max()))
        flat = ratings.reshape(-1, 3)
        live = flat[flat[:, 0] >= 0].to(torch.int64)
        pairs = live[:, 1] * cfg["items"] + live[:, 0]
        per_item = torch.bincount(live[:, 0], minlength=cfg["items"])
        per_user = torch.bincount(live[:, 1], minlength=cfg["users"])
        return {
            "factors_wrong": (wrong, 0),
            "jobs_missing": (len(set(self.sampled) - set(kept)), 0),
            "item_err_max": (worst["items"], None),
            "user_err_max": (worst["users"], None),
            "repeated_pairs": (len(pairs) - int(torch.unique(pairs).numel()),
                               None),
            "top_item_ratings": (int(per_item.max()), None),
            "top_user_ratings": (int(per_user.max()), None),
            "least_user_ratings": (int(per_user.min()), None),
        }


def main(argv=None) -> int:
    """Each control of the cell on each seed: the usual check must come
    out not correct. Exits 1 unless every run failed it."""
    import argparse
    import json

    from benchmarks import harness

    parser = argparse.ArgumentParser(description=main.__doc__.split(".")[0])
    parser.add_argument("--workload", default="als-netflix.mllib-iteration")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seed", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    caught = runs = 0
    for kind in CONTROLS:
        for seed in args.seed:
            result = harness.run_cell(args.workload, seed, args.seconds,
                                      False, started=time.perf_counter(),
                                      control=kind)
            runs += 1
            caught += not result["correct"]
            print(json.dumps({"control": kind, "seed": seed,
                              "correct": result["correct"],
                              "checks": result["checks"]}), flush=True)
    return 0 if caught == runs else 1


if __name__ == "__main__":
    raise SystemExit(main())
