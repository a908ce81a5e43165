"""Parity of the port's ALS, PageRank and join models
(``sparkrdma_tpu_torch.models``) with the JAX package's on the same numpy
input, and with the numpy oracles. The port runs on a CPU ``VirtualMesh``
(its ring transport takes the kernel's plain version there); the JAX side
on the conftest's 8-device CPU mesh.

Tolerances: integer results (join aggregates, exchanged rows) are exact.
Floats are summed in another order than JAX's (and with atomics on the
card): PageRank ranks are held to ``rtol=1e-5``, ALS factors to
``rtol=1e-3, atol=1e-5`` against JAX (float32 normal equations solved by
two LAPACK paths) and to ``rtol=2e-2, atol=1e-3`` against the float64
oracle, the JAX package's own tolerance."""

from dataclasses import fields, replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.models import als as jals
from sparkrdma_tpu.models import join as jjoin
from sparkrdma_tpu.models import pagerank as jpr
from sparkrdma_tpu.parallel.exchange import chunked_exchange as jax_chunked
from sparkrdma_tpu_torch.models import als as tals
from sparkrdma_tpu_torch.models import join as tjoin
from sparkrdma_tpu_torch.models import pagerank as tpr
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, shards_from_numpy

D = 8
PAIRS = [("ring", "dense"), ("dense", "dense"), ("gather", "gather"),
         ("ring", "gather"), ("native", "gather")]
# the slot transports (ring, dense) also flag a pair past its slot, gather
# only a receive past the capacity: flags agree within each kind
OVERFLOW_PAIRS = PAIRS[:3]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, "cpu")


def _put(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P("shuffle")))


_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


# ---- PageRank ----

PR_CFG = tpr.PageRankConfig(num_vertices=64, edges_per_device=96,
                            out_factor=D)


def test_random_graph_matches_jax():
    for got, want in zip(tpr.random_graph(PR_CFG, D, seed=3),
                         jpr.random_graph(jpr.PageRankConfig(
                             **PR_CFG.__dict__), D, seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("port_impl,jax_impl", PAIRS)
def test_pagerank_matches_jax(mesh, vmesh, port_impl, jax_impl):
    want = _cached(("pr", jax_impl), lambda: jpr.run_pagerank(
        mesh, jpr.PageRankConfig(**PR_CFG.__dict__), iterations=5, seed=3,
        impl=jax_impl))
    got = tpr.run_pagerank(vmesh, PR_CFG, iterations=5, seed=3,
                           impl=port_impl)
    assert got.dtype == np.float32 and got.shape == (PR_CFG.num_vertices,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pagerank_transports_agree_bit_for_bit(vmesh):
    """The JAX step's ``shard_map`` keeps its varying-axes check on, which
    rejects the interpret-mode ring, so the port's ring is held to its own
    dense and gather transports: the same rows in the same order reach
    every vertex, so the ranks are equal to the bit."""
    got = [tpr.run_pagerank(vmesh, PR_CFG, iterations=3, seed=4, impl=impl)
           for impl in ("ring", "dense", "gather")]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], got[2])


def test_pagerank_matches_oracle(vmesh):
    edges, _, _ = tpr.random_graph(PR_CFG, D, seed=3)
    got = tpr.run_pagerank(vmesh, PR_CFG, iterations=5, seed=3)
    np.testing.assert_allclose(
        got, tpr.numpy_pagerank(edges, PR_CFG.num_vertices, PR_CFG.damping,
                                5), rtol=1e-4)
    assert abs(got.sum() - 1.0) < 0.2


def test_numpy_pagerank_matches_jax_oracle():
    cfg = tpr.PageRankConfig(num_vertices=256, edges_per_device=300)
    edges, _, _ = tpr.random_graph(cfg, D, seed=5)
    edges[::7, 0] = -1                      # padding rows are skipped
    np.testing.assert_array_equal(
        tpr.numpy_pagerank(edges, cfg.num_vertices, cfg.damping, 4),
        jpr.numpy_pagerank(edges, cfg.num_vertices, cfg.damping, 4))


@pytest.mark.parametrize("port_impl,jax_impl", OVERFLOW_PAIRS)
def test_pagerank_overflow_flags_match_jax(mesh, vmesh, port_impl,
                                           jax_impl):
    """out_factor 1 leaves no fan-in headroom: the same shards flag."""
    cfg = replace(PR_CFG, out_factor=1)
    edges, ranks, deg = tpr.random_graph(cfg, D, seed=6)
    jstep = jpr.make_pagerank_step(mesh, "shuffle",
                                   jpr.PageRankConfig(**cfg.__dict__),
                                   jax_impl)
    want_ranks, want = (np.asarray(a) for a in jstep(
        _put(mesh, edges), _put(mesh, ranks), _put(mesh, deg)))
    tstep = tpr.make_pagerank_step(vmesh, cfg, port_impl)
    got_ranks, got = tstep(rows_from_numpy(edges, vmesh),
                           shards_from_numpy(ranks, vmesh),
                           shards_from_numpy(deg, vmesh))
    assert want.any()
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(OverflowError):
        tpr.run_pagerank(vmesh, cfg, iterations=1, seed=6, impl=port_impl)


# ---- join ----

JOIN_CFG = tjoin.JoinConfig(rows_per_device_left=128,
                            rows_per_device_right=96, key_space=256,
                            out_factor=4)


def _jax_join_step(mesh, cfg, impl, left, right):
    step = jjoin.make_join_step(mesh, "shuffle",
                                jjoin.JoinConfig(**cfg.__dict__), impl)
    return [np.asarray(a) for a in step(_put(mesh, left), _put(mesh, right))]


def _port_join_step(vmesh, cfg, impl, left, right):
    step = tjoin.make_join_step(vmesh, cfg, impl)
    return [t.numpy() for t in step(rows_from_numpy(left, vmesh),
                                    rows_from_numpy(right, vmesh))]


def test_generate_tables_matches_jax():
    for got, want in zip(tjoin.generate_tables(JOIN_CFG, D, seed=7),
                         jjoin.generate_tables(
                             jjoin.JoinConfig(**JOIN_CFG.__dict__), D, 7)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("port_impl,jax_impl", PAIRS)
def test_join_step_matches_jax(mesh, vmesh, port_impl, jax_impl):
    left, right = tjoin.generate_tables(JOIN_CFG, D, seed=7)
    want = _cached(("join", jax_impl), lambda: _jax_join_step(
        mesh, JOIN_CFG, jax_impl, left, right))
    got = _port_join_step(vmesh, JOIN_CFG, port_impl, left, right)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    matches, pair_sum = tjoin.run_join(vmesh, JOIN_CFG, seed=7,
                                       impl=port_impl)
    assert (matches, pair_sum) == jjoin.numpy_join(left, right)
    assert matches > 0


def test_join_no_matches(vmesh):
    cfg = tjoin.JoinConfig(rows_per_device_left=32, rows_per_device_right=32,
                           key_space=4, out_factor=D)
    left, right = tjoin.generate_tables(cfg, D, seed=9)
    left[:, 0] = 0
    right[:, 0] = 1
    assert tjoin.run_join(vmesh, cfg, tables=(left, right)) == (0, 0)
    assert tjoin.numpy_join(left, right) == (0, 0)


def test_join_int32_partials_wrap_as_jax(mesh, vmesh):
    """Measures past 2**31 and many matches per key: the per-shard int32
    partial sums wrap, and wrap the same way in both packages."""
    cfg = tjoin.JoinConfig(rows_per_device_left=16, rows_per_device_right=16,
                           key_space=3, out_factor=D)
    rng = np.random.default_rng(10)
    left = np.stack([rng.integers(0, 3, D * 16),
                     rng.integers(2**31, 2**32, D * 16)], 1).astype(np.uint32)
    right = np.stack([rng.integers(0, 3, D * 16),
                      rng.integers(2**30, 2**32, D * 16)], 1).astype(np.uint32)
    want = _jax_join_step(mesh, cfg, "gather", left, right)
    got = _port_join_step(vmesh, cfg, "ring", left, right)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("port_impl,jax_impl", OVERFLOW_PAIRS)
def test_join_overflow_flags_match_jax(mesh, vmesh, port_impl, jax_impl):
    """Four keys land on at most four shards: out_factor 1 overflows."""
    cfg = tjoin.JoinConfig(rows_per_device_left=32, rows_per_device_right=32,
                           key_space=4, out_factor=1)
    left, right = tjoin.generate_tables(cfg, D, seed=11)
    want = _jax_join_step(mesh, cfg, jax_impl, left, right)[2]
    got = _port_join_step(vmesh, cfg, port_impl, left, right)[2]
    assert want.any()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(OverflowError):
        tjoin.run_join(vmesh, cfg, seed=11, impl=port_impl)


def test_numpy_join_matches_jax_oracle():
    rng = np.random.default_rng(12)
    left = rng.integers(0, 50, (700, 2)).astype(np.uint32)
    right = rng.integers(0, 50, (500, 2)).astype(np.uint32)
    right[:40, 0] = 0xFFFFFFFF
    left[:5, 0] = 0xFFFFFFFF
    assert tjoin.numpy_join(left, right) == jjoin.numpy_join(left, right)


# ---- ALS ----

ALS_CFG = tals.ALSConfig(num_users=64, num_items=16, rank=4, zipf_a=1.3)


def _jcfg(cfg):
    """The JAX package's ``ALSConfig`` of the same settings: it has no
    ``weighted_reg``, and the port's default is its plain ``reg``."""
    assert not cfg.weighted_reg
    return jals.ALSConfig(**{f.name: getattr(cfg, f.name)
                             for f in fields(jals.ALSConfig)})


def _factors(n, k, seed):
    return np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)


def _jax_grouping(ratings, key_col):
    """The JAX package's host-side destination grouping (als.py)."""
    per = ratings.shape[0] // D
    grouped = np.empty_like(ratings)
    counts = np.zeros((D, D), np.int32)
    for d in range(D):
        seg = ratings[d * per:(d + 1) * per]
        dest = (seg[:, key_col] % D).astype(np.int32)
        grouped[d * per:(d + 1) * per] = seg[np.argsort(dest, kind="stable")]
        counts[d] = np.bincount(dest, minlength=D)
    return grouped, counts


def test_generate_ratings_matches_jax():
    np.testing.assert_array_equal(
        tals.generate_ratings(ALS_CFG, D, 80, seed=5),
        jals.generate_ratings(_jcfg(ALS_CFG), D, 80, 5))


@pytest.mark.parametrize("port_impl", ["ring", "gather"])
@pytest.mark.parametrize("key_col", [0, 1])
def test_exchange_ratings_matches_jax(mesh, vmesh, key_col, port_impl):
    ratings = tals.generate_ratings(ALS_CFG, D, 80, seed=5)
    want, want_rounds = _cached(("als_x", key_col), lambda: jax_chunked(
        mesh, "shuffle", *_jax_grouping(ratings, key_col), quota=16))
    got, rounds = tals.exchange_ratings(vmesh, ratings, 16, key_col,
                                        port_impl)
    assert rounds == want_rounds > 1
    for d in range(D):
        np.testing.assert_array_equal(got[d].numpy().view(np.uint32),
                                      want[d])


@pytest.mark.parametrize("key_col", [0, 1])
def test_solve_item_factors_matches_jax(key_col):
    ratings = tals.generate_ratings(ALS_CFG, D, 80, seed=5)
    other = _factors(ALS_CFG.num_users if key_col == 0 else
                     ALS_CFG.num_items, ALS_CFG.rank, 1)
    rows = ratings[ratings[:, key_col] % D == 2]
    keys = np.unique(rows[:, key_col])
    want = jals.solve_item_factors(rows, other, _jcfg(ALS_CFG), keys,
                                   key_col=key_col)
    got = tals.solve_item_factors(
        torch.from_numpy(rows.view(np.int32)), torch.from_numpy(other),
        ALS_CFG, torch.from_numpy(keys.astype(np.int64)), key_col=key_col)
    assert got.dtype == torch.float32 and got.shape == (len(keys),
                                                        ALS_CFG.rank)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("port_impl", ["ring", "gather"])
@pytest.mark.parametrize("key_col", [0, 1])
def test_als_half_step_matches_jax(mesh, vmesh, key_col, port_impl):
    ratings = tals.generate_ratings(ALS_CFG, D, 80, seed=6)
    other = _factors(ALS_CFG.num_users if key_col == 0 else
                     ALS_CFG.num_items, ALS_CFG.rank, 6)
    want, want_rounds = _cached(("als", key_col), lambda: jals.als_half_step(
        mesh, _jcfg(ALS_CFG), ratings, other, quota=16, key_col=key_col))
    got, rounds = tals.als_half_step(vmesh, ALS_CFG, ratings, other,
                                     quota=16, key_col=key_col,
                                     impl=port_impl)
    assert rounds == want_rounds
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    # and the float64 oracle, at the JAX package's tolerance
    cfg = ALS_CFG if key_col == 0 else replace(
        ALS_CFG, num_users=ALS_CFG.num_items, num_items=ALS_CFG.num_users)
    oracle = tals.numpy_als_half_step(
        ratings if key_col == 0 else ratings[:, [1, 0, 2]], other, cfg)
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=1e-3)


def test_run_als_rmse_falls_like_jax(mesh, vmesh):
    cfg = tals.ALSConfig(num_users=96, num_items=24, rank=6, zipf_a=1.3)
    ratings = tals.generate_ratings(cfg, D, 160, seed=8)
    uf, itf, history, rounds = tals.run_als(vmesh, cfg, ratings, quota=32,
                                            iterations=2, seed=8)
    assert rounds >= 4
    assert history[1] < history[0] * 0.5, history
    assert history[2] <= history[1], history
    juf, jitf, jhistory, jrounds = jals.run_als(
        mesh, _jcfg(cfg), ratings, quota=32, iterations=2, seed=8)
    assert rounds == jrounds
    np.testing.assert_allclose(history, jhistory, rtol=1e-3)
    np.testing.assert_allclose(itf, jitf, rtol=1e-2, atol=1e-3)
