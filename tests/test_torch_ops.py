"""Parity of the port's sort and aggregation ops and of its
``make_shuffle_exchange`` with the JAX package's on the same numpy input.

``ops/sort``: distinct keys compare bit for bit with ``lax.sort`` (which
promises no order for ties); ties are held to a numpy stable argsort;
``sort_rows`` to the JAX device plane's ``_local_sort`` (``gather``,
whose iota tiebreak makes its order total), and ``lookup_unique`` to the
JAX query plans' ``_lookup``, shard by shard.
``ops/aggregate``: the five cases of ``tests/test_aggregate.py`` (every
op, count, all padding, a single key, exact capacity) plus the truncation
signal, one shard and a batch of shards. ``make_shuffle_exchange``:
balanced, skewed and empty traffic at ``out_factor`` 1 and 2 with every
port transport, including the overflow flags, against the JAX function on
the conftest's 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.models import tpcds_queries as jq
from sparkrdma_tpu.ops import aggregate as jagg
from sparkrdma_tpu.ops import sort as jsort
from sparkrdma_tpu.parallel import device_plane as jdp
from sparkrdma_tpu.parallel.exchange import make_shuffle_exchange as jmake
from sparkrdma_tpu_torch.ops import aggregate as tagg
from sparkrdma_tpu_torch.ops import sort as tsort
from sparkrdma_tpu_torch.parallel.exchange import make_shuffle_exchange
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy, rows_to_numpy

D = 8
U32_MAX = np.iinfo(np.uint32).max


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, "cpu")


def _bits(a: np.ndarray) -> torch.Tensor:
    """u32 numpy -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# -- ops/sort ----------------------------------------------------------------

def test_sort_kv_distinct_keys_match_jax():
    rng = np.random.default_rng(6)
    keys = np.unique(rng.integers(0, 2**32, 1100, dtype=np.uint32))[:1000]
    rng.shuffle(keys)
    vals = rng.integers(0, 2**31, 1000).astype(np.int32)
    cols = rng.integers(0, 255, (1000, 3)).astype(np.int32)
    jk, jv = jsort.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    tk, tv = tsort.sort_kv(_bits(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _, jc = jsort.sort_kv(jnp.asarray(keys), jnp.asarray(cols))
    _, tc = tsort.sort_kv(_bits(keys), torch.from_numpy(cols))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jk, none = jsort.sort_kv(jnp.asarray(keys))
    tk, tnone = tsort.sort_kv(_bits(keys))
    assert none is None and tnone is None
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))


def test_sort_kv_ties_stable_and_batched():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 40, (D, 256)).astype(np.uint32)
    keys[:, ::9] = U32_MAX - 1   # top of the u32 range sorts last
    vals = rng.integers(0, 255, (D, 256, 3)).astype(np.int32)
    tk, tv = tsort.sort_kv(_bits(keys), torch.from_numpy(vals))
    for d in range(D):
        order = np.argsort(keys[d], kind="stable")
        np.testing.assert_array_equal(_u32(tk)[d], keys[d][order])
        np.testing.assert_array_equal(tv.numpy()[d], vals[d][order])
    # int64 keys (zero-extended) come back int64
    tk64, _ = tsort.sort_kv(torch.from_numpy(keys.astype(np.int64)))
    assert tk64.dtype == torch.int64
    np.testing.assert_array_equal(tk64.numpy(), np.sort(keys, axis=1))


def test_sort_segments_padding_matches_jax():
    keys = np.array([5, 3, 9, 7, 0, 0], dtype=np.uint32)
    valid = np.array([True, True, True, True, False, False])
    jk, _ = jsort.sort_segments(jnp.asarray(keys), jnp.asarray(valid))
    tk, _ = tsort.sort_segments(_bits(keys), torch.from_numpy(valid))
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    assert (_u32(tk)[4:] == U32_MAX).all()
    rng = np.random.default_rng(8)
    keys = rng.permutation(10**6)[:D * 64].astype(np.uint32).reshape(D, 64)
    valid = rng.random((D, 64)) < 0.7
    vals = np.arange(D * 64, dtype=np.int32).reshape(D, 64)
    tk, tv = tsort.sort_segments(_bits(keys), torch.from_numpy(valid),
                                 torch.from_numpy(vals[..., None]))
    for d in range(D):
        jk, jv = jsort.sort_segments(jnp.asarray(keys[d]),
                                     jnp.asarray(valid[d]),
                                     jnp.asarray(vals[d]))
        np.testing.assert_array_equal(_u32(tk)[d], np.asarray(jk))
        live = valid[d].sum()
        np.testing.assert_array_equal(tv.numpy()[d, :live, 0],
                                      np.asarray(jv)[:live])


def test_merge_sorted_padded_matches_jax():
    counts = np.array([3, 0, 5, 1], np.int32)
    keys = np.zeros(16, np.uint32)
    want = np.asarray(jsort.merge_sorted_padded(jnp.asarray(keys),
                                                jnp.asarray(counts)))
    got = tsort.merge_sorted_padded(_bits(keys), torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)
    batched = tsort.merge_sorted_padded(
        _bits(np.zeros((2, 16), np.uint32)),
        torch.from_numpy(np.stack([counts, counts[::-1] * 2])))
    np.testing.assert_array_equal(batched.numpy()[0], want)
    assert batched.numpy()[1].sum() == min(16, 2 * counts.sum())


@pytest.mark.parametrize("key_words,pads", [
    (1, False), (1, True), (2, False), (2, True)])
def test_sort_rows_matches_jax_local_sort(key_words, pads):
    """``sort_rows`` against the JAX package's ``_local_sort`` in its
    ``gather`` mode, shard by shard: key words of five values (ties in
    every word), live keys at the u32 maximum, and with ``pads`` a
    quarter of the rows masked to the sentinel on every key word."""
    rng = np.random.default_rng(20 + 2 * key_words + pads)
    n, w = 96, 4
    rows = rng.integers(0, 2**32, size=(D, n, w), dtype=np.uint64).astype(
        np.uint32)
    rows[..., :key_words] = rng.integers(0, 5, size=(D, n, key_words))
    rows[rng.random((D, n)) < 0.1, 0] = U32_MAX
    words = [rows[..., 0]] if key_words == 1 else [rows[..., 1],
                                                   rows[..., 0]]
    if pads:
        pad = rng.random((D, n)) < 0.25
        words = [np.where(pad, U32_MAX, k) for k in words]
    got_key, got_rows = tsort.sort_rows(
        _bits(rows), tuple(torch.from_numpy(k.astype(np.int64))
                           for k in words))
    for d in range(D):
        want_rows, want_key = jdp._local_sort(
            jnp.asarray(rows[d]), tuple(jnp.asarray(k[d]) for k in words),
            "gather", False)
        np.testing.assert_array_equal(_u32(got_rows)[d],
                                      np.asarray(want_rows))
        np.testing.assert_array_equal(got_key.numpy()[d],
                                      np.asarray(want_key).astype(np.int64))


def test_lookup_unique_matches_jax_lookup():
    """``lookup_unique`` against the JAX query plans' ``_lookup`` run on
    each shard's ``jnp`` arrays: every probe's attribute and found flag,
    with probes that miss and sentinel probes, which are never found."""
    rng = np.random.default_rng(31)
    m, n = 40, 120
    dim_keys = np.stack([rng.permutation(200)[:m]
                         for _ in range(D)]).astype(np.uint32)
    dim_attr = rng.integers(0, 2**32, size=(D, m), dtype=np.uint64).astype(
        np.uint32)
    dim_valid = rng.random((D, m)) < 0.8
    probes = rng.integers(0, 200, size=(D, n)).astype(np.uint32)
    sentinel = rng.random((D, n)) < 0.1
    probes[sentinel] = U32_MAX
    attr, found = tsort.lookup_unique(
        _bits(dim_keys), torch.from_numpy(dim_valid), _bits(dim_attr),
        torch.from_numpy(probes.astype(np.int64)))
    attr, found = attr.numpy(), found.numpy()
    for d in range(D):
        want_attr, want_found = jq._lookup(
            jnp.asarray(dim_keys[d]), jnp.asarray(dim_valid[d]),
            jnp.asarray(dim_attr[d]), jnp.asarray(probes[d]))
        np.testing.assert_array_equal(found[d], np.asarray(want_found))
        np.testing.assert_array_equal(attr[d], np.asarray(want_attr))
    assert not found[sentinel].any()
    assert found.any() and not found[~sentinel].all()


def test_lookup_unique_int64_keys_match_a_numpy_lookup():
    """The int64 form of ``lookup_unique`` (q64's pair composites) against
    a numpy lookup, shard by shard: keys at and past 2**32 and the u32
    maximum as a real key, invalid dimension rows, probes that miss, and
    ``SENTINEL64`` probes, which are never found even where an invalid
    row's key is the sentinel."""
    from sparkrdma_tpu_torch.utils.u32 import SENTINEL64

    rng = np.random.default_rng(37)
    m, n = 48, 160
    space = np.array([0, 1, U32_MAX, 2**32, 2**32 + 1, 2**40, 2**62,
                      SENTINEL64 - 1], np.int64)
    space = np.concatenate([space, rng.integers(0, 2**63 - 1, 200)])
    dim_keys = np.stack([rng.permutation(space)[:m] for _ in range(D)])
    dim_valid = rng.random((D, m)) < 0.8
    dim_keys[:, 0] = SENTINEL64
    dim_valid[:, 0] = False
    dim_attr = rng.integers(0, 2**32, size=(D, m), dtype=np.uint64).astype(
        np.uint32)
    probes = rng.choice(space, size=(D, n))
    sentinel = rng.random((D, n)) < 0.1
    probes[sentinel] = SENTINEL64
    attr, found = tsort.lookup_unique(
        torch.from_numpy(dim_keys), torch.from_numpy(dim_valid),
        _bits(dim_attr), torch.from_numpy(probes))
    attr, found = attr.numpy(), found.numpy()
    for d in range(D):
        table = {int(k): int(a) for k, a, v in zip(
            dim_keys[d], dim_attr[d], dim_valid[d]) if v}
        want = [table.get(int(p)) for p in probes[d]]
        np.testing.assert_array_equal(found[d],
                                      [w is not None for w in want])
        np.testing.assert_array_equal(attr[d][found[d]],
                                      [w for w in want if w is not None])
    assert not found[sentinel].any()
    assert found.any() and not found[~sentinel].all()
    assert found[probes >= 2**32].any()


# -- ops/aggregate -----------------------------------------------------------

def _padded_sorted(rng, n_valid, cap, key_space=20):
    keys = np.sort(rng.integers(0, key_space, n_valid)).astype(np.uint32)
    vals = rng.integers(1, 100, n_valid).astype(np.int32)
    pk = np.full(cap, U32_MAX, np.uint32)
    pv = np.zeros(cap, np.int32)
    pk[:n_valid] = keys
    pv[:n_valid] = vals
    return pk, pv, np.arange(cap) < n_valid


def _same_reduction(pk, pv, valid, max_unique, op):
    """The port's result equals JAX's, bit for bit, on one shard."""
    juniq, jagg_, jn = jagg.segment_reduce_by_key(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(valid), max_unique,
        op=op)
    tuniq, tagg_, tn = tagg.segment_reduce_by_key(
        _bits(pk), torch.from_numpy(pv), torch.from_numpy(valid),
        max_unique, op=op)
    np.testing.assert_array_equal(_u32(tuniq), np.asarray(juniq))
    np.testing.assert_array_equal(tagg_.numpy(), np.asarray(jagg_))
    assert tagg_.dtype == getattr(torch, str(np.asarray(jagg_).dtype))
    assert int(tn) == int(jn)
    return tuniq, tagg_, int(tn)


@pytest.mark.parametrize("op", ["sum", "max", "min", "count"])
def test_reduce_by_key_matches_jax(op):
    rng = np.random.default_rng(0)
    pk, pv, valid = _padded_sorted(rng, 150, 256)
    _, agg, n = _same_reduction(pk, pv, valid, 64, op)
    keys, vals = pk[:150], pv[:150]
    np_op = {"sum": np.sum, "max": np.max, "min": np.min,
             "count": np.size}[op]
    want = [int(np_op(vals[keys == k])) for k in np.unique(keys)]
    assert agg.numpy()[:n].tolist() == want
    # float values: the ±inf identities on the padding slots
    fv = pv.astype(np.float32) / 4
    _same_reduction(pk, fv, valid, 64, op)


def test_count_by_key_matches_jax():
    rng = np.random.default_rng(1)
    pk, _, valid = _padded_sorted(rng, 90, 128, key_space=7)
    juniq, jcnt, jn = jagg.count_by_key(jnp.asarray(pk), jnp.asarray(valid),
                                        16)
    tuniq, tcnt, tn = tagg.count_by_key(_bits(pk), torch.from_numpy(valid),
                                        16)
    np.testing.assert_array_equal(_u32(tuniq), np.asarray(juniq))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert int(tn) == int(jn)


def test_all_padding_matches_jax():
    pk = np.full(32, U32_MAX, np.uint32)
    valid = np.zeros(32, bool)
    for op in ("sum", "max", "min", "count"):
        _, agg, n = _same_reduction(pk, np.zeros(32, np.int32), valid, 8, op)
        assert n == 0
    assert int(agg.sum()) == 0


def test_single_key_matches_jax():
    pk = np.full(16, 5, np.uint32)
    uniq, agg, n = _same_reduction(pk, np.ones(16, np.int32),
                                   np.ones(16, bool), 4, "sum")
    assert n == 1 and int(_u32(uniq)[0]) == 5 and int(agg[0]) == 16


def test_exact_capacity_last_key_survives():
    """n_unique == max_unique exactly: the last unique key is not
    clobbered by the non-first rows' writes."""
    pk = np.array([1, 2, 2, 3, 7, 7, 7], dtype=np.uint32)
    uniq, agg, n = _same_reduction(pk, np.ones(7, np.int32),
                                   np.ones(7, bool), 4, "sum")
    assert n == 4
    assert _u32(uniq).tolist() == [1, 2, 3, 7]
    assert agg.tolist() == [1, 2, 1, 3]


def test_truncation_signal_and_batched_shards():
    """More distinct keys than slots: ``n_unique`` says so and the excess
    collapses into the last slot, as in JAX; a batch of shards equals
    each shard alone."""
    rng = np.random.default_rng(2)
    pk, pv, valid = _padded_sorted(rng, 120, 160, key_space=50)
    for op in ("sum", "max", "min", "count"):
        _, _, n = _same_reduction(pk, pv, valid, 8, op)
        assert n > 8
    shards = [_padded_sorted(rng, k, 96) for k in (0, 5, 96, 40)]
    bk, bv, bval = (np.stack(x) for x in zip(*shards))
    for op in ("sum", "max", "min", "count"):
        uniq, agg, n = tagg.segment_reduce_by_key(
            _bits(bk), torch.from_numpy(bv), torch.from_numpy(bval), 16, op)
        for d, (pk, pv, valid) in enumerate(shards):
            one = tagg.segment_reduce_by_key(
                _bits(pk), torch.from_numpy(pv), torch.from_numpy(valid), 16,
                op)
            np.testing.assert_array_equal(uniq[d].numpy(), one[0].numpy())
            np.testing.assert_array_equal(agg[d].numpy(), one[1].numpy())
            assert int(n[d]) == int(one[2])
    with pytest.raises(ValueError, match="unknown op"):
        tagg.segment_reduce_by_key(_bits(pk), torch.from_numpy(pv),
                                   torch.from_numpy(valid), 8, "avg")


# -- make_shuffle_exchange ---------------------------------------------------

def _traffic(kind: str, cap: int, seed: int):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2**32, (D * cap, 3), dtype=np.uint32)
    if kind == "balanced":
        dest = np.tile(np.arange(D, dtype=np.int32), D * cap // D)
    elif kind == "skewed":
        dest = np.where(rng.random(D * cap) < 0.6, 3,
                        rng.integers(0, D, D * cap)).astype(np.int32)
    else:  # empty senders: shards 2 and 5 send nothing (dest -1)
        dest = rng.integers(0, D, D * cap).astype(np.int32)
        per = dest.reshape(D, cap)
        per[[2, 5]] = -1
    return data, dest


_JAX = {}


def _jax_exchange(mesh, kind, cap, out_factor, impl):
    key = (kind, cap, out_factor, impl)
    if key not in _JAX:
        data, dest = _traffic(kind, cap, 3)
        sh = NamedSharding(mesh, P("shuffle"))
        out = jmake(mesh, "shuffle", impl=impl, out_factor=out_factor)(
            jax.device_put(data, sh), jax.device_put(dest, sh))
        _JAX[key] = tuple(np.asarray(a) for a in out)
    return _JAX[key]


@pytest.mark.parametrize("kind", ["balanced", "skewed", "empty"])
@pytest.mark.parametrize("out_factor", [1, 2])
@pytest.mark.parametrize("port_impl,jax_impl", [("ring", "dense"),
                                                ("dense", "dense"),
                                                ("gather", "gather")])
def test_make_shuffle_exchange_matches_jax(mesh, vmesh, kind, out_factor,
                                           port_impl, jax_impl):
    cap = 64
    data, dest = _traffic(kind, cap, 3)
    exchange = make_shuffle_exchange(vmesh, port_impl, out_factor)
    assert make_shuffle_exchange(vmesh, port_impl, out_factor) is exchange
    received, counts, offsets, overflowed = exchange(
        rows_from_numpy(data, vmesh),
        torch.from_numpy(dest).reshape(D, cap))
    j_recv, j_counts, j_offsets, j_over = _jax_exchange(
        mesh, kind, cap, out_factor, jax_impl)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    np.testing.assert_array_equal(offsets.numpy(), j_offsets)
    np.testing.assert_array_equal(overflowed.numpy(), j_over)
    assert received.shape == (D, cap * out_factor, 3)
    np.testing.assert_array_equal(rows_to_numpy(received), j_recv)
    if kind == "balanced":
        assert not j_over.any()
    elif kind == "skewed":
        assert j_over[3]   # the hot receiver


def test_make_shuffle_exchange_memoized_per_mesh():
    a, b = VirtualMesh(D, "cpu"), VirtualMesh(D, "cpu")
    assert a == b and hash(a) == hash(b)
    assert make_shuffle_exchange(a, "gather", 2) is make_shuffle_exchange(
        b, "gather", 2)
    assert make_shuffle_exchange(a, "gather", 2) is not make_shuffle_exchange(
        a, "gather", 1)
