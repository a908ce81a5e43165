"""Parity of the port's chunked exchange (``sparkrdma_tpu_torch.parallel.
exchange.chunked_exchange`` and its round builders) with the JAX
package's on the same numpy input: received rows and round counts compare
exactly. The port runs on a CPU ``VirtualMesh`` (its ring transport takes
the kernel's plain version there); the JAX side runs on the conftest's
8-device CPU mesh, its ring as the Pallas kernel in interpret mode."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.parallel import exchange as jx
from sparkrdma_tpu_torch.parallel import exchange as tx
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

D = 8
PORT_IMPLS = ("ring", "dense", "gather", "native")


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


@pytest.fixture(scope="module")
def vmesh():
    return VirtualMesh(D, "cpu")


def _grouped(rng, counts, width):
    """Destination-grouped rows ``u32[D*cap, width]`` for ``counts[s, d]``
    (column 0 = destination, the rest random), padded to one capacity."""
    cap = max(1, int(counts.sum(axis=1).max()))
    rows = np.zeros((D, cap, width), np.uint32)
    for s in range(D):
        dest = np.repeat(np.arange(D), counts[s])
        rows[s, :len(dest), 0] = dest
        rows[s, :len(dest), 1:] = rng.integers(0, 2**32, (len(dest), width - 1),
                                               dtype=np.uint32)
    return rows.reshape(D * cap, width)


def _extreme_skew(rng):
    """Every shard sends all its rows to shard 0."""
    counts = np.zeros((D, D), np.int32)
    counts[:, 0] = 64
    return counts, 16, 1


def _mixed(rng):
    counts = np.stack([np.bincount(rng.integers(0, D, 50), minlength=D)
                       for _ in range(D)]).astype(np.int32)
    return counts, 7, 2


def _non_pow2_quota(rng):
    """Pair counts up to 30 with quota 12: bucketed to 16 that is 2 rounds,
    unbucketed it would be 3."""
    counts = rng.integers(0, 31, (D, D)).astype(np.int32)
    counts[2, 5] = 30
    return counts, 12, 3


def _empty_pairs(rng):
    """Sparse traffic: most pairs empty, one shard sends nothing and one
    receives nothing."""
    counts = rng.integers(0, 20, (D, D)).astype(np.int32)
    counts[rng.random((D, D)) < 0.6] = 0
    counts[3, :] = 0
    counts[:, 6] = 0
    counts[0, 1] = 19
    return counts, 4, 2


def _all_empty(rng):
    return np.zeros((D, D), np.int32), 8, 2


CASES = {"extreme_skew": _extreme_skew, "mixed": _mixed,
         "non_pow2_quota": _non_pow2_quota, "empty_pairs": _empty_pairs,
         "all_empty": _all_empty}


def _case(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    counts, quota, width = CASES[name](rng)
    return _grouped(rng, counts, width), counts, quota


_JAX_CACHE = {}


def _jax_chunked(mesh, name, impl):
    key = (name, impl)
    if key not in _JAX_CACHE:
        rows, counts, quota = _case(name)
        _JAX_CACHE[key] = jx.chunked_exchange(mesh, "shuffle", rows, counts,
                                              quota=quota, impl=impl)
    return _JAX_CACHE[key]


def _assert_same(got, want):
    got_rows, got_rounds = got
    want_rows, want_rounds = want
    assert got_rounds == want_rounds
    assert len(got_rows) == len(want_rows) == D
    for d in range(D):
        assert got_rows[d].dtype == want_rows[d].dtype
        np.testing.assert_array_equal(got_rows[d], want_rows[d],
                                      err_msg=f"shard {d}")


@pytest.mark.parametrize("port_impl", PORT_IMPLS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_exchange_matches_jax_gather(mesh, vmesh, case, port_impl):
    rows, counts, quota = _case(case)
    got = tx.chunked_exchange(vmesh, rows, counts, quota=quota,
                              impl=port_impl)
    _assert_same(got, _jax_chunked(mesh, case, "gather"))


@pytest.mark.parametrize("case", ["extreme_skew", "mixed", "empty_pairs"])
def test_chunked_exchange_ring_matches_jax_ring_interpret(mesh, vmesh, case):
    rows, counts, quota = _case(case)
    got = tx.chunked_exchange(vmesh, rows, counts, quota=quota, impl="ring")
    _assert_same(got, _jax_chunked(mesh, case, "ring_interpret"))


def test_chunked_exchange_round_counts_and_contract(vmesh):
    """The skew case of the JAX package's own test: 4 rounds of 16, every
    row lands once on shard 0; the non-pow2 quota rounds up to 16."""
    rows, counts, quota = _case("extreme_skew")
    received, rounds = tx.chunked_exchange(vmesh, rows, counts, quota=quota)
    assert rounds == 4
    assert len(received[0]) == D * 64
    assert all(len(received[d]) == 0 for d in range(1, D))
    np.testing.assert_array_equal(np.sort(received[0][:, 0]),
                                  np.zeros(D * 64, np.uint32))
    rows, counts, quota = _case("non_pow2_quota")
    assert tx.chunked_exchange(vmesh, rows, counts, quota=quota)[1] == 2
    for q, want in ((1, 1), (7, 8), (8, 8), (13, 16), (16, 16), (0, 1)):
        assert tx.bucket_quota(q) == jx.bucket_quota(q) == want


@pytest.mark.parametrize("port_impl,jax_impl",
                         [("ring", "ring_interpret"), ("gather", "gather")])
def test_round_fn_matches_jax_round_by_round(mesh, vmesh, port_impl,
                                             jax_impl):
    rows, counts, quota = _case("mixed")
    spec = NamedSharding(mesh, P("shuffle"))
    jround = jx.make_chunked_exchange(mesh, "shuffle", quota, impl=jax_impl)
    tround = tx.make_chunked_exchange(vmesh, quota, impl=port_impl)
    grouped_j = jax.device_put(rows, spec)
    counts_j = jax.device_put(counts.reshape(-1), spec)
    grouped_t = rows_from_numpy(rows, vmesh)
    counts_t = torch.from_numpy(counts)
    q = tx.bucket_quota(quota)
    rounds = -(-int(counts.max()) // q)
    assert rounds >= 2
    for r in range(rounds):
        want_rows, want_counts = (np.asarray(a) for a in
                                  jround(grouped_j, counts_j, r))
        got_rows, got_counts = tround(grouped_t, counts_t, r)
        assert got_rows.shape == (D, D * q, rows.shape[1])
        np.testing.assert_array_equal(
            got_rows.numpy().view(np.uint32).reshape(want_rows.shape),
            want_rows, err_msg=f"round {r}")
        np.testing.assert_array_equal(got_counts.numpy(), want_counts,
                                      err_msg=f"round {r}")


@pytest.mark.parametrize("port_impl,jax_impl",
                         [("ring", "ring_interpret"), ("gather", "gather")])
def test_round_acc_matches_jax_round_by_round(mesh, vmesh, port_impl,
                                              jax_impl):
    """``make_chunked_exchange_acc``: the accumulator after every round
    equals the JAX one, pad slots dropped (left zero)."""
    rows, counts, quota = _case("empty_pairs")
    spec = NamedSharding(mesh, P("shuffle"))
    jround = jx.make_chunked_exchange_acc(mesh, "shuffle", quota,
                                          impl=jax_impl)
    tround = tx.make_chunked_exchange_acc(vmesh, quota, impl=port_impl)
    cap_out = int(counts.sum(axis=0).max())
    width = rows.shape[1]
    grouped_j = jax.device_put(rows, spec)
    counts_j = jax.device_put(counts.reshape(-1), spec)
    acc_j = jax.device_put(np.zeros((D * cap_out, width), np.uint32), spec)
    grouped_t = rows_from_numpy(rows, vmesh)
    counts_t = torch.from_numpy(counts)
    acc_t = torch.zeros((D, cap_out, width), dtype=torch.int32)
    rounds = -(-int(counts.max()) // tx.bucket_quota(quota))
    assert rounds >= 2
    for r in range(rounds):
        acc_j = jround(grouped_j, counts_j, r, acc_j)
        acc_t = tround(grouped_t, counts_t, r, acc_t)
        np.testing.assert_array_equal(
            acc_t.numpy().view(np.uint32).reshape(D * cap_out, width),
            np.asarray(acc_j), err_msg=f"round {r}")


def test_spread_index():
    """Valid entries keep their place in their shard's region; invalid
    ones spread over it by position."""
    valid = torch.tensor([[True, False, False, True, False],
                          [False, False, True, True, True]])
    index = torch.tensor([[2, 9, 9, 0, 9], [9, 9, 1, 2, 0]],
                         dtype=torch.int32)
    got = tx.spread_index(valid, index, 3)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), [[2, 1, 2, 0, 1], [3, 4, 4, 5, 3]])


def test_resident_accumulator_matches_host_result(vmesh):
    """``chunked_exchange_resident`` leaves the same rows on the device that
    ``chunked_exchange`` brings back, every receiver's back to back in one
    accumulator of exactly the rows moved."""
    rows, counts, quota = _case("empty_pairs")
    received, rounds = tx.chunked_exchange_resident(
        vmesh, rows_from_numpy(rows, vmesh), counts, quota)
    host, rounds_host = tx.chunked_exchange(vmesh, rows, counts, quota)
    assert rounds == rounds_host
    assert [r.shape[0] for r in received] == counts.sum(axis=0).tolist()
    storage = received[0].untyped_storage()
    assert storage.nbytes() == counts.sum() * rows.shape[1] * 4
    for d in range(D):
        assert received[d].untyped_storage().data_ptr() == storage.data_ptr()
        np.testing.assert_array_equal(received[d].numpy().view(np.uint32),
                                      host[d])


def test_chunked_exchange_records_one_exchange(vmesh):
    rows, counts, quota = _case("mixed")
    before = dict(tx.DATA_PLANE)
    tx.chunked_exchange(vmesh, rows, counts, quota=quota)
    assert tx.DATA_PLANE["exchanges"] == before["exchanges"] + 1
    assert tx.DATA_PLANE["rows"] == before["rows"] + int(counts.sum())
