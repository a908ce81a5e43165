"""Parity of the port's ragged exchange (``sparkrdma_tpu_torch.parallel.
exchange``) with the JAX package's, shard for shard, on the same numpy
input: received rows (padding included), counts, offsets and overflow
flags compare exactly, for the ring, dense, gather and native transports.
The JAX ring runs its Pallas kernel in interpret mode on the 8-device CPU
mesh; the JAX ``native`` does not lower on XLA:CPU, so the port's is held
to JAX ``gather``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.parallel import exchange as jx
from sparkrdma_tpu.utils.compat import shard_map
from sparkrdma_tpu_torch.parallel import exchange as tx

D = 8
IMPLS = [("ring", "ring_interpret"), ("dense", "dense"), ("gather", "gather"),
         ("native", "gather")]


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


def _shard(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P("shuffle")))


def _jax_ragged(mesh, data, counts, out_cap, impl):
    """JAX ``ragged_exchange_shard`` on every shard; ``data [D*cap, ...]``,
    ``counts [D, D]``."""
    spec = P("shuffle")

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec,) * 4, check_vma=False)
    def run(x, c):
        out = jnp.zeros((out_cap,) + x.shape[1:], x.dtype)
        r, rc, ro, of = jx.ragged_exchange_shard(x, c[0], "shuffle",
                                                 output=out, impl=impl)
        return r, rc[None], ro[None], of[None]

    got = jax.block_until_ready(run(_shard(mesh, data), _shard(mesh, counts)))
    return [np.asarray(a) for a in got]


def _torch_ragged(data, counts, out_cap, impl):
    x = torch.from_numpy(data.reshape((D, -1) + data.shape[1:]))
    out = torch.zeros((D, out_cap) + x.shape[2:], dtype=x.dtype)
    got = tx.ragged_exchange_shard(x, torch.from_numpy(counts), output=out,
                                   impl=impl)
    r, rc, ro, of = (t.numpy() for t in got)
    return [r.reshape((-1,) + r.shape[2:]), rc, ro, of]


def _assert_same(got, want):
    names = ("received", "recv_counts", "recv_offsets", "overflowed")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _random_counts(rng, cap, skew_to=None):
    counts = np.zeros((D, D), np.int32)
    for d in range(D):
        p = np.full(D, 1.0 / D)
        if skew_to is not None:
            p = np.full(D, 0.1 / (D - 1))
            p[skew_to] = 0.9
        counts[d] = rng.multinomial(rng.integers(0, cap + 1), p)
    return counts


CASES = {
    # name: (capacity, out_factor, counts builder)
    "balanced": (32, 1, lambda rng, cap: np.full((D, D), cap // D, np.int32)),
    "ragged": (32, 4, lambda rng, cap: _random_counts(rng, cap)),
    "skewed": (32, 8, lambda rng, cap: _random_counts(rng, cap, skew_to=3)),
    "empty": (16, 1, lambda rng, cap: np.zeros((D, D), np.int32)),
    "one_sender": (16, 1, lambda rng, cap: np.vstack(
        [np.full((1, D), cap // D, np.int32), np.zeros((D - 1, D), np.int32)])),
    # pair skew past the slot: flag set, counts true, rows truncated alike
    "pair_overflow": (16, 2, lambda rng, cap: np.tile(
        np.eye(D, dtype=np.int32)[5] * cap, (D, 1))),
    # out_cap < D: no slot can carry a row, so slot transports use gather
    "out_cap_below_d": (4, 1, lambda rng, cap: _random_counts(rng, cap)),
}


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_exchange_matches_jax(mesh, case, port_impl, jax_impl):
    cap, out_factor, make_counts = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    counts = make_counts(rng, cap).astype(np.int32)
    data = rng.integers(-2**31, 2**31, size=(D * cap, 3),
                        dtype=np.int64).astype(np.int32)
    out_cap = cap * out_factor
    want = _jax_ragged(mesh, data, counts, out_cap, jax_impl)
    got = _torch_ragged(data, counts, out_cap, port_impl)
    _assert_same(got, want)
    if case == "pair_overflow":
        # only the flooded receiver flags; the slot transports also trip
        # on the pair slot, gather on the receive capacity
        np.testing.assert_array_equal(got[3], np.arange(D) == 5)
        np.testing.assert_array_equal(got[1][5], np.full(D, cap))


def _jax_shuffle(mesh, data, dest, out_factor, impl):
    ex = jx.make_shuffle_exchange(mesh, "shuffle", impl=impl,
                                  out_factor=out_factor)
    got = jax.block_until_ready(ex(_shard(mesh, data), _shard(mesh, dest)))
    return [np.asarray(a) for a in got]


def _torch_shuffle(data, dest, out_factor, impl):
    x = torch.from_numpy(data.reshape((D, -1) + data.shape[1:]))
    out = torch.zeros((D, x.shape[1] * out_factor) + x.shape[2:],
                      dtype=x.dtype)
    got = tx.shuffle_shard(x, torch.from_numpy(dest.reshape(D, -1)),
                           output=out, impl=impl)
    r, rc, ro, of = (t.numpy() for t in got)
    return [r.reshape((-1,) + r.shape[2:]), rc, ro, of]


def _dest_flood(rng, cap):
    return np.full(D * cap, 5, np.int32)


def _dest_padding(rng, cap):
    dest = np.full(D * cap, -1, np.int32)
    dest[:cap] = np.repeat(np.arange(D, dtype=np.int32), cap // D)
    dest[cap:cap + 3] = D + 4            # past the last shard: padding too
    return dest


SHUFFLES = {
    "random": (32, 4, lambda rng, cap: rng.integers(
        0, D, size=D * cap).astype(np.int32)),
    "skew_90pct": (32, 8, lambda rng, cap: np.where(
        rng.random(D * cap) < 0.9, 3,
        rng.integers(0, D, size=D * cap)).astype(np.int32)),
    "padding": (16, 1, _dest_padding),
    "flood_shard_5": (32, 2, _dest_flood),
}


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
@pytest.mark.parametrize("case", sorted(SHUFFLES))
def test_shuffle_shard_matches_jax(mesh, case, port_impl, jax_impl):
    cap, out_factor, make_dest = SHUFFLES[case]
    rng = np.random.default_rng(100 + sorted(SHUFFLES).index(case))
    dest = make_dest(rng, cap)
    data = rng.integers(0, 2**31, size=(D * cap, 2),
                        dtype=np.int64).astype(np.int32)
    want = _jax_shuffle(mesh, data, dest, out_factor, jax_impl)
    got = _torch_shuffle(data, dest, out_factor, port_impl)
    _assert_same(got, want)
    if case == "flood_shard_5":
        # everyone floods shard 5 past its receive buffer (and, for the
        # slot transports, past each pair slot): flagged, never silent
        assert got[3].any()


def test_group_by_destination_matches_jax():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 2**31, size=(D, 64, 2),
                        dtype=np.int64).astype(np.int32)
    dest = rng.integers(-2, D + 2, size=(D, 64)).astype(np.int32)
    grouped, counts = tx.group_by_destination(
        torch.from_numpy(data), torch.from_numpy(dest), D)
    for d in range(D):
        g, c = jx.group_by_destination(jnp.asarray(data[d]),
                                       jnp.asarray(dest[d]), D)
        np.testing.assert_array_equal(grouped[d].numpy(), np.asarray(g))
        np.testing.assert_array_equal(counts[d].numpy(), np.asarray(c))


def test_resolve_impl():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tx.resolve_impl(cpu) == "gather"
    assert tx.resolve_impl(cuda) == "native"
    assert tx.resolve_transport(cpu, "auto") == "gather"
    for impl in tx.TRANSPORTS:
        assert tx.resolve_impl(cpu, impl) == impl
        assert tx.resolve_transport(cuda, impl) == impl
    # native is the ragged all-to-all kernel on one card, not only a
    # collective across processes
    assert "native" in tx.TRANSPORTS and tx.resolve_impl(cpu, "native") \
        == "native"
    with pytest.raises(ValueError, match="unknown exchange impl"):
        tx.resolve_impl(cpu, "ring_interpret")


def test_record_exchange_tallies():
    before = dict(tx.DATA_PLANE)
    tx.record_exchange(10)
    tx.record_exchange(5)
    assert tx.DATA_PLANE["exchanges"] == before["exchanges"] + 2
    assert tx.DATA_PLANE["rows"] == before["rows"] + 15
