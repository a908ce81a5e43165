"""The port's ``native`` transport (``lax.ragged_all_to_all`` in the JAX
package; the ragged all-to-all kernel of ``sparkrdma_tpu_torch.ops.
ragged_exchange`` on the card, its plain version here) against the JAX
package's exchanges on the same numpy input, shard for shard. The JAX
``native`` does not lower on XLA:CPU, so the port's is held to JAX
``gather`` (and to ``dense`` and the Pallas ring in interpret mode where
no pair exceeds its slot) under ``shard_map`` on the conftest's 8-device
CPU mesh. The kernel itself is checked on the card
(``test_torch_cuda.py`` and ``chip_smoke.py``)."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sparkrdma_tpu.models import terasort as jt
from sparkrdma_tpu.parallel import exchange as jx
from sparkrdma_tpu.utils.compat import shard_map
from sparkrdma_tpu_torch.models import terasort as tt
from sparkrdma_tpu_torch.ops import ragged_exchange as rex
from sparkrdma_tpu_torch.parallel import exchange as tx
from sparkrdma_tpu_torch.parallel.mesh import GlobalMesh, VirtualMesh
from sparkrdma_tpu_torch.utils.u32 import rows_from_numpy

D = 8


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:D]), ("shuffle",))


def _shard(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P("shuffle")))


def _jax_ragged(mesh, data, counts, output, impl):
    """JAX ``ragged_exchange_shard`` on every shard; ``data [D*cap, ...]``,
    ``counts [D, D]``, ``output [D*out_cap, ...]`` the receive buffers."""
    spec = P("shuffle")

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec,) * 3,
                       out_specs=(spec,) * 4, check_vma=False)
    def run(x, c, out):
        r, rc, ro, of = jx.ragged_exchange_shard(x, c[0], "shuffle",
                                                 output=out, impl=impl)
        return r, rc[None], ro[None], of[None]

    got = jax.block_until_ready(run(_shard(mesh, data), _shard(mesh, counts),
                                    _shard(mesh, output)))
    return [np.asarray(a) for a in got]


def _torch_native(data, counts, output):
    x = torch.from_numpy(data.reshape((D, -1) + data.shape[1:]))
    out = torch.from_numpy(output.reshape((D, -1) + output.shape[1:]).copy())
    got = tx.ragged_exchange_shard(x, torch.from_numpy(counts), output=out,
                                   impl="native")
    assert got[0].data_ptr() == out.data_ptr()
    r, rc, ro, of = (t.numpy() for t in got)
    return [r.reshape((-1,) + r.shape[2:]), rc, ro, of]


def _assert_same(got, want):
    names = ("received", "recv_counts", "recv_offsets", "overflowed")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _counts(rng, cap, kind):
    """int32[D, D] with each row summing to at most ``cap``."""
    counts = np.stack([rng.multinomial(rng.integers(cap // 2, cap + 1),
                                       np.full(D, 1.0 / D))
                       for _ in range(D)]).astype(np.int32)
    if kind == "zero_row_col":
        counts[2] = 0
        counts[:, 5] = 0
    return counts


@pytest.mark.parametrize("kind", ["random", "zero_row_col"])
@pytest.mark.parametrize("w", [1, 3, 25])
def test_native_matches_jax_gather_over_a_filler(mesh, w, kind):
    """Rows of a filler ``output`` past each receiver's total survive, as
    they do under JAX ``gather``; a zero row and a zero column of the
    counts move nothing."""
    rng = np.random.default_rng(w * 10 + len(kind))
    cap = 24
    counts = _counts(rng, cap, kind)
    data = rng.integers(-2**31, 2**31, (D * cap, w)).astype(np.int32)
    filler = rng.integers(-2**31, 2**31, (D * 2 * cap, w)).astype(np.int32)
    want = _jax_ragged(mesh, data, counts, filler, "gather")
    got = _torch_native(data, counts, filler)
    _assert_same(got, want)
    totals = counts.sum(axis=0)
    per = got[0].reshape(D, 2 * cap, w)
    for j in range(D):
        np.testing.assert_array_equal(
            per[j, totals[j]:], filler.reshape(D, 2 * cap, w)[j, totals[j]:])
    if kind == "zero_row_col":
        assert (got[1][5] == 0).all() and (got[1][:, 2] == 0).all()


@pytest.mark.parametrize("jax_impl", ["dense", "ring_interpret"])
def test_native_matches_jax_slot_transports_when_slots_fit(mesh, jax_impl):
    """Where no pair exceeds its slot (``out_cap // D`` rows), the slot
    transports give the same bytes as ``native``."""
    rng = np.random.default_rng(3)
    cap, w = 32, 3
    counts = _counts(rng, cap, "random")
    out_cap = D * int(counts.max())
    data = rng.integers(-2**31, 2**31, (D * cap, w)).astype(np.int32)
    zeros = np.zeros((D * out_cap, w), np.int32)
    want = _jax_ragged(mesh, data, counts, zeros, jax_impl)
    assert not want[3].any()
    _assert_same(_torch_native(data, counts, zeros), want)


def test_native_step_matches_jax_terasort_on_gather(mesh):
    """``make_terasort_step(impl="native")`` equals JAX's step on
    ``gather``: sorted rows, counts and overflow flags."""
    cfg = jt.TeraSortConfig(rows_per_device=256, payload_words=2,
                            out_factor=2)
    rows = jt.generate_rows(cfg, D, seed=8)
    rows[::7, 0] = 2**32 - 1
    want = jt.make_terasort_step(mesh, "shuffle", cfg, impl="gather")(
        _shard(mesh, rows))
    vmesh = VirtualMesh(D, "cpu")
    got = tt.make_terasort_step(vmesh, tt.TeraSortConfig(256, 2, 2),
                                impl="native")(rows_from_numpy(rows, vmesh))
    for g, w in zip(got, want):
        g = g.numpy()
        w = np.asarray(w)
        if g.dtype == np.int32 and w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g.reshape(w.shape), w)


def test_native_chunked_rounds_match_jax_gather(mesh):
    """``make_chunked_exchange(impl="native")`` round by round against
    JAX's on ``gather``: under ``native`` a round packs its slot blocks
    by destination and makes one ragged exchange, as in the JAX
    package."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 30, (D, D)).astype(np.int32)
    counts[1, 6] = 29
    quota, width = 12, 2
    cap = int(counts.sum(axis=1).max())
    rows = np.zeros((D, cap, width), np.uint32)
    for s in range(D):
        dest = np.repeat(np.arange(D), counts[s])
        rows[s, :len(dest), 0] = dest
        rows[s, :len(dest), 1] = rng.integers(0, 2**32, len(dest),
                                              dtype=np.uint32)
    rows = rows.reshape(D * cap, width)
    vmesh = VirtualMesh(D, "cpu")
    spec = NamedSharding(mesh, P("shuffle"))
    jround = jx.make_chunked_exchange(mesh, "shuffle", quota, impl="gather")
    tround = tx.make_chunked_exchange(vmesh, quota, impl="native")
    grouped_j = jax.device_put(rows, spec)
    counts_j = jax.device_put(counts.reshape(-1), spec)
    grouped_t = rows_from_numpy(rows, vmesh)
    rounds = -(-int(counts.max()) // tx.bucket_quota(quota))
    assert rounds == 2
    for r in range(rounds):
        want_rows, want_counts = (np.asarray(a) for a in
                                  jround(grouped_j, counts_j, r))
        got_rows, got_counts = tround(grouped_t, torch.from_numpy(counts), r)
        np.testing.assert_array_equal(
            got_rows.numpy().view(np.uint32).reshape(want_rows.shape),
            want_rows, err_msg=f"round {r}")
        np.testing.assert_array_equal(got_counts.numpy(), want_counts)


def test_plain_version_writes_into_output_and_counts_nothing():
    """The CPU wrapper is the plain version: it writes the caller's
    ``output`` in place, returns that very tensor, and counts no launch."""
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.integers(-2**31, 2**31, (4, 10, 3))
                            .astype(np.int32))
    mat = torch.tensor([[3, 0, 2, 5], [0, 0, 0, 0], [1, 1, 1, 1],
                        [10, 0, 0, 0]], dtype=torch.int32)
    out = torch.full((4, 12, 3), -1, dtype=torch.int32)
    before = rex.LAUNCHES
    got = rex.ragged_all_to_all(data, mat, out)
    assert got is out and rex.LAUNCHES == before
    # receiver 0: 3 rows of source 0, 1 of source 2, 10 of source 3 (cut
    # at 12 rows)
    want0 = torch.cat([data[0, :3], data[2, :1], data[3, :8]])
    assert torch.equal(out[0], want0)
    assert torch.equal(out[1], torch.cat([data[2, 1:2],
                                          torch.full((11, 3), -1)]))
    assert torch.equal(out[3, :6], torch.cat([data[0, 5:10], data[2, 3:4]]))
    assert (out[3, 6:] == -1).all()
    assert got.data_ptr() == rex.ragged_all_to_all_plain(
        data, mat, out).data_ptr()


def test_wrapper_refuses_other_devices():
    meta = torch.empty((2, 3, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rex.ragged_all_to_all(meta, torch.zeros((2, 2), dtype=torch.int32,
                                                device="meta"), meta)


def test_auto_resolves_as_the_jax_package_on_its_chip():
    """``auto`` is ``native`` on a card and ``gather`` on the CPU, over a
    ``GlobalMesh`` on a card too (its range launch into the peers'
    arenas); ``ring`` passes through ``resolve_transport`` as an explicit
    ask."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tx.resolve_impl(cuda, "auto") == "native"
    assert tx.resolve_impl(cpu, "auto") == "gather"
    assert tx.resolve_impl(VirtualMesh(D, "cpu"), "native") == "native"
    card = GlobalMesh(2, D // 2, 0, cuda, group=None, data_group=None)
    assert tx.resolve_impl(card, "auto") == "native"
    assert tx.resolve_transport(card, "auto") == "native"
    assert tx.resolve_transport(card, "ring") == "ring"
    assert tx.resolve_transport(cuda, "auto") == "native"


def test_native_emits_one_transport_span_and_no_slot_spans():
    """The whole copy is one ``exchange.transport`` span: no slot fill and
    no pack, whatever ``slot_rows`` says (the default receive buffer's
    zero fill is its own ``exchange.receive_fill``, for every transport)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 2**31, (D, 16, 2))
                            .astype(np.int32))
    counts = torch.from_numpy(_counts(rng, 16, "random"))
    spans = {}
    for impl in ("native", "ring"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tx.ragged_exchange_shard(data, counts, impl=impl, slot_rows=1)
        spans[impl] = {e.key for e in prof.key_averages()
                       if e.key.startswith("exchange.")}
    assert spans["native"] == {"exchange.receive_fill",
                               "exchange.transport"}
    assert spans["ring"] == {"exchange.receive_fill", "exchange.slot_fill",
                             "exchange.transport", "exchange.pack"}
